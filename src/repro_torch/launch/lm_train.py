"""Train a small LM (scaled-down stablelm family) for a few hundred steps
on the synthetic token stream, with checkpoint/restart through the
fault-tolerant loop (the counterpart of ``examples/lm_train.py``).

  PYTHONPATH=src python -m repro_torch.launch.lm_train [--steps 200]
  PYTHONPATH=src python -m repro_torch.launch.lm_train --device cpu

A second run with the same ``--ckpt-dir`` resumes from its newest
checkpoint.  The default directory is ``repro_torch_lm_ckpt`` under the
system's temporary directory.
"""
import argparse
import dataclasses
import os
import sys
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.data.synthetic import ShardedBatcher, TokenStream
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import LoopConfig, run
    from repro_torch.train.optimizer import AdamWConfig

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu)")
    cfg = dataclasses.replace(
        ARCHS["stablelm-3b"].SMOKE, n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=512, vocab=2048)
    model = build_model(cfg)
    print(f"model: {cfg.name} scaled to {model.n_params() / 1e6:.1f}M params")

    data = ShardedBatcher(TokenStream(vocab=cfg.vocab, seed=0), batch_size=8,
                          seq_len=128, device=device)
    state, hist = run(
        model, data,
        LoopConfig(total_steps=args.steps, ckpt_every=100, log_every=20,
                   ckpt_dir=args.ckpt_dir),
        AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                    weight_decay=0.01),
        torch.Generator().manual_seed(0), device=device)
    for h in hist:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  ({h['sec']:.2f}s)")
    print(f"final step: {int(state.step)}; checkpoints in {args.ckpt_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
