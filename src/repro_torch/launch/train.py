"""Training launcher (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
      --mesh smoke --smoke --steps 50                   # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

``--mesh smoke`` runs the loop on one device (``--device``, default
``cuda``).  ``--mesh single|multi`` need the production mesh, which the
port does not have yet: they exit with a message.  Checkpoint/restart
comes from ``repro_torch.train.loop``.  ``--compute-dtype`` is accepted
as JAX's launcher accepts it; there, as here, the loop trains its float32
parameters in float32.
"""
import argparse
import sys


def main(argv=None):
    from repro_torch.configs import LM_ARCHS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b", choices=tuple(LM_ARCHS))
    ap.add_argument("--mesh", choices=["smoke", "single", "multi"], default="smoke")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compute-dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    if args.mesh != "smoke":
        print(f"--mesh {args.mesh} needs the production mesh, which the port "
              f"does not have yet; --mesh smoke trains on one device",
              file=sys.stderr)
        return 2

    import torch

    from repro_torch.data.synthetic import ShardedBatcher, TokenStream
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import LoopConfig, run
    from repro_torch.train.optimizer import AdamWConfig

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu)")
    cfg = LM_ARCHS[args.arch].SMOKE if args.smoke else LM_ARCHS[args.arch].FULL
    model = build_model(cfg)
    print(f"{cfg.name}: {model.n_params() / 1e6:.1f}M params")
    data = ShardedBatcher(TokenStream(vocab=cfg.vocab, seed=0), args.batch,
                          args.seq, device=device)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                       total_steps=args.steps)
    state, hist = run(model, data,
                      LoopConfig(total_steps=args.steps, ckpt_every=50,
                                 log_every=10, ckpt_dir=args.ckpt_dir),
                      ocfg, torch.Generator().manual_seed(0), device=device)
    for h in hist:
        print(f"  step {h['step']:5d}  loss {h['loss']:.4f}  {h['sec']:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
