"""Serve a small LM with batched requests: prefill + the decode loop with
temperature sampling and EOS masking (``repro_torch.serve.engine``, one
device; the counterpart of ``examples/lm_serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.lm_serve
  PYTHONPATH=src python -m repro_torch.launch.lm_serve --device cpu

The weights, prompts and samples come from torch generators seeded 0, 1
and 2 (JAX's example uses keys of the same numbers: other draws).
"""
import argparse
import dataclasses
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine, ServeConfig

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu)")
    cfg = dataclasses.replace(ARCHS["gemma3-1b"].SMOKE, vocab=512)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device)
    print(f"serving {cfg.name}: {model.n_params() / 1e6:.2f}M params, "
          f"sliding window {cfg.sliding_window} @ 1:{cfg.global_every} global")

    engine = Engine(model, params, max_seq=128,
                    cfg=ServeConfig(max_new_tokens=16, temperature=0.8))
    prompts = torch.randint(0, cfg.vocab, (4, 12), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1)).to(device)
    out = engine.generate(prompts, torch.Generator(device=device).manual_seed(2))
    for i, row in enumerate(out.tolist()):
        print(f"  request {i}: prompt={row[:12]} -> generated={row[12:]}")
    print("batched decode OK (4 requests x 16 tokens)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
