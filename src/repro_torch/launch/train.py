"""Training launcher (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --mesh smoke --smoke --steps 50                   # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
      --arch gemma3-1b --mesh single                    # 256 GPUs

``--mesh smoke`` trains on the 1x1 mesh (``launch.mesh.make_smoke_mesh``)
on ``--device`` (default ``cuda``; a world of one, gloo on the CPU);
``--mesh single|multi`` build the 16x16 / 2x16x16 production mesh and
need torchrun with a world of 256 / 512 ranks: any other world exits
non-zero with its size.  The state is placed on the mesh by the
logical-axis rules (``train.loop.run(mesh=...)``: the port has no ``jit``
to place it, so it places it as JAX's dry run and elastic path do) and
the batch comes sharded from ``ShardedBatcher(mesh=...)``.
Checkpoint/restart comes from ``repro_torch.train.loop``.
``--compute-dtype`` is accepted as JAX's launcher accepts it; there, as
here, the loop trains its float32 parameters in float32.
"""
import argparse
import os
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

    need = {"smoke": 1, "single": 256, "multi": 512}[args.mesh]
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != need:
        print(f"--mesh {args.mesh} builds the {need}-rank production mesh "
              f"and needs torchrun with a world of {need}; found a world of "
              f"{world}", file=sys.stderr)
        return 2

    import torch
    import torch.distributed as dist

    from repro_torch.data.synthetic import ShardedBatcher, TokenStream
    from repro_torch.launch.mesh import (init_distributed, make_production_mesh,
                                         make_smoke_mesh)
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.specs import default_rules, set_constraint_mesh
    from repro_torch.train.loop import LoopConfig, run
    from repro_torch.train.optimizer import AdamWConfig

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu)")
    init_distributed(device.type)
    try:
        mesh = (make_smoke_mesh(device.type) if args.mesh == "smoke" else
                make_production_mesh(multi_pod=args.mesh == "multi",
                                     device_type=device.type))
        rules = default_rules(phase="train")
        set_constraint_mesh(mesh, rules)
        cfg = LM_ARCHS[args.arch].SMOKE if args.smoke else LM_ARCHS[args.arch].FULL
        model = build_model(cfg)
        lead = dist.get_rank() == 0
        if lead:
            print(f"{cfg.name}: {model.n_params() / 1e6:.1f}M params")
        data = ShardedBatcher(TokenStream(vocab=cfg.vocab, seed=0), args.batch,
                              args.seq, device=device, mesh=mesh)
        ocfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                           total_steps=args.steps)
        state, hist = run(model, data,
                          LoopConfig(total_steps=args.steps, ckpt_every=50,
                                     log_every=10, ckpt_dir=args.ckpt_dir),
                          ocfg, torch.Generator().manual_seed(0), device=device,
                          mesh=mesh, rules=rules)
    finally:
        set_constraint_mesh(None)
        dist.destroy_process_group()
    for h in hist if lead else ():
        print(f"  step {h['step']:5d}  loss {h['loss']:.4f}  {h['sec']:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
