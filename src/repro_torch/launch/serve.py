"""Serving launcher of the port: batched event-driven CSNN inference.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch csnn-paper \
      --requests 8                      # on the GPU (default --device cuda)

  PYTHONPATH=src python -m repro_torch.launch.serve --arch csnn-paper \
      --smoke --requests 8 --device cpu # plain PyTorch path on the CPU

Runs one batch of random image requests (weights from a seed) through
``snn_apply_batched`` under the analytic plan and prints one
``req N: class K`` line per request and a throughput line.  The first
call is timed apart as warmup: on the GPU it includes building the
kernels.  ``--engine`` and ``--stream`` are not ported yet.
"""
import argparse
import statistics
import sys
import time


def serve_csnn(args) -> int:
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.core.csnn import (encode_input, init_params,
                                       snn_apply_batched)
    from repro_torch.core.plan import plan_network

    if args.engine or args.stream:
        raise NotImplementedError(
            "--engine/--stream (the async micro-batching engine and "
            "streaming DVS ingestion) are not ported yet: see ROADMAP.md "
            "Queue 1, 'Serving engine' and 'Streaming ingestion'")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu for the plain path)")
    mod = ARCHS[args.arch]
    cfg = mod.SMOKE if args.smoke else mod.FULL
    params = init_params(cfg, seed=0, device=device)
    h, w = cfg.input_hw
    imgs = torch.rand((args.requests, h, w, cfg.input_channels),
                      generator=torch.Generator().manual_seed(1))
    event_par = (None if args.event_par < 0
                 else args.event_par if args.event_par else 1)
    plan = plan_network(cfg, capacity=args.capacity,
                        channel_block=args.channel_block,
                        batch_tile=args.batch_tile, event_par=event_par)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run():
        spikes = encode_input(imgs.to(device), cfg)
        return snn_apply_batched(params, spikes, cfg, plan,
                                 collect_stats=False)

    t0 = time.perf_counter()
    logits = run()
    sync()
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(max(args.iters, 1)):
        t0 = time.perf_counter()
        run()
        sync()
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    for i, p in enumerate(logits.argmax(dim=-1).tolist()):
        print(f"req {i}: class {p}")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"warmup: {warm_s:.2f} s (first call; excluded from throughput)")
    print(f"throughput: {args.requests / dt:.1f} samples/s (median of "
          f"{len(times)}) (batch={args.requests}, T={cfg.t_steps}, "
          f"capacity={args.capacity}, channel_block={args.channel_block}, "
          f"mode=batched, device={where})")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="csnn-paper",
                    choices=("csnn-paper", "csnn-wide"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=256,
                    help="AEQ depth per queue")
    ap.add_argument("--channel-block", type=int, default=8,
                    help="output channels per MemPot tile")
    ap.add_argument("--event-par", type=int, default=-1,
                    help="interlaced event-parallel width: -1 sizes it per "
                         "layer (default), 0/1 keeps the sequential conv "
                         "unit, >1 pins the width")
    ap.add_argument("--batch-tile", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3,
                    help="steady-state timing iterations")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain path)")
    ap.add_argument("--engine", action="store_true",
                    help="not ported yet (raises)")
    ap.add_argument("--stream", action="store_true",
                    help="not ported yet (raises)")
    return serve_csnn(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
