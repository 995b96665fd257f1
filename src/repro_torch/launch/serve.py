"""Serving launcher of the port: event-driven CSNN inference.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch csnn-paper \
      --requests 8                      # on the GPU (default --device cuda)

  PYTHONPATH=src python -m repro_torch.launch.serve --arch csnn-paper \
      --smoke --requests 8 --device cpu # plain PyTorch path on the CPU

  # the async micro-batching engine (flush statistics line):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch csnn-paper \
      --requests 8 --engine

  # continuous batching: slot-level refill between t_chunk time steps
  # (chunk / refill / slot-utilization line):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch csnn-paper \
      --requests 8 --engine --continuous --t-chunk 1

  # streaming DVS ingestion: requests are raw (t, y, x, polarity) event
  # traces of synthetic moving-edge scenes, admitted into the interlace
  # banks with no frame encode or sort (implies --engine --continuous):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch csnn-paper \
      --requests 8 --stream

  # the measured tuner: time candidate schedules on the device, plan with
  # the winners and cache them (REPRO_TORCH_PLAN_CACHE overrides
  # ~/.cache/repro_torch/plan_cache.json); --tune cached loads them
  PYTHONPATH=src python -m repro_torch.launch.serve --arch csnn-paper \
      --requests 8 --tune measured

Serves random image requests (weights from a seed) under the analytic
plan, or the tuned one with ``--tune``, and prints one ``req N: class K``
line per request and a throughput line.  Without ``--engine`` one batch
goes through ``snn_apply_batched``; with it, the requests are submitted
one by one to ``CSNNEngine``.  The first call (``warmup`` for the
engine) is timed apart: on the GPU it includes building the kernels.
``--verbose`` prints the plan and, for image requests, the per-layer
event counts.

LM serving (the ten registry architectures of ``repro_torch.configs``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --requests 2 --prompt-len 16 --new-tokens 8       # FULL, on the GPU

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --smoke --device cpu --requests 2 --new-tokens 4  # SMOKE, on the CPU

builds the model with weights from a seed (a CPU generator, so the CPU and
the GPU serve the same weights), draws random prompts, runs
``Engine.generate`` (prefill, then greedy decoding, or temperature
sampling with ``--temperature``) and prints one ``req N: [tokens]`` line
per request (the new tokens) and a timing line.
"""
import argparse
import statistics
import sys
import time

# bound on one pass of the request list through the engine: a hung
# future fails the run instead of stalling it
ENGINE_TIMEOUT_S = 600.0


def serve_csnn(args) -> int:
    from dataclasses import replace

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.core.csnn import (encode_input, init_params,
                                       snn_apply_batched)
    from repro_torch.core.plan import plan_network

    # --stream implies --continuous implies --engine
    args.continuous = args.continuous or args.stream
    args.engine = args.engine or args.continuous
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu for the plain path)")
    mod = ARCHS[args.arch]
    cfg = mod.SMOKE if args.smoke else mod.FULL
    if args.stream:  # polarity (OFF/ON) maps onto the 2-channel input path
        cfg = replace(cfg, input_channels=2)
    params = init_params(cfg, seed=0, device=device)
    h, w = cfg.input_hw
    if args.stream:
        from repro_torch.data.dvs import dvs_moving_edges
        reqs, _ = dvs_moving_edges(args.requests, cfg.t_steps, (h, w), seed=1)
        n_events = sum(tr.shape[0] for tr in reqs)
    else:
        imgs = torch.rand((args.requests, h, w, cfg.input_channels),
                          generator=torch.Generator().manual_seed(1))
        reqs = list(imgs)
    event_par = (None if args.event_par < 0
                 else args.event_par if args.event_par else 1)
    # tuning happens here, before any request is admitted: measuring
    # candidates (--tune measured) or loading the plan cache (--tune
    # cached) is warmup work, never request-path work
    tune_config = None
    if args.tune != "analytic":
        from repro_torch.tune import TuneConfig
        tune_config = TuneConfig(device=str(device))
    t0 = time.perf_counter()
    plan = plan_network(cfg, capacity=args.capacity,
                        channel_block=args.channel_block,
                        batch_tile=args.batch_tile, event_par=event_par,
                        ingest=args.stream, tune=args.tune,
                        tune_config=tune_config)
    if args.tune != "analytic":
        print(f"tune: mode={args.tune} plan derived in "
              f"{time.perf_counter() - t0:.2f} s")
    if args.verbose:
        print(plan)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    extra = ""
    if args.engine:
        from repro_torch.serve.csnn_engine import CSNNEngine, CSNNServeConfig
        max_batch = -(-args.requests // args.batch_tile) * args.batch_tile
        engine = CSNNEngine(params, cfg, plan, CSNNServeConfig(
            max_batch=max_batch, max_delay_ms=args.deadline_ms,
            continuous=args.continuous, t_chunk=args.t_chunk,
            stream=args.stream))
        warm_s = engine.warmup()

        def run():
            return engine.run_requests(reqs, timeout=ENGINE_TIMEOUT_S)
    else:
        def run():
            spikes = encode_input(imgs.to(device), cfg)
            return snn_apply_batched(params, spikes, cfg, plan,
                                     collect_stats=False)

        t0 = time.perf_counter()
        run()
        sync()
        warm_s = time.perf_counter() - t0
    times = []
    for _ in range(max(args.iters, 1)):
        t0 = time.perf_counter()
        logits = run()
        sync()
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    if args.continuous:
        st = engine.stats
        extra = (f"engine: chunks={st['chunks']} admitted={st['admitted']} "
                 f"refills={st['refills']} "
                 f"slot_utilization={engine.slot_utilization:.0%} "
                 f"wait_ms_max={st['wait_ms_max']:.1f} "
                 f"deadline_misses={st['deadline_misses']} "
                 + _host_path(st, st["admitted"], st["chunks"]))
        if args.stream:
            extra += (f"\nstream: events={n_events} "
                      f"({n_events / dt:.0f} events/s admitted)")
    elif args.engine:
        st = engine.stats
        extra = (f"engine: batches={st['batches']} "
                 f"full={st['flushes_full']} "
                 f"deadline={st['flushes_deadline']} "
                 f"padded_slots={st['padded_slots']} "
                 + _host_path(st, st["requests"], st["batches"]))
    for i, p in enumerate(logits.argmax(dim=-1).tolist()):
        print(f"req {i}: class {p}")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    mode = ("stream" if args.stream else "continuous" if args.continuous
            else "engine" if args.engine else "batched")
    print(f"warmup: {warm_s:.2f} s (first call; excluded from throughput)")
    print(f"throughput: {args.requests / dt:.1f} samples/s (median of "
          f"{len(times)}) (batch={args.requests}, T={cfg.t_steps}, "
          f"capacity={args.capacity}, channel_block={args.channel_block}, "
          f"mode={mode}, device={where})")
    if extra:
        print(extra)
    if args.verbose and not args.stream:
        _, stats = snn_apply_batched(params, encode_input(imgs.to(device),
                                                          cfg), cfg, plan)
        for lp, st in zip(plan.layers, stats):
            print(f"layer {lp.name}: events={int(st.in_spike_counts.sum())} "
                  f"peak_queue={int(st.in_spike_counts.max())} "
                  f"capacity={lp.capacity} block_e={st.event_block}")
    return 0


def _host_path(stats: dict, requests: int, launches: int) -> str:
    """The engine's mean queue wait per request and host ms per launch
    (batch or chunk), from its counters."""
    wait = stats["queue_wait_ms_sum"] / max(requests, 1)
    launch = stats["launch_ms_sum"] / max(launches, 1)
    return f"queue_wait_ms_mean={wait:.2f} launch_ms_mean={launch:.2f}"


def lm_inputs(cfg, requests: int, prompt_len: int, generator):
    """Random prompt tokens and the family's extra inputs (the VLM's
    vision prefix, the encoder-decoder's frames), drawn on the CPU from
    ``generator``."""
    import torch
    prompts = torch.randint(0, cfg.vocab, (requests, prompt_len),
                            generator=generator, dtype=torch.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["vision_embeds"] = 0.02 * torch.randn(
            (requests, cfg.n_vision_tokens, cfg.d_model), generator=generator)
    if cfg.family == "encdec":
        extra["frames"] = 0.02 * torch.randn(
            (requests, cfg.enc_frames, cfg.d_model), generator=generator)
    return prompts, extra


def serve_lm(args, params=None, prompts=None, extra=None) -> int:
    """The LM branch: ``Engine.generate`` over one batch of requests.
    ``params`` / ``prompts`` / ``extra`` replace the seeded draws (tests
    pass the JAX package's through numpy)."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine, ServeConfig

    device = torch.device(args.device)
    mod = ARCHS[args.arch]
    cfg = mod.SMOKE if args.smoke else mod.FULL
    model = build_model(cfg)
    t0 = time.perf_counter()
    if params is None:
        params = model.init_params(torch.Generator().manual_seed(0), device)
    if prompts is None:
        prompts, extra = lm_inputs(cfg, args.requests, args.prompt_len,
                                   torch.Generator().manual_seed(1))
        prompts = prompts.to(device)
        extra = {k: v.to(device) for k, v in extra.items()}
    max_seq = args.prompt_len + args.new_tokens + 8
    if cfg.family == "vlm":
        max_seq += cfg.n_vision_tokens
    engine = Engine(model, params, max_seq=max_seq,
                    cfg=ServeConfig(max_new_tokens=args.new_tokens,
                                    temperature=args.temperature))
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = engine.generate(prompts, torch.Generator(device=device).manual_seed(3),
                          extra=extra)
    rows = out[:, args.prompt_len:].tolist()
    dt = time.perf_counter() - t0
    for i, row in enumerate(rows):
        print(f"req {i}: {row}")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"generate: {dt:.2f} s for {args.requests} x {args.new_tokens} "
          f"tokens after a {args.prompt_len}-token prompt (first call; "
          f"weights {init_s:.1f} s) ({cfg.name}, "
          f"{model.n_params() / 1e6:.1f} M params, device={where})")
    return 0


def main(argv=None):
    from repro_torch.configs import ARCHS, CSNN_ARCHS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="csnn-paper", choices=tuple(ARCHS),
                    help="a CSNN (event-driven serving) or one of the ten "
                         "LM architectures (Engine.generate)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="LM prompt tokens per request")
    ap.add_argument("--new-tokens", type=int, default=16,
                    help="LM tokens generated per request")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="LM sampling temperature (0 = greedy)")
    ap.add_argument("--capacity", type=int, default=256,
                    help="AEQ depth per queue (CSNN only)")
    ap.add_argument("--channel-block", type=int, default=8,
                    help="output channels per MemPot tile")
    ap.add_argument("--event-par", type=int, default=-1,
                    help="interlaced event-parallel width: -1 sizes it per "
                         "layer (default), 0/1 keeps the sequential conv "
                         "unit, >1 pins the width")
    ap.add_argument("--batch-tile", type=int, default=8,
                    help="engine pads partial batches to this multiple")
    ap.add_argument("--iters", type=int, default=3,
                    help="steady-state timing iterations")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain path)")
    ap.add_argument("--tune", default="analytic",
                    choices=("analytic", "measured", "cached"),
                    help="plan derivation: the sizing model (analytic), "
                         "measured winners on --device persisted to the "
                         "plan cache (measured), or a cache load that "
                         "measures on a miss (cached; "
                         "REPRO_TORCH_PLAN_CACHE overrides the path)")
    ap.add_argument("--engine", action="store_true",
                    help="route requests through the async micro-batching "
                         "CSNNEngine")
    ap.add_argument("--continuous", action="store_true",
                    help="with --engine: continuous batching — slot-level "
                         "refill between t_chunk steps instead of "
                         "run-to-completion flushes")
    ap.add_argument("--stream", action="store_true",
                    help="serve raw DVS event traces through the "
                         "continuous engine's streaming admission "
                         "(implies --engine --continuous)")
    ap.add_argument("--t-chunk", type=int, default=0,
                    help="continuous-mode refill granularity in time steps "
                         "(0 = plan default; snapped to a divisor of T)")
    ap.add_argument("--deadline-ms", type=float, default=10.0,
                    help="engine flush deadline for partial batches")
    ap.add_argument("--verbose", action="store_true",
                    help="print the NetworkPlan and per-layer event counts")
    args = ap.parse_args(argv)
    if args.arch in CSNN_ARCHS:
        return serve_csnn(args)
    return serve_lm(args)


if __name__ == "__main__":
    sys.exit(main())
