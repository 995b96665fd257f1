"""Micro-benchmark primitives of the measured tuner (port of
``repro.tune.measure``).

Every timed call goes through :func:`time_call`: the median wall time of
``iters`` calls after ``warmup`` calls, with ``torch.cuda.synchronize``
before and after each timed call on the card (none on the CPU).  Wall
time decides, not device time: every plan of the port is bound by the
host's launch loop, so a device-only timer would rank the wrong thing.
:func:`measurement_runs` counts every call made (warmup included); a
``tune="cached"`` hit must leave it unchanged.

Candidate inputs come from :func:`propagate_inputs`: a seeded Bernoulli
spike train pushed through the analytic plan layer by layer, so every
layer is measured on its own input distribution.  Every function takes
the tuning ``device`` explicitly.
"""
from __future__ import annotations

import statistics
import time

import torch

from repro_torch.core.csnn import ConvSpec, init_params, snn_apply_batched
from repro_torch.core.scheduler import (init_conv_carry,
                                        run_conv_layer_batched_chunk)

_MEASUREMENT_RUNS = 0


def measurement_runs() -> int:
    """Total timed-candidate calls this process has made."""
    return _MEASUREMENT_RUNS


def time_call(fn, *, device, warmup: int = 1, iters: int = 3) -> float:
    """Median microseconds of ``iters`` calls of ``fn()`` after ``warmup``
    untimed (but counted) ones.  On a CUDA ``device`` each call is
    bracketed by ``torch.cuda.synchronize``, so the time covers the
    launches and the device work they queue."""
    global _MEASUREMENT_RUNS
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(max(warmup, 0)):
        fn()
        sync()
        _MEASUREMENT_RUNS += 1
    times = []
    for _ in range(max(iters, 1)):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
        _MEASUREMENT_RUNS += 1
    return statistics.median(times) * 1e6


def synth_params(cfg, seed: int = 0, *, device) -> dict:
    """Seeded random parameters (``init_params``): every candidate gives
    the same results, so only the schedule's cost is measured."""
    return init_params(cfg, seed=seed, device=device)


def synth_spikes(cfg, batch: int, seed: int = 0, density: float = 0.15, *,
                 device) -> torch.Tensor:
    """Seeded (B, T, H, W, C_in) Bernoulli input spike train, drawn on the
    CPU from ``torch.Generator().manual_seed(seed)``."""
    h, w = cfg.input_hw
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((batch, cfg.t_steps, h, w, cfg.input_channels),
                   generator=g)
    return (u < density).to(device)


def propagate_inputs(params: dict, cfg, plan, x0: torch.Tensor, *,
                     device) -> tuple[list, list]:
    """Run the analytic plan once, whole T, to collect each conv layer's
    input.  Returns (per-layer input spikes [(B, T, H, W, C), ...],
    per-layer ``in_spike_counts`` (B, T, C_in) on the CPU)."""
    inputs, counts, x, ci = [], [], x0, 0
    for idx, spec in enumerate(cfg.layers):
        if not isinstance(spec, ConvSpec):
            continue
        inputs.append(x)
        p = params[f"conv{idx}"]
        lp = plan.layers[ci]
        carry = init_conv_carry(lp, x.shape[0], device=device)
        x, _, st = run_conv_layer_batched_chunk(x, p["w"], p["b"], cfg.v_t,
                                                lp, carry)
        counts.append(st.in_spike_counts.cpu())
        ci += 1
    return inputs, counts


def measure_layer(lp, spikes_in: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, v_t, *, device, warmup: int = 1,
                  iters: int = 3) -> float:
    """Median microseconds of one candidate layer plan over one chunk of
    real inputs from a fresh carry (the unit the per-layer search
    ranks).  A ``"fused-handoff"`` layer builds its carrier from the dense
    input here, as at the network edge."""
    batch = spikes_in.shape[0]

    def run():
        run_conv_layer_batched_chunk(spikes_in, w, b, v_t, lp,
                                     init_conv_carry(lp, batch, device=device))

    return time_call(run, device=device, warmup=warmup, iters=iters)


def measure_network(params: dict, x0: torch.Tensor, cfg, plan, *, device,
                    warmup: int = 1, iters: int = 3) -> float:
    """Median microseconds of the whole batched pipeline under ``plan``
    (the unit that ranks capacity sharing and t_chunk)."""
    def run():
        snn_apply_batched(params, x0, cfg, plan, collect_stats=False)

    return time_call(run, device=device, warmup=warmup, iters=iters)
