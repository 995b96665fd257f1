"""Served loop: single-sample requests through the program's serving
engine (``CSNNEngine.submit_nowait``) at the due times an arrival process
draws; each request is timed from its own due time to its logits on the
host.

Traffic keys: ``arrivals`` (``process`` names ``arrivals/<process>.py``;
the rest are its parameters) and ``engine`` (the engine's
``CSNNServeConfig``, passed as it is).
"""
from __future__ import annotations

import asyncio
import math
import time
from typing import Optional

import numpy as np
import torch

from harness import config, trace
from harness.record import Run, Setup, settle_gc
from harness.trace import Tracer, span

#: the arrival generator's tick (the event loop's timer resolution is 1 ms)
TICK_S = 1e-3
#: seconds of arrivals at the cell's rate served before the window
WARM_S = 1.0
#: seconds after the window that an answer may still come in
DRAIN_S = 60.0


async def _serve(engine, s: Setup, due: np.ndarray, rows: np.ndarray,
                 seconds: float, record: Optional[Run]) -> None:
    """Submit each request at its due time (seconds from the start); with
    a ``record``, keep latencies, answers and the traced stretch.  Each
    answer is copied out when it comes, so that no request's future or
    pinned buffer outlives it."""
    data = s.pool.data
    done_at = np.full(len(due), math.inf)
    answers = np.full((len(due), s.net["layers"][-1]["fc"]), np.nan,
                      np.float32)
    pending = [0]
    t0 = time.perf_counter()

    def finished(i, fut):
        pending[0] -= 1
        if not fut.cancelled() and fut.exception() is None:
            done_at[i] = time.perf_counter() - t0
            answers[i] = fut.result().numpy()

    tracer = Tracer() if (record is not None and s.trace) else None
    trace_from = max(0.0, seconds - trace.TRACE_S)
    i, late, tracing = 0, 0.0, False
    while i < len(due):
        now = time.perf_counter() - t0
        if tracer is not None and now >= trace_from and not tracing:
            tracer.start()
            tracing = True
        with span("submit", tracing):
            while i < len(due) and due[i] <= now:
                fut = engine.submit_nowait(data[int(rows[i])])
                pending[0] += 1
                fut.add_done_callback(lambda f, i=i: finished(i, f))
                late = max(late, now - due[i])
                i += 1
        # ticks of about 1 ms: the loop never spins, so the engine's
        # worker thread that waits on the device gets the interpreter
        await asyncio.sleep(TICK_S)
    if tracing:
        await asyncio.sleep(max(0.0, seconds - (time.perf_counter() - t0)))
        record.trace = tracer.stop()
    give_up = time.perf_counter() + DRAIN_S
    while pending[0] and time.perf_counter() < give_up:
        await asyncio.sleep(0.01)
    if record is None:
        return
    record.lateness_s = late
    record.due = len(due)
    ok = np.isfinite(done_at)
    record.latencies_s = [d - u if o else math.inf
                          for d, u, o in zip(done_at, due, ok)]
    idx = np.nonzero(ok)[0]
    record.answers.append((torch.from_numpy(rows[idx]),
                           torch.from_numpy(answers[idx])))
    record.window_rows.append(torch.from_numpy(rows[done_at <= seconds]))


def run(s: Setup, t_setup0: float) -> tuple[Run, float]:
    """Run the served loop; returns the run and its set-up seconds."""
    from repro_torch.serve.csnn_engine import CSNNEngine, CSNNServeConfig
    p, eng = s.program, s.traffic["engine"]
    arrivals = config.load_module("arrivals", s.traffic["arrivals"]["process"])
    engine = CSNNEngine(p.params, p.cfg, p.plan, CSNNServeConfig(**eng))
    engine.warmup()
    n_pool = len(s.pool)
    warm = arrivals.draw(s.traffic["arrivals"], WARM_S, n_pool, s.seed, 1)
    due, rows = arrivals.draw(s.traffic["arrivals"], s.seconds, n_pool,
                              s.seed, 2)
    record = Run(window_s=s.seconds, max_batch=eng["max_batch"])
    setup_s = 0.0

    async def main():
        nonlocal setup_s
        async with engine:
            await _serve(engine, s, *warm, WARM_S, None)
            if s.trace:  # the profiler's own start-up belongs to set-up
                tracer = Tracer()
                tracer.start()
                await _serve(engine, s, *warm, WARM_S, None)
                tracer.stop()
            before = dict(engine.stats)
            settle_gc()
            setup_s = time.perf_counter() - t_setup0
            await _serve(engine, s, due, rows, s.seconds, record)
            record.engine = {k: engine.stats[k] - before[k]
                             for k in ("requests", "batches", "padded_slots")}

    asyncio.run(main())
    return record, setup_s
