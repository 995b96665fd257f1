"""Offline loop: batches of the pool, copied to the device and encoded
there, through the program's entry, at most ``inflight`` batches enqueued
before the oldest one's logits are read on the host.

Traffic keys: ``batch`` (rows per forward) and ``inflight``.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Optional

import torch

from harness import trace
from harness.record import Run, Setup, settle_gc
from harness.trace import Tracer, span


class _Offline:
    def __init__(self, s: Setup):
        self.s = s
        self.batch = s.traffic["batch"]
        self.inflight = s.traffic["inflight"]
        self.n_batches = len(s.pool) // self.batch
        self.cuda = s.device.type == "cuda"
        data = s.pool.data
        self.data = data.pin_memory() if self.cuda else data
        n_out = s.net["layers"][-1]["fc"]
        self.bufs = [torch.empty((self.batch, n_out), pin_memory=self.cuda)
                     for _ in range(self.inflight + 1)]
        self.k = 0

    def enqueue(self, run: Optional[Run], traced: bool):
        """Copy, encode and enqueue the next batch; no wait on the device."""
        s, p, j = self.s, self.s.program, self.k % self.n_batches
        rows = torch.arange(j * self.batch, (j + 1) * self.batch)
        with span("copy_encode", traced):
            x = self.data[j * self.batch:(j + 1) * self.batch]
            x = x.to(s.device, non_blocking=True)
            if s.pool.kind == "images":
                x = p.encode(x)
        with span("snn_apply_batched", traced):
            t0 = time.perf_counter()
            logits = p.entry(p.params, x, p.cfg, p.plan, collect_stats=False)
            t1 = time.perf_counter()
        if run is not None:
            run.enqueue_s.append(t1 - t0)
        with span("to_host", traced):
            buf = self.bufs[self.k % len(self.bufs)]
            buf.copy_(logits, non_blocking=True)
            event = None
            if self.cuda:
                event = torch.cuda.Event()
                event.record()
        self.k += 1
        return rows, buf, event

    @staticmethod
    def finish(item, traced: bool):
        """Wait for one batch's logits on the host."""
        rows, buf, event = item
        with span("wait", traced):
            if event is not None:
                event.synchronize()
        return rows, buf.clone(), time.perf_counter()

    def warm(self, n: int) -> None:
        for _ in range(n):
            self.finish(self.enqueue(None, False), False)


def run(s: Setup, t_setup0: float) -> tuple[Run, float]:
    """Run the offline loop; returns the run and its set-up seconds."""
    loop = _Offline(s)
    loop.warm(2)
    if s.trace:  # the profiler's own start-up belongs to set-up
        tracer = Tracer()
        tracer.start()
        loop.warm(1)
        tracer.stop()
    record = Run(window_s=s.seconds)
    queue: deque = deque()
    settle_gc()
    t_start = time.perf_counter()
    setup_s = t_start - t_setup0
    t_end = t_start + s.seconds

    def settle(item, in_window_end, traced=False):
        rows, logits, t_done = loop.finish(item, traced)
        record.answers.append((rows, logits))
        if t_done <= in_window_end:
            record.window_rows.append(rows)
            record.span_s = t_done - t_start

    while time.perf_counter() < t_end:
        queue.append(loop.enqueue(record, False))
        record.due += loop.batch
        if len(queue) >= loop.inflight:
            settle(queue.popleft(), t_end)
    while queue:
        settle(queue.popleft(), t_end)
    if s.trace:
        per_s = max(len(record.answers), 1) / s.seconds
        n = max(4, math.ceil(trace.TRACE_S * per_s))
        tracer = Tracer()
        tracer.start()
        for _ in range(n):
            queue.append(loop.enqueue(None, True))
            record.due += loop.batch
            record.traced_rows.append(queue[-1][0])
            if len(queue) >= loop.inflight:
                settle(queue.popleft(), -math.inf, True)
        while queue:
            settle(queue.popleft(), -math.inf, True)
        record.trace = tracer.stop()
    return record, setup_s
