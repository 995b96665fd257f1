"""Async micro-batching and continuous-batching engine for event-driven
CSNN inference (port of ``repro.serve.csnn_engine``).

Requests (single images, or raw DVS event traces) arrive one at a time;
the batched event pipeline pays off when many samples share one queue
compaction and one conv-unit launch per (channel block, time step).  The
engine bridges the two in two scheduling modes:

**Micro-batching (default).**  ``submit`` enqueues a request and awaits
its logits; a background flusher sends a batch to ``snn_apply_batched``
when ``max_batch`` requests are pending (size flush) or the oldest has
waited ``max_delay_ms`` (deadline flush).  Partial batches are padded
with zero images to a multiple of the plan's ``batch_tile``, so the
pipeline sees a few fixed batch shapes.

**Continuous batching (``CSNNServeConfig(continuous=True)``).**  The
engine owns a table of ``slots`` batch rows and one shared
:class:`~repro_torch.core.csnn.CSNNState` carry and advances the active
rows by ``t_chunk`` time steps per chunk (``snn_step_chunk``).  Between
chunks, rows whose request has consumed all T steps are read out and
their futures resolve; free rows are zeroed and refilled with newly
arrived requests, without waiting for the other rows.  Each chunk packs
the active rows into the smallest power-of-two occupancy bucket, so a
lone straggler steps at batch 1 (the single-queue kernels) and not at
``slots``.

**Streaming DVS ingestion (``stream=True``, continuous mode only).**
Requests are (N, 4) int rows of (t, y, x, polarity); admission scatters
them into the interlace-column banks (``data.dvs.events_to_banks``) and
each chunk passes a :class:`~repro_torch.core.aeq.StreamState`, whose
input queues the first layer finalizes from the banks.

The device.  Every tensor lives on the parameters' device.  Images are
encoded there (``encode_input``); host data moves through pinned memory
without blocking; the forward runs under ``torch.inference_mode()`` and
every kernel launches from the event-loop thread.  The only waits on the
device are one ``torch.cuda.Event`` per batch or chunk, recorded after
the forward and the copy of the logits into pinned host memory, and
waited on in ``asyncio.to_thread`` so the loop keeps accepting submits.
Admitting and stepping read nothing back from the device.  On the CPU
(plain path) the work is done when the call returns, and the loop yields
once per batch or chunk instead.

Spans and counters.  In a ``torch.profiler`` trace, each batch (each
chunk in continuous mode) is the span ``csnn.engine.launch`` from the
stack of its inputs to the enqueued copy-out, then, once the device is
done, ``csnn.engine.resolve`` over the futures' results; both carry the
sequence number (``seq``), the real requests (``requests``) and the
padded rows (``padded``).  The flusher handles one batch at a time, so
the stretch from a launch's end to its resolve is the device wait, and
from a resolve's end to the next launch the collection of requests.
Continuous mode also marks each request's encode as
``csnn.engine.encode``.  Always on, in ``stats``: ``queue_wait_ms_sum``
sums each request's ms from ``submit_nowait`` to the launch that
carries it (admission, in continuous mode), and ``launch_ms_sum`` the
host ms inside every launch stretch.

Per-request logits equal ``snn_apply_batched`` on the same requests in
every mode: rows are independent and the FC head sums the exact-integer
drive in float64 whatever the batch shape (tests/test_torch_engine.py,
tests/test_torch_streaming.py).
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.aeq import StreamState
from repro_torch.core.csnn import (CSNNConfig, CSNNState, ConvSpec,
                                   encode_input, init_state,
                                   snn_apply_batched, snn_readout,
                                   snn_step_chunk)
from repro_torch.core.plan import NetworkPlan, plan_network, snap_t_chunk
from repro_torch.core.scheduler import ConvCarry
from repro_torch.data.dvs import events_to_banks
from repro_torch.runtime.spans import span

_STOP = object()


def _n_classes(cfg: CSNNConfig) -> int:
    heads = [s for s in cfg.layers if not isinstance(s, ConvSpec)]
    if not heads:
        raise ValueError("cfg has no FC head layer")
    return heads[-1].features


def _map_state(fn, *states: CSNNState) -> CSNNState:
    """``fn`` over the matching leaves of ``states``."""
    return CSNNState(
        convs=tuple(ConvCarry(*map(fn, *carries))
                    for carries in zip(*(s.convs for s in states))),
        fc_drive=fn(*(s.fc_drive for s in states)))


def _reset_rows(state: CSNNState, mask: torch.Tensor) -> CSNNState:
    """Zero every state leaf's rows where ``mask`` (B,) is True: recycles
    admitted rows without touching in-flight ones."""
    return _map_state(lambda leaf: leaf.masked_fill(
        mask.reshape(mask.shape + (1,) * (leaf.ndim - 1)), 0), state)


@dataclasses.dataclass
class CSNNServeConfig:
    max_batch: int = 8          # size-flush threshold (requests per batch)
    max_delay_ms: float = 10.0  # flush deadline (micro-batching) / admission
                                # -wait SLO counted as a deadline miss
                                # (continuous)
    continuous: bool = False    # slot-level refill, not run-to-completion
    slots: int = 0              # continuous slot-table size (0 = max_batch)
    t_chunk: int = 0            # refill granularity in time steps
                                # (0 = plan.t_chunk, else 1; snapped to a
                                # divisor of T)
    stream: bool = False        # requests are raw DVS event streams (N, 4)
                                # admitted by bank append, not images
                                # (continuous mode only)


class CSNNEngine:
    """Micro/continuous-batching front end over the planned event pipeline.

    Use as an async context manager::

        engine = CSNNEngine(params, cfg, plan)
        async with engine:
            logits = await engine.submit(image)   # (H, W, C) -> (n_classes,)

    or serve a whole request list with ``run_requests``.  Requests are
    host data (numpy arrays or CPU tensors); logits come back as CPU
    tensors.  Without a ``plan``, the engine plans for ``cfg`` at a batch
    tile of ``max_batch``: ``tune="measured"`` or ``"cached"`` runs the
    measured tuner here, at construction and never on the request path,
    on the parameters' device, with the plan cache at ``cache_path`` (or
    the tuner's default location).  An explicit ``plan`` wins over
    ``tune``.
    """

    def __init__(self, params: dict, cfg: CSNNConfig,
                 plan: Optional[NetworkPlan] = None,
                 serve_cfg: Optional[CSNNServeConfig] = None, *,
                 tune: str = "analytic", cache_path=None):
        # a fresh default per engine: a shared default instance would
        # alias the mutable serving knobs across engines
        if serve_cfg is None:
            serve_cfg = CSNNServeConfig()
        self.cfg = cfg
        first = next(iter(params.values()))
        self.device = next(iter(first.values())).device
        if plan is None:
            tune_config = None
            if tune != "analytic":
                from repro_torch.tune import TuneConfig
                tune_config = TuneConfig(device=str(self.device))
            plan = plan_network(cfg, batch_tile=serve_cfg.max_batch,
                                tune=tune, tune_config=tune_config,
                                cache_path=cache_path)
        self.plan = plan
        self.serve_cfg = serve_cfg
        if serve_cfg.stream and not serve_cfg.continuous:
            raise ValueError(
                "CSNNServeConfig(stream=True) requires continuous=True: "
                "streaming admission rides the slot-level refill loop")
        if (not serve_cfg.continuous
                and serve_cfg.max_batch % self.plan.batch_tile != 0):
            # continuous mode never tile-pads: its batch is the slot table
            raise ValueError(
                f"max_batch={serve_cfg.max_batch} must be a multiple of the "
                f"plan's batch_tile={self.plan.batch_tile}")
        self._params = params
        self._queue: Optional[asyncio.Queue] = None
        self._flusher: Optional[asyncio.Task] = None
        self._inflight: set = set()  # unresolved request futures
        self.stats = {"requests": 0, "batches": 0, "flushes_full": 0,
                      "flushes_deadline": 0, "flushes_stop": 0,
                      "padded_slots": 0, "compile_s": 0.0,
                      # continuous-mode slot table observability
                      "chunks": 0, "admitted": 0, "retired": 0, "refills": 0,
                      "slot_steps_busy": 0, "slot_steps_total": 0,
                      "wait_ms_max": 0.0, "deadline_misses": 0,
                      # host-path counters of every batch or chunk
                      "queue_wait_ms_sum": 0.0, "launch_ms_sum": 0.0}
        if serve_cfg.continuous:
            self._slots = serve_cfg.slots or serve_cfg.max_batch
            requested = serve_cfg.t_chunk or (
                self.plan.t_chunk if self.plan.t_chunk is not None else 1)
            self._t_chunk = snap_t_chunk(cfg.t_steps, requested)
            # occupancy buckets: each chunk packs the active rows into the
            # smallest power of two (capped at the slot count) that holds
            # them, so chunk cost follows occupancy
            buckets, b = [], 1
            while b < self._slots:
                buckets.append(b)
                b *= 2
            buckets.append(self._slots)
            self._buckets = buckets
            # the input of a pad row: no events
            self._pad_input = torch.zeros(
                (self._t_chunk,) + self._input_shape()[1:], dtype=torch.bool,
                device=self.device)

    @property
    def slot_utilization(self) -> float:
        """Busy slot-chunks / total slot-chunks over the engine lifetime —
        the serving analogue of the paper's PE utilization figure."""
        total = self.stats["slot_steps_total"]
        return self.stats["slot_steps_busy"] / total if total else 0.0

    # ------------------------------------------------------------ device
    def _input_shape(self) -> tuple:
        """One request's encoded input: (T, H, W, C) spikes, or the
        (T, C, n_banks, HB, WB) stream banks."""
        h, w = self.cfg.input_hw
        c, t = self.cfg.input_channels, self.cfg.t_steps
        if self.serve_cfg.stream:
            geom = self.plan.layers[0].geometry
            return (t, c, geom.n_banks, -(-h // geom.kh), -(-w // geom.kw))
        return (t, h, w, c)

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """Host tensor -> the engine's device, through pinned memory and
        without waiting for the device."""
        if self.device.type != "cuda" or t.device == self.device:
            # a CPU engine, or already on the device: nothing to wait for
            # analysis: ignore[lint-host-sync-in-hot-path]
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """Device tensor -> a pinned host copy, enqueued behind the work
        that produces it; valid after :meth:`_device_done`."""
        if self.device.type != "cuda":
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)

    async def _device_done(self) -> None:
        """Wait, off the event loop, until the device has finished the
        work enqueued so far; on the CPU it is done, so just yield."""
        if self.device.type != "cuda":
            await asyncio.sleep(0)
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        await asyncio.to_thread(event.synchronize)

    @torch.inference_mode()
    def _infer(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) host images -> pinned host (B, n_classes) logits."""
        spikes = encode_input(self._to_device(images), self.cfg)
        return self._to_host(snn_apply_batched(
            self._params, spikes, self.cfg, self.plan, collect_stats=False))

    @torch.inference_mode()
    def _encode(self, payload) -> torch.Tensor:
        """One admitted request -> its encoded input on the device."""
        if self.serve_cfg.stream:
            h, w = self.cfg.input_hw
            banks = events_to_banks(payload, self.cfg.t_steps, (h, w),
                                    self.cfg.input_channels,
                                    geometry=self.plan.layers[0].geometry)
            return self._to_device(torch.from_numpy(banks))
        return encode_input(self._to_device(payload[None]), self.cfg)[0]

    @torch.inference_mode()
    def _init_slots(self) -> CSNNState:
        return init_state(self._params, self.cfg, self.plan, self._slots)

    @torch.inference_mode()
    def _step(self, state: CSNNState, act: list, bucket: int, inputs: list,
              admit: list, readout: bool):
        """One chunk over the active slots ``act`` packed into ``bucket``
        rows: gather their rows (pad rows gather the last slot again and
        are never written back), zero the newly admitted ones, step
        ``inputs`` (each slot's encoded window), write the real rows back
        in place and, when ``readout``, read the head out over the whole
        (slots, D) table.  Returns (state, pinned host logits or None)."""
        n, last = len(act), self._slots - 1
        ctl = self._to_device(torch.tensor(
            [act + [last] * (bucket - n), admit + [False] * (bucket - n)],
            dtype=torch.int64))
        idx, admit_rows = ctl[0], ctl[1].to(torch.bool)
        rows = _reset_rows(_map_state(lambda leaf: leaf.index_select(0, idx),
                                      state), admit_rows)
        chunk = torch.stack(inputs + [self._pad_input] * (bucket - n))
        if self.serve_cfg.stream:
            chunk = StreamState(banks=chunk)
        rows = snn_step_chunk(self._params, rows, chunk, self.cfg, self.plan)
        keep = idx[:n]
        state = _map_state(lambda full, part: full.index_copy_(0, keep,
                                                               part[:n]),
                           state, rows)
        if not readout:
            return state, None
        return state, self._to_host(
            snn_readout(self._params, state, self.cfg, self.plan))

    # ------------------------------------------------------------- lifecycle
    async def __aenter__(self) -> "CSNNEngine":
        self._queue = asyncio.Queue()
        self._flusher = asyncio.create_task(self._run_flusher())
        return self

    async def _run_flusher(self) -> None:
        """Run the configured scheduling loop; if it dies, fail every
        in-flight future — a crashed flusher must surface as an error at
        the awaiting callers, never as a silent hang."""
        try:
            if self.serve_cfg.continuous:
                await self._continuous_loop()
            else:
                await self._flush_loop()
        except BaseException as e:
            for fut in list(self._inflight):
                if not fut.done():
                    fut.set_exception(
                        RuntimeError(f"engine flusher died: {e!r}"))
            raise

    async def __aexit__(self, *exc) -> None:
        await self._queue.put(_STOP)
        await self._flusher
        self._queue = self._flusher = None

    def warmup(self) -> float:
        """Run every batch shape the engine can emit once, which builds
        the kernels and pays their first launches; returns the seconds
        spent (``stats["compile_s"]``) so serving latency can be reported
        without them.  Micro-batching runs each multiple of
        ``batch_tile`` up to ``max_batch``; continuous mode runs a chunk
        and the readout at every occupancy bucket."""
        h, w = self.cfg.input_hw
        c = self.cfg.input_channels
        t0 = time.perf_counter()
        if self.serve_cfg.continuous:
            state = self._init_slots()
            if not self.serve_cfg.stream:  # stream admission never encodes
                self._encode(torch.zeros((h, w, c)))
            for b in self._buckets:  # all pad rows
                state, _ = self._step(state, [], b, [], [], readout=True)
        else:
            tile = self.plan.batch_tile
            for b in range(tile, self.serve_cfg.max_batch + 1, tile):
                self._infer(torch.zeros((b, h, w, c)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["compile_s"] = time.perf_counter() - t0
        return self.stats["compile_s"]

    # ------------------------------------------------------------- requests
    def _payload(self, request):
        """Validate one request: an (N, 4) int event array in stream mode,
        else an (H, W, C) float image on the host."""
        if self.serve_cfg.stream:
            ev = np.asarray(request)
            if ev.ndim != 2 or ev.shape[1] != 4 or ev.dtype.kind not in "iu":
                raise ValueError(f"a stream request is an (N, 4) int array "
                                 f"of (t, y, x, polarity) rows, got "
                                 f"{ev.shape} {ev.dtype}")
            return ev
        img = torch.as_tensor(request, dtype=torch.float32)
        want = tuple(self.cfg.input_hw) + (self.cfg.input_channels,)
        if img.device.type != "cpu" or tuple(img.shape) != want:
            raise ValueError(f"an image request is a host (H, W, C) = "
                             f"{want} array, got {tuple(img.shape)} on "
                             f"{img.device}")
        return img

    def submit_nowait(self, request) -> "asyncio.Future":
        """Enqueue one request; returns a future of its (n_classes,)
        logits.  A malformed request fails its own future."""
        if self._queue is None:
            raise RuntimeError("engine is not running (use `async with`)")
        if self._flusher is not None and self._flusher.done():
            raise RuntimeError("engine flusher is not running (it stopped "
                               "or died); re-enter the context manager")
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        try:
            payload = self._payload(request)
        except (TypeError, ValueError) as e:
            fut.set_exception(e)
            return fut
        self._inflight.add(fut)
        fut.add_done_callback(self._inflight.discard)
        self._queue.put_nowait((payload, fut, loop.time()))
        self.stats["requests"] += 1
        return fut

    async def submit(self, request) -> torch.Tensor:
        """Enqueue one request and await its (n_classes,) logits."""
        return await self.submit_nowait(request)

    def run_requests(self, requests, *,
                     timeout: Optional[float] = None) -> torch.Tensor:
        """Serve a request list through the engine's own scheduling loop
        and return the stacked (N, n_classes) logits; raises
        ``TimeoutError`` if that takes longer than ``timeout`` seconds."""
        requests = list(requests)
        if not requests:
            return torch.zeros((0, _n_classes(self.cfg)))

        async def _drive():
            async with self:
                futs = [self.submit_nowait(r) for r in requests]
                return await asyncio.gather(*futs)

        return torch.stack(asyncio.run(asyncio.wait_for(_drive(), timeout)))

    # ------------------------------------------- run-to-completion batching
    def _drain_nowait(self) -> list:
        """Every request left in the queue (``_STOP`` markers dropped)."""
        items = []
        while True:
            try:
                item = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                return items
            if item is not _STOP:
                items.append(item)

    async def _flush_loop(self) -> None:
        loop = asyncio.get_running_loop()
        max_batch = self.serve_cfg.max_batch
        delay = self.serve_cfg.max_delay_ms / 1e3
        stopping = False
        while not stopping:
            first = await self._queue.get()
            if first is _STOP:
                break
            batch, deadline = [first], loop.time() + delay
            while len(batch) < max_batch:
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                try:
                    nxt = await asyncio.wait_for(self._queue.get(), timeout)
                except asyncio.TimeoutError:
                    break
                if nxt is _STOP:
                    stopping = True
                    break
                batch.append(nxt)
            if len(batch) >= max_batch:
                self.stats["flushes_full"] += 1
            elif stopping:  # stop-triggered flush, not a deadline expiry
                self.stats["flushes_stop"] += 1
            else:
                self.stats["flushes_deadline"] += 1
            await self._run_batch(batch)
        # Drain on stop: requests enqueued after _STOP (submit_nowait
        # racing __aexit__), also while a drained batch runs, are served
        # instead of leaving their futures hanging.
        while leftovers := self._drain_nowait():
            for k in range(0, len(leftovers), max_batch):
                self.stats["flushes_stop"] += 1
                await self._run_batch(leftovers[k:k + max_batch])

    async def _run_batch(self, batch: list) -> None:
        """Pad to the plan's batch tile, run the planned pipeline once,
        resolve every request future."""
        n = len(batch)
        tile = self.plan.batch_tile
        padded = -(-n // tile) * tile
        tags = {"seq": self.stats["batches"], "requests": n,
                "padded": padded}
        now = asyncio.get_running_loop().time()
        self.stats["queue_wait_ms_sum"] += sum(
            now - arrived for *_, arrived in batch) * 1e3
        t0 = time.perf_counter()
        with span("engine.launch", **tags):
            imgs = torch.stack([img for img, *_ in batch])
            if padded > n:  # zero images spike nowhere; pure pad rows
                imgs = torch.cat([imgs, imgs.new_zeros((padded - n,)
                                                       + imgs.shape[1:])])
            logits = self._infer(imgs)
        self.stats["launch_ms_sum"] += (time.perf_counter() - t0) * 1e3
        await self._device_done()
        with span("engine.resolve", **tags):
            self.stats["batches"] += 1
            self.stats["padded_slots"] += padded - n
            for i, (_, fut, _) in enumerate(batch):
                if not fut.done():
                    fut.set_result(logits[i])

    # ------------------------------------------- continuous slot-level refill
    async def _continuous_loop(self) -> None:
        """Slot table + refill loop (see module docstring).

        Loop invariant: every active slot ``i`` has consumed ``slot_t[i]``
        of its T input steps and the shared ``state`` rows hold exactly
        the carry of those steps; free rows hold garbage and are zeroed
        at admission.  The loop waits on the device once per chunk, off
        the event loop; which rows finish is known on the host, so the
        readout is enqueued only for chunks that retire a slot.
        """
        loop = asyncio.get_running_loop()
        S, tc, T = self._slots, self._t_chunk, self.cfg.t_steps
        state = self._init_slots()
        slot_in = [None] * S    # per-slot encoded inputs on the device
        slot_t = [0] * S        # input steps consumed per slot
        slot_fut = [None] * S
        active = [False] * S
        pending = []            # [encoded | None, payload, fut, arrived]
        stop_seen = False

        def encoded(entry):
            """Encode a pending entry in place, once: right after a chunk
            is enqueued (host work while the device runs), or at its
            admission if it arrived after that."""
            if entry[0] is None:
                with span("engine.encode"):
                    entry[0] = self._encode(entry[1])
            return entry[0]

        def drain_nowait():
            nonlocal stop_seen
            while True:
                try:
                    item = self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    return
                if item is _STOP:
                    stop_seen = True
                else:
                    pending.append([None, *item])

        while True:
            drain_nowait()
            # ---- admission: refill free slots; their rows are zeroed
            midflight = any(active[j] and slot_t[j] > 0 for j in range(S))
            admit = [False] * S
            now = loop.time()
            for i in range(S):
                if active[i] or not pending:
                    continue
                entry = pending.pop(0)
                slot_in[i], slot_fut[i] = encoded(entry), entry[2]
                slot_t[i] = 0
                active[i], admit[i] = True, True
                wait_ms = (now - entry[3]) * 1e3
                self.stats["queue_wait_ms_sum"] += wait_ms
                self.stats["admitted"] += 1
                self.stats["wait_ms_max"] = max(self.stats["wait_ms_max"],
                                                wait_ms)
                if wait_ms > self.serve_cfg.max_delay_ms:
                    self.stats["deadline_misses"] += 1
                if midflight:  # joined while others are mid-T: a refill
                    self.stats["refills"] += 1
            act = [i for i in range(S) if active[i]]
            if not act:
                if stop_seen and not pending:
                    drain_nowait()  # serve submits racing __aexit__, like
                    if not pending:  # the micro-batching drain does
                        break
                    continue
                item = await self._queue.get()  # idle: wait for work or stop
                if item is _STOP:
                    stop_seen = True
                else:
                    pending.append([None, *item])
                continue
            # ---- advance the active slots by one chunk in the smallest
            # occupancy bucket that holds them
            bucket = next(bb for bb in self._buckets if bb >= len(act))
            finished = [i for i in act if slot_t[i] + tc >= T]
            tags = {"seq": self.stats["chunks"], "requests": len(act),
                    "padded": bucket}
            t0 = time.perf_counter()
            with span("engine.launch", **tags):
                state, logits = self._step(
                    state, act, bucket,
                    [slot_in[i][slot_t[i]:slot_t[i] + tc] for i in act],
                    [admit[i] for i in act], readout=bool(finished))
            self.stats["launch_ms_sum"] += (time.perf_counter() - t0) * 1e3
            self.stats["chunks"] += 1
            self.stats["slot_steps_busy"] += len(act)
            self.stats["slot_steps_total"] += bucket
            # ---- overlap: encode the waiting backlog while the chunk runs
            drain_nowait()
            for entry in pending:
                encoded(entry)
            # ... then pace the loop to the device, off the event loop, so
            # submits keep arriving during the chunk
            await self._device_done()
            for i in act:
                slot_t[i] += tc
            with span("engine.resolve", **tags):
                for i in finished:  # retire
                    if not slot_fut[i].done():
                        slot_fut[i].set_result(logits[i])
                    active[i] = False
                    slot_fut[i] = slot_in[i] = None
                    self.stats["retired"] += 1
        # Failsafe: anything that slipped in after the final drain check is
        # failed explicitly so no future ever hangs.
        drain_nowait()
        for _, _, fut, _ in pending:
            if not fut.done():
                fut.set_exception(RuntimeError("engine stopped"))
