"""CSNN model assembly: the paper's 28x28-32C3-32C3-P3-10C3-F10 network
(port of ``repro.core.csnn``).

* ``snn_apply_batched`` — event-driven m-TTFS inference for a sample
  batch, the serving entry point: ``init_state``, then
  ``snn_step_chunk`` once per time chunk, then ``snn_readout``;
* ``snn_apply_sharded`` — ``snn_apply_batched`` with the batch split
  over a list of devices (the conv stack per shard, the FC head once on
  the gathered batch);
* ``snn_apply`` — the same inference for ONE sample, layer by layer
  (``scheduler.run_conv_layer_planned``, then ``run_fc_head``);
* ``snn_apply_dense`` — the frame-based spiking oracle, and
  ``ann_apply`` — the clamped-ReLU CNN the network is converted from
  (``core.conversion`` trains it);
* :class:`CSNN` — an ``nn.Module`` holding the parameters under the JAX
  package's keys (``conv0.w``, ``fc3.b``, ...) whose forward is
  ``snn_apply_batched``.

Parameters are a plain dict ``{"conv0": {"w": ..., "b": ...}, ...}`` —
the JAX pytree's layout, so ``convert.params_from_numpy`` moves weights
across unchanged.  Tensors live on ``device``, which defaults to
``"cuda"``; pass ``device="cpu"`` for the plain path.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from repro_torch.runtime.spans import span

from .encoding import mttfs_thresholds, multi_threshold_encode
from .event_conv import conv2d_same
from .aeq import StreamState
from .plan import NetworkPlan, plan_network
from .scheduler import (LayerStats, fc_readout, init_conv_carry,
                        run_conv_layer_batched_chunk,
                        run_conv_layer_dense, run_conv_layer_planned,
                        run_fc_head)


@dataclass(frozen=True)
class ConvSpec:
    channels: int
    kernel: int = 3
    pool: Optional[int] = None  # OR-max-pool window applied after this layer


@dataclass(frozen=True)
class FCSpec:
    features: int


@dataclass(frozen=True)
class CSNNConfig:
    """`28x28-32C3-32C3-P3-10C3-F10` == the paper's network (defaults)."""

    input_hw: tuple[int, int] = (28, 28)
    input_channels: int = 1
    layers: Sequence = field(default_factory=lambda: (
        ConvSpec(32), ConvSpec(32, pool=3), ConvSpec(10), FCSpec(10)))
    t_steps: int = 5
    v_t: float = 1.0
    relu_clamp: float = 1.0  # clamped-ReLU ceiling of the ANN (ann_apply)


def conv_out_hw(hw: tuple[int, int], spec: ConvSpec) -> tuple[int, int]:
    h, w = hw  # SAME padding keeps H, W; pooling ceil-divides
    if spec.pool:
        return (-(-h // spec.pool), -(-w // spec.pool))
    return (h, w)


def init_params(cfg: CSNNConfig, *, seed: int = 0, dtype=torch.float32,
                device="cuda") -> dict:
    """Random He-style parameters in the JAX pytree layout, drawn on the
    CPU from ``torch.Generator().manual_seed(seed)`` and moved to
    ``device``, so every device sees the same numbers."""
    g = torch.Generator().manual_seed(seed)
    params = {}
    hw, c_in = cfg.input_hw, cfg.input_channels
    for idx, spec in enumerate(cfg.layers):
        if isinstance(spec, ConvSpec):
            fan_in = spec.kernel * spec.kernel * c_in
            w = torch.randn((spec.kernel, spec.kernel, c_in, spec.channels),
                            generator=g) * (2.0 / fan_in) ** 0.5
            params[f"conv{idx}"] = {"w": w, "b": torch.zeros(spec.channels)}
            hw, c_in = conv_out_hw(hw, spec), spec.channels
        else:
            d = hw[0] * hw[1] * c_in
            w = torch.randn((d, spec.features), generator=g) * (1.0 / d) ** 0.5
            params[f"fc{idx}"] = {"w": w, "b": torch.zeros(spec.features)}
    return {k: {n: t.to(device=device, dtype=dtype) for n, t in p.items()}
            for k, p in params.items()}


def ann_apply(params: dict, images: torch.Tensor,
              cfg: CSNNConfig) -> torch.Tensor:
    """Clamped-ReLU CNN forward (the training path): images (B, H, W,
    C_in) in [0, 1] -> (B, n_classes).  Convolutions in full float32."""
    x = images
    for idx, spec in enumerate(cfg.layers):
        if isinstance(spec, ConvSpec):
            p = params[f"conv{idx}"]
            x = clamped_relu(conv2d_same(x, p["w"]) + p["b"], cfg.relu_clamp)
            if spec.pool:
                x = _max_pool(x, spec.pool)
        else:
            p = params[f"fc{idx}"]
            x = x.reshape(x.shape[0], -1) @ p["w"] + p["b"]
    return x


def clamped_relu(x: torch.Tensor, ceiling: float) -> torch.Tensor:
    """``jnp.clip(x, 0, ceiling)`` with its gradient: ``minimum(maximum(x,
    0), ceiling)``, whose backward splits a tie (x exactly 0 or exactly
    ``ceiling``) half and half as JAX's does; ``Tensor.clamp`` passes the
    whole gradient there.  The forward values are the same."""
    lo = torch.zeros((), dtype=x.dtype, device=x.device)
    hi = torch.full((), ceiling, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def _max_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Non-overlapping max-pool of (B, H, W, C), ragged edges padded with
    -inf."""
    x = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                (0, -x.shape[2] % window,
                                 0, -x.shape[1] % window),
                                value=float("-inf"))
    return torch.nn.functional.max_pool2d(x, window).permute(0, 2, 3, 1)


def encode_input(images: torch.Tensor, cfg: CSNNConfig) -> torch.Tensor:
    """(B, H, W, C) floats in [0, 1] -> (B, T, H, W, C) m-TTFS spikes."""
    thresholds = mttfs_thresholds(cfg.t_steps)
    return multi_threshold_encode(images, thresholds,
                                  cfg.t_steps).transpose(0, 1)


def _resolve_plan(cfg: CSNNConfig, plan: Optional[NetworkPlan],
                  capacity, channel_block: int,
                  sat_bits: Optional[int]) -> NetworkPlan:
    """The kwargs shim: a plan from the loose knobs when none is given,
    else the given plan validated against ``cfg``."""
    if plan is None:
        return plan_network(cfg, capacity=capacity,
                            channel_block=channel_block, sat_bits=sat_bits)
    return plan.validate(cfg)


def snn_apply(
    params: dict,
    in_spikes: torch.Tensor,
    cfg: CSNNConfig,
    plan: Optional[NetworkPlan] = None,
    *,
    capacity: int | Sequence[int] = 256,
    channel_block: int = 1,
    sat_bits: Optional[int] = None,
    collect_stats: bool = True,
):
    """Event-driven m-TTFS inference for ONE sample.

    in_spikes: (T, H, W, C_in) bool on the parameters' device.  Returns
    (logits (n_classes,), [LayerStats, ...]) or logits alone.  ``plan``
    carries the per-layer sizing; the ``capacity``/``channel_block``/
    ``sat_bits`` kwargs are the shim spelling, ignored when a plan is
    given.  ``plan.t_chunk`` plays no part: the layers run whole-T.
    """
    plan = _resolve_plan(cfg, plan, capacity, channel_block, sat_bits)
    x, stats, ci, logits = in_spikes, [], 0, None
    for idx, spec in enumerate(cfg.layers):
        if isinstance(spec, ConvSpec):
            p = params[f"conv{idx}"]
            x, st = run_conv_layer_planned(x, p["w"], p["b"], cfg.v_t,
                                           plan.layers[ci])
            stats.append(st)
            ci += 1
        else:
            p = params[f"fc{idx}"]
            logits = run_fc_head(x, p["w"], p["b"], capacity=plan.fc_capacity)
    if logits is None:
        raise ValueError("cfg has no FC head layer")
    return (logits, stats) if collect_stats else logits


def snn_apply_dense(params: dict, in_spikes: torch.Tensor,
                    cfg: CSNNConfig) -> torch.Tensor:
    """Frame-based spiking oracle of :func:`snn_apply` for one sample
    (``scheduler.run_conv_layer_dense`` per layer, the dense head)."""
    x, logits = in_spikes, None
    for idx, spec in enumerate(cfg.layers):
        if isinstance(spec, ConvSpec):
            p = params[f"conv{idx}"]
            x = run_conv_layer_dense(x, p["w"], p["b"], cfg.v_t,
                                     pool=spec.pool)
        else:
            p = params[f"fc{idx}"]
            logits = run_fc_head(x, p["w"], p["b"])
    if logits is None:
        raise ValueError("cfg has no FC head layer")
    return logits


class CSNNState(NamedTuple):
    """Explicit per-layer carry of the event pipeline over a batch:
    one ``ConvCarry`` per conv layer and the (B, D) accumulated FC drive
    (exact small integers in the head's dtype)."""

    convs: tuple
    fc_drive: torch.Tensor


def init_state(params: dict, cfg: CSNNConfig, plan: NetworkPlan,
               batch: int, device=None) -> CSNNState:
    """Fresh (t=0) state for ``batch`` samples on the parameters' device
    (or ``device``)."""
    plan.validate(cfg)
    fc = [params[f"fc{i}"]["w"] for i, s in enumerate(cfg.layers)
          if not isinstance(s, ConvSpec)]
    any_w = fc[-1] if fc else next(iter(params.values()))["w"]
    dev = any_w.device if device is None else device
    convs = tuple(init_conv_carry(lp, batch, device=dev) for lp in plan.layers)
    last = plan.layers[-1]
    d = last.out_hw[0] * last.out_hw[1] * last.c_out
    fc_dtype = fc[-1].dtype if fc else torch.float32
    return CSNNState(convs=convs,
                     fc_drive=torch.zeros((batch, d), dtype=fc_dtype,
                                          device=dev))


def snn_step_chunk(params: dict, state: CSNNState,
                   spikes_chunk: torch.Tensor | StreamState,
                   cfg: CSNNConfig, plan: NetworkPlan, *,
                   collect_stats: bool = False):
    """Advance the batched pipeline by one chunk of time steps.

    spikes_chunk: (B, t_chunk, H, W, C_in) bool, or a
    :class:`~repro_torch.core.aeq.StreamState` with banks (B, t_chunk,
    C_in, n_banks, HB, WB) of ingested DVS events, which the first conv
    layer consumes (equal to binning the events into frames).  Every conv
    layer runs ``scheduler.run_conv_layer_batched_chunk``.  Each conv layer consumes the chunk from its
    carry; the head drive accumulates the last conv layer's spikes.
    Returns the new state, or (state, [LayerStats, ...]) with
    ``collect_stats`` (without it no layer computes its statistics).
    Each conv layer's runner call is the span ``csnn.conv<i>`` (``i``
    its index among the conv layers) in a profiler trace, with the
    scheduler's ``csnn.conv<i>.queues`` and ``csnn.conv<i>.launches``
    inside it.

    The layer boundary: when the next conv layer is pinned to
    ``"fused-handoff"``, the producer emits that layer's
    ``aeq.FusedHandoff`` carrier from its threshold kernel (the JAX
    package builds the same carrier here with ``build_fused_handoff``),
    and the carrier passes in place of the dense spikes.
    """
    if not isinstance(spikes_chunk, (torch.Tensor, StreamState)):
        raise TypeError(f"spikes_chunk must be a tensor of spikes or a "
                        f"StreamState, got {type(spikes_chunk).__name__}")
    x, stats, ci = spikes_chunk, [], 0
    n_conv = len(plan.layers)
    new_convs = []
    for idx, spec in enumerate(cfg.layers):
        if isinstance(spec, ConvSpec):
            p = params[f"conv{idx}"]
            nxt = plan.layers[ci + 1] if ci + 1 < n_conv else None
            emit = ((nxt.capacity, nxt.geometry) if nxt is not None
                    and nxt.resolve_variant() == "fused-handoff" else None)
            with span(f"conv{ci}"):
                x, carry, st = run_conv_layer_batched_chunk(
                    x, p["w"], p["b"], cfg.v_t, plan.layers[ci],
                    state.convs[ci], emit=emit, collect_stats=collect_stats)
            new_convs.append(carry)
            stats.append(st)
            ci += 1
    b, c = x.shape[:2]
    drive = x.reshape(b, c, -1).to(state.fc_drive.dtype).sum(dim=1)
    state = CSNNState(convs=tuple(new_convs),
                      fc_drive=state.fc_drive + drive)
    return (state, stats) if collect_stats else state


def snn_readout(params: dict, state: CSNNState, cfg: CSNNConfig,
                plan: Optional[NetworkPlan] = None) -> torch.Tensor:
    """Classification-unit readout: drive @ W + T * b, never thresholded
    (:func:`scheduler.fc_readout`; through the event-driven sparse head
    when ``plan.fc_capacity`` is set); the span ``csnn.readout`` in a
    profiler trace."""
    capacity = plan.fc_capacity if plan is not None else None
    logits = None
    with span("readout"):
        for idx, spec in enumerate(cfg.layers):
            if not isinstance(spec, ConvSpec):
                p = params[f"fc{idx}"]
                logits = fc_readout(state.fc_drive, p["w"], p["b"],
                                    cfg.t_steps, capacity)
    if logits is None:
        raise ValueError("cfg has no FC head layer")
    return logits


def _merge_chunk_stats(chunks: list) -> list:
    """Per-chunk LayerStats -> whole-T stats: counts concatenate along the
    time axis; ``in_sparsity`` averages the (equal-length) chunk means."""
    merged = []
    for per_layer in zip(*chunks):
        merged.append(LayerStats(
            in_spike_counts=torch.cat([s.in_spike_counts for s in per_layer],
                                      dim=1),
            out_spike_counts=torch.cat([s.out_spike_counts for s in per_layer],
                                       dim=1),
            in_sparsity=sum(s.in_sparsity for s in per_layer) / len(per_layer),
            event_block=per_layer[0].event_block,
            event_par=per_layer[0].event_par,
        ))
    return merged


def snn_apply_batched(
    params: dict,
    in_spikes: torch.Tensor,
    cfg: CSNNConfig,
    plan: Optional[NetworkPlan] = None,
    *,
    collect_stats: bool = True,
):
    """Event-driven m-TTFS inference for a sample batch.

    in_spikes: (B, T, H, W, C_in) bool on the parameters' device.  Returns
    (logits (B, n_classes), [LayerStats, ...]) or logits alone, in which
    case no statistic is computed.  ``plan`` carries the per-layer sizing
    (``plan_network``; its defaults when None).  Chaining
    ``plan.chunk_steps`` chunks is exact for every chunking.
    """
    plan = plan_network(cfg) if plan is None else plan.validate(cfg)
    state, stats = _run_chunks(params, in_spikes, cfg, plan, collect_stats)
    logits = snn_readout(params, state, cfg, plan)
    return (logits, stats) if collect_stats else logits


def _run_chunks(params: dict, in_spikes: torch.Tensor, cfg: CSNNConfig,
                plan: NetworkPlan, collect_stats: bool
                ) -> tuple[CSNNState, Optional[list]]:
    """``snn_step_chunk`` over the whole window from a fresh state: the
    final state (its ``fc_drive`` per sample) and the merged LayerStats,
    or None without ``collect_stats``."""
    chunk = plan.chunk_steps
    state = init_state(params, cfg, plan, in_spikes.shape[0],
                       device=in_spikes.device)
    chunk_stats = []
    for k in range(0, cfg.t_steps, chunk):
        out = snn_step_chunk(params, state, in_spikes[:, k:k + chunk], cfg,
                             plan, collect_stats=collect_stats)
        if collect_stats:
            state, stats = out
            chunk_stats.append(stats)
        else:
            state = out
    return state, (_merge_chunk_stats(chunk_stats) if collect_stats
                   else None)


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: queued on the current stream onto a card;
    blocking onto the host, whose reader waits on no stream."""
    if device.type == "cuda":
        return t.to(device, non_blocking=True)
    # only a shard or head on the host copies here, and it reads next
    # analysis: ignore[lint-host-sync-in-hot-path]
    return t.to(device)


def _params_on(params: dict, device: torch.device) -> dict:
    """The parameters on ``device``, copied on that device's current
    stream (no copy where they already live there)."""
    with (torch.cuda.device(device) if device.type == "cuda"
          else contextlib.nullcontext()):
        return {k: {n: _to(t, device) for n, t in p.items()}
                for k, p in params.items()}


_SAMPLE_FIELDS = ("in_spike_counts", "out_spike_counts", "in_sparsity")


def _merge_shard_stats(shards: list) -> list:
    """Per-shard LayerStats -> the batch's: the per-sample fields
    concatenate in shard order; ``event_block`` and ``event_par`` are the
    same in every shard (JAX's ``out_specs`` replicate them) and are taken
    from shard 0."""
    merged = []
    for per_layer in zip(*shards):
        first = per_layer[0]
        if any((s.event_block, s.event_par)
               != (first.event_block, first.event_par) for s in per_layer):
            raise RuntimeError("shards disagree on event_block/event_par")
        merged.append(first._replace(**{
            f: torch.cat([getattr(s, f) for s in per_layer])
            for f in _SAMPLE_FIELDS}))
    return merged


def snn_apply_sharded(
    params: dict,
    in_spikes: torch.Tensor,
    cfg: CSNNConfig,
    plan: Optional[NetworkPlan] = None,
    *,
    devices: Optional[Sequence] = None,
    capacity: int | Sequence[int] = 256,
    channel_block: int = 1,
    sat_bits: Optional[int] = None,
    collect_stats: bool = False,
):
    """:func:`snn_apply_batched` sharded over the batch axis.

    in_spikes: (B, T, H, W, C_in) bool with B divisible by
    ``len(devices)``.  ``devices`` (where JAX takes a 1-D ``mesh``)
    defaults to every visible CUDA device
    (``sharding.specs.batch_devices``, which raises without one); a device
    may repeat.  Shard i runs ``snn_step_chunk`` over the window on
    ``devices[i]`` with no communication — on a CUDA device on a stream of
    its own, so shards sharing a card may overlap.  Each shard's (B/n, D)
    head drive (exact integer spike counts) is gathered on ``devices[0]``
    and ``snn_readout`` runs once on the whole (B, D) drive, the head call
    of :func:`snn_apply_batched`, so the logits ``torch.equal`` its.  This
    thread issues the shards in turn.

    Stream order on CUDA: the parameters are copied once per distinct
    device on that device's current stream; each shard's stream waits for
    that stream and for the stream that produced ``in_spikes``; a shard's
    outputs move to ``devices[0]`` on the shard's stream (a copy between
    cards makes the head's stream wait for it).  After the shards, every
    device's current stream waits on an event recorded after each of its
    shards, so the head reads finished drives and no tensor the shards
    read is freed under them; the shard outputs the head reads are
    ``record_stream``-ed to the head's stream.
    """
    plan = _resolve_plan(cfg, plan, capacity, channel_block, sat_bits)
    if devices is None:
        from repro_torch.sharding.specs import batch_devices
        devices = batch_devices()
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("snn_apply_sharded needs at least one device")
    b, n = in_spikes.shape[0], len(devices)
    if b % n != 0:
        raise ValueError(f"batch {b} does not divide over {n} devices")
    per, head = b // n, devices[0]
    placed = {dev: _params_on(params, dev) for dev in dict.fromkeys(devices)}
    waits = [torch.cuda.current_stream(d) for d in
             dict.fromkeys([*placed, in_spikes.device]) if d.type == "cuda"]
    drives, stats, done = [], [], []
    for i, dev in enumerate(devices):
        stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        if stream is not None:
            for w in waits:
                stream.wait_stream(w)
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            x = _to(in_spikes[i * per:(i + 1) * per], dev)
            state, st = _run_chunks(placed[dev], x, cfg, plan, collect_stats)
            drives.append(_to(state.fc_drive, head))
            if collect_stats:
                stats.append([s._replace(**{
                    f: _to(getattr(s, f), head)
                    for f in _SAMPLE_FIELDS}) for s in st])
        if stream is not None:
            done.append((dev, stream.record_event()))
    for dev, ev in done:
        torch.cuda.current_stream(dev).wait_event(ev)
    if head.type == "cuda":
        head_stream = torch.cuda.current_stream(head)
        for t in drives + [getattr(s, f) for st in stats for s in st
                           for f in _SAMPLE_FIELDS]:
            t.record_stream(head_stream)
    logits = snn_readout(placed[head], CSNNState(convs=(),
                                                 fc_drive=torch.cat(drives)),
                         cfg, plan)
    return (logits, _merge_shard_stats(stats)) if collect_stats else logits


class CSNN(nn.Module):
    """The network as an ``nn.Module``: parameters under the JAX keys
    (``conv0.w``, ``conv0.b``, ..., ``fc3.b``) and ``forward`` =
    :func:`snn_apply_batched`.  Inference only: nothing requires grad."""

    def __init__(self, cfg: CSNNConfig, params: Optional[dict] = None, *,
                 seed: int = 0, device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, seed=seed, device=device)
        for name, p in params.items():
            layer = nn.Module()
            for key, t in p.items():
                layer.register_parameter(
                    key, nn.Parameter(t, requires_grad=False))
            self.add_module(name, layer)

    def params(self) -> dict:
        """The parameter dict in the JAX pytree layout."""
        return {name: dict(mod.named_parameters(recurse=False))
                for name, mod in self.named_children()}

    def forward(self, in_spikes: torch.Tensor,
                plan: Optional[NetworkPlan] = None, **kwargs):
        return snn_apply_batched(self.params(), in_spikes, self.cfg, plan,
                                 **kwargs)
