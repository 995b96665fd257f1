"""Plan/execute split for the event pipeline (port of ``repro.core.plan``,
analytic mode).

``plan_network`` walks a ``CSNNConfig`` once and derives a frozen
:class:`LayerPlan` per conv layer — queue capacity, channel block, event
block, event-parallel width, membrane tile — plus the network knobs on
:class:`NetworkPlan`.  The runtime only executes plans.

The rules that change results are JAX's, unchanged: ``pad_capacity``,
``effective_capacity``, ``snap_t_chunk``, ``aeq.interlaced_capacity`` and
``snap_divisor`` for the channel block — so the same arguments give the
same truncation as the JAX package.  ``block_e`` and ``event_par`` keep
JAX's formulas against a model of one resident tile in
:data:`SMEM_PER_BLOCK` bytes (``kernels/event_conv/ops.py``); the gather
kernels stage no tile, so the model only chooses a schedule.  Given the
same budget and one resident tile, the port's plan equals JAX's field by
field (tests/test_torch_plan.py).

``plan_network(ingest=True)`` sizes the streaming ingestion buffers of
the input layer (``ingest_capacity``, ``ingest_depth``): JAX's fields and
rules, unchanged.  JAX's plan also picks how streamed input queues are
finalized; the port has one route for them, the builder over the banks
viewed as frames (``scheduler._event_sets``), so its plan has no such
field.

``plan_network(tune="measured"|"cached")`` hands the same knobs to the
measured tuner (``repro_torch.tune``), which times the candidate
schedules on the device and plans with the winners.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.kernels.event_conv.ops import (SMEM_PER_BLOCK,
                                                autotune_block_e,
                                                autotune_event_par,
                                                snap_block_e_for_par,
                                                snap_divisor)

from .aeq import calibrate_capacity, interlaced_capacity
from .geometry import GEOM_3X3, ConvGeometry

_VM_DTYPES = {None: torch.float32, 8: torch.int8, 16: torch.int16}

# Kernel variants a LayerPlan can pin (None = resolve from event_par).
# "sequential" walks each queue one event at a time (the sequential CUDA
# kernel); "interlaced-cuda" feeds segment-padded queues to the
# interlaced CUDA kernel; "banked-cuda" compacts dense frames into padded
# bank masks (``aeq.build_bank_masks``) and "fused-handoff" takes the
# fused-handoff carrier, which the producer layer emits from its
# threshold kernel (or ``aeq.build_fused_handoff`` builds at the network
# edge) — both feed the banked CUDA kernel.  A pin is the only way to the
# last two.  The kernels' wrappers run their plain versions for CPU
# tensors, so the device picks kernel or plain path, not the plan.
KERNEL_VARIANTS = ("sequential", "banked-cuda", "interlaced-cuda",
                   "fused-handoff")

TUNE_MODES = ("analytic", "measured", "cached")


def pad_capacity(capacity: int) -> int:
    """Queue depth padded to a multiple of 64 (depths <= 64 kept as-is);
    identical rounding everywhere is part of the truncation contract."""
    return -(-capacity // 64) * 64 if capacity > 64 else capacity


def effective_capacity(requested: int, hw: int) -> int:
    """``min(pad64(requested), H*W)``: a fmap holds at most H*W events."""
    return min(pad_capacity(requested), hw)


def snap_t_chunk(t_steps: int, requested: int) -> int:
    """Largest divisor of ``t_steps`` that is <= ``requested``."""
    if t_steps < 1 or requested < 1:
        raise ValueError(f"t_steps={t_steps} and requested={requested} "
                         f"must be >= 1")
    for c in range(min(requested, t_steps), 0, -1):
        if t_steps % c == 0:
            return c


@dataclass(frozen=True)
class LayerPlan:
    """Static per-layer resource plan (the design-time sizing record)."""

    index: int                    # position in cfg.layers
    name: str                     # parameter key, e.g. "conv0"
    in_hw: tuple[int, int]        # input fmap geometry (pre-conv)
    out_hw: tuple[int, int]       # output geometry (post-pool)
    c_in: int
    c_out: int
    pool: Optional[int]           # OR-max-pool window (None = no pool)
    capacity: int                 # effective AEQ depth per (t, c_in) queue
    channel_block: int            # output channels per MemPot tile
    block_e: int                  # event-block size (divides queue_depth)
    vm_tile: tuple[int, int, int]  # halo-padded tile (Hp, Wp, cb)
    sat_bits: Optional[int] = None  # 8/16-bit saturating datapath, None=f32
    event_par: int = 1            # same-column events applied together
    ingest_capacity: Optional[int] = None  # raw-event buffer depth per
                                  # stream admission (input layer only)
    ingest_depth: Optional[int] = None     # time bins per admission window
    variant: Optional[str] = None  # pinned kernel variant (KERNEL_VARIANTS)
    geometry: ConvGeometry = GEOM_3X3

    def resolve_variant(self) -> str:
        """Effective kernel variant: a pinned :attr:`variant` wins;
        otherwise ``event_par > 1`` selects the interlaced kernel (the JAX
        package's resolution under ``backend="pallas"``) and
        ``event_par == 1`` the sequential unit.  The banked and
        fused-handoff variants are reached only by a pin."""
        if self.variant is not None:
            return self.variant
        return "interlaced-cuda" if self.event_par > 1 else "sequential"

    @property
    def vm_dtype(self) -> torch.dtype:
        return _VM_DTYPES[self.sat_bits]

    @property
    def queue_depth(self) -> int:
        """Allocated queue slots: ``capacity``, or the segment-padded
        depth when ``event_par`` > 1."""
        return interlaced_capacity(self.capacity, self.event_par,
                                   self.geometry.n_banks)

    @property
    def event_slots(self) -> int:
        return self.queue_depth * self.c_in

    def __repr__(self) -> str:
        h, w = self.in_hw
        oh, ow = self.out_hw
        pool = f" pool{self.pool}" if self.pool else ""
        par = f", par={self.event_par}" if self.event_par > 1 else ""
        ing = (f", ingest={self.ingest_capacity}x{self.ingest_depth}"
               if self.ingest_capacity is not None else "")
        var = f", variant={self.variant}" if self.variant is not None else ""
        geo = ("" if self.geometry == GEOM_3X3
               else f", k={self.geometry.describe()}")
        dt = str(self.vm_dtype).replace("torch.", "")
        return (f"LayerPlan({self.name}: {h}x{w}x{self.c_in}{geo} -> "
                f"{oh}x{ow}x{self.c_out}{pool}, cap={self.capacity}, "
                f"cb={self.channel_block}, block_e={self.block_e}, "
                f"vm={self.vm_tile}, {dt}{par}{var}{ing})")


@dataclass(frozen=True)
class NetworkPlan:
    """Per-layer plans plus the network-wide knobs."""

    layers: tuple[LayerPlan, ...]   # one per conv layer, in network order
    t_steps: int
    batch_tile: int = 8             # serving batch granularity
    t_chunk: Optional[int] = None   # time steps per snn_step_chunk call
    fc_capacity: Optional[int] = None  # event-driven sparse FC head depth

    @property
    def chunk_steps(self) -> int:
        return self.t_chunk if self.t_chunk is not None else self.t_steps

    @property
    def total_event_slots(self) -> int:
        return self.t_steps * sum(lp.event_slots for lp in self.layers)

    @property
    def kernel_launches(self) -> int:
        """The port's kernel launches in one forward (any batch): a conv
        unit and a threshold unit per (channel block, time step) of every
        conv layer (``scheduler._run_chunk_from_events``), whatever the
        chunking; the head launches none of them."""
        return 2 * self.t_steps * sum(lp.c_out // lp.channel_block
                                      for lp in self.layers)

    def validate(self, cfg) -> "NetworkPlan":
        """Check the plan matches ``cfg`` geometry; returns self."""
        from .csnn import ConvSpec, conv_out_hw
        conv_specs = [(i, s) for i, s in enumerate(cfg.layers)
                      if isinstance(s, ConvSpec)]
        if len(conv_specs) != len(self.layers):
            raise ValueError(
                f"plan has {len(self.layers)} conv layers, cfg has "
                f"{len(conv_specs)}")
        if self.t_steps != cfg.t_steps:
            raise ValueError(
                f"plan t_steps={self.t_steps} != cfg t_steps={cfg.t_steps}")
        if self.t_chunk is not None and (
                not 1 <= self.t_chunk <= self.t_steps
                or self.t_steps % self.t_chunk != 0):
            raise ValueError(
                f"t_chunk={self.t_chunk} must divide t_steps={self.t_steps}")
        if self.fc_capacity is not None:
            last = self.layers[-1]
            d = last.out_hw[0] * last.out_hw[1] * last.c_out
            if not 1 <= self.fc_capacity <= d:
                raise ValueError(
                    f"fc_capacity={self.fc_capacity} must be in [1, D={d}] "
                    f"(the flattened final conv output feeding the head)")
        hw, c_in = tuple(cfg.input_hw), cfg.input_channels
        for lp, (idx, spec) in zip(self.layers, conv_specs):
            if lp.in_hw != hw or lp.c_in != c_in or lp.c_out != spec.channels:
                raise ValueError(f"{lp!r} does not match cfg layer {idx} "
                                 f"(in_hw={hw}, c_in={c_in}, "
                                 f"c_out={spec.channels})")
            if lp.geometry.window != (spec.kernel, spec.kernel):
                raise ValueError(
                    f"{lp!r} geometry {lp.geometry.describe()} does not "
                    f"match cfg layer {idx} kernel {spec.kernel}x"
                    f"{spec.kernel}")
            if lp.ingest_depth is not None and not (
                    1 <= lp.ingest_depth <= self.t_steps):
                raise ValueError(
                    f"{lp!r} ingest_depth={lp.ingest_depth} must be in "
                    f"[1, t_steps={self.t_steps}]")
            if lp.variant == "fused-handoff":
                # the carrier's bank grid derives from (in_hw, geometry);
                # the consumer's slices assume vm_tile covers that grid
                h, w = lp.in_hw
                hh, hw2 = lp.geometry.halo
                want = (h + 2 * hh, w + 2 * hw2, lp.channel_block)
                if tuple(lp.vm_tile) != want:
                    raise ValueError(
                        f"{lp!r} variant='fused-handoff' needs the "
                        f"halo-padded vm_tile {want} matching in_hw="
                        f"{lp.in_hw} under {lp.geometry.describe()}, got "
                        f"{tuple(lp.vm_tile)}: the handoff bank grid and "
                        f"the membrane banks would desynchronize")
            hw, c_in = conv_out_hw(hw, spec), spec.channels
        return self

    def __repr__(self) -> str:
        lines = [f"NetworkPlan(T={self.t_steps}, t_chunk={self.chunk_steps}, "
                 f"batch_tile={self.batch_tile}, "
                 f"total_event_slots={self.total_event_slots})"]
        lines += [f"  {lp!r}" for lp in self.layers]
        return "\n".join(lines)


def plan_conv_layer(
    index: int,
    name: str,
    in_hw: tuple[int, int],
    c_in: int,
    c_out: int,
    *,
    capacity: int,
    pool: Optional[int] = None,
    channel_block: int = 1,
    block_e: Optional[int] = None,
    sat_bits: Optional[int] = None,
    per_layer: bool = True,
    smem_budget: Optional[int] = None,
    event_par: Optional[int] = 1,
    ingest_capacity: Optional[int] = None,
    ingest_depth: Optional[int] = None,
    variant: Optional[str] = None,
    geometry: ConvGeometry = GEOM_3X3,
) -> LayerPlan:
    """Derive one conv layer's plan from its geometry.  ``event_par=None``
    sizes the interlaced width with ``autotune_event_par``; the sizing
    models one resident tile (one CTA) against ``smem_budget``."""
    geometry.require_event_compatible(f"plan_conv_layer({name})")
    h, w = in_hw
    hh, hw_ = geometry.halo
    cap = (effective_capacity(capacity, h * w) if per_layer
           else pad_capacity(capacity))
    cb = snap_divisor(c_out, channel_block)
    vm_tile = (h + 2 * hh, w + 2 * hw_, cb)
    vm_bytes = {None: 4, 8: 1, 16: 2}[sat_bits]
    budget = smem_budget if smem_budget else SMEM_PER_BLOCK
    if event_par is None:
        ep = autotune_event_par(cap, vm_tile, vm_bytes=vm_bytes,
                                geometry=geometry, smem_budget=budget)
    else:
        ep = max(1, int(event_par))
    depth = interlaced_capacity(cap, ep, geometry.n_banks)
    if block_e is None:
        be = autotune_block_e(depth, vm_tile, vm_bytes=vm_bytes,
                              smem_budget=budget)
    else:
        be = block_e
    if ep > 1:
        be = snap_block_e_for_par(depth, be, ep)
    else:
        be = snap_divisor(depth, be)
    out_hw = (-(-h // pool), -(-w // pool)) if pool else (h, w)
    if (ingest_capacity is None) != (ingest_depth is None):
        raise ValueError("ingest_capacity and ingest_depth must be set "
                         "together (both None for non-ingesting layers)")
    if ingest_capacity is not None and (ingest_capacity < 1
                                        or ingest_depth < 1):
        raise ValueError(f"ingest_capacity={ingest_capacity} and "
                         f"ingest_depth={ingest_depth} must be >= 1")
    if variant is not None and variant not in KERNEL_VARIANTS:
        raise ValueError(f"variant={variant!r} must be one of "
                         f"{KERNEL_VARIANTS} (or None to resolve from "
                         f"event_par)")
    if variant == "interlaced-cuda" and ep <= 1:
        raise ValueError(
            f"variant='interlaced-cuda' requires event_par > 1 (got {ep}): "
            f"the interlaced kernel walks event_par-aligned groups of the "
            f"segment-padded queue")
    return LayerPlan(index=index, name=name, in_hw=in_hw, out_hw=out_hw,
                     c_in=c_in, c_out=c_out, pool=pool, capacity=cap,
                     channel_block=cb, block_e=be, vm_tile=vm_tile,
                     sat_bits=sat_bits, event_par=ep,
                     ingest_capacity=ingest_capacity,
                     ingest_depth=ingest_depth, variant=variant,
                     geometry=geometry)


def plan_network(
    cfg,
    *,
    capacity: int | Sequence[int] = 256,
    channel_block: int | Sequence[int] = 1,
    block_e: Optional[int] | Sequence[Optional[int]] = None,
    sat_bits: Optional[int] = None,
    stats: Optional[Sequence] = None,
    percentile: float = 99.9,
    margin: float = 1.25,
    batch_tile: int = 8,
    per_layer: bool = True,
    smem_budget: Optional[int] = None,
    t_chunk: Optional[int] = None,
    event_par: Optional[int] | Sequence[Optional[int]] = 1,
    ingest: bool = False,
    ingest_capacity: Optional[int] = None,
    variant: Optional[str] | Sequence[Optional[str]] = None,
    fc_capacity: Optional[int] = None,
    tune: str = "analytic",
    tune_config=None,
    cache_path=None,
) -> NetworkPlan:
    """Derive a :class:`NetworkPlan` from a ``CSNNConfig`` (analytic
    sizing).  ``capacity``/``channel_block``/``event_par``/``block_e``/
    ``variant`` take one value or one per conv layer; ``t_chunk`` snaps to
    a divisor of T.  Per-layer spike-count ``stats`` (e.g.
    ``LayerStats.in_spike_counts`` of a calibration run) replace each
    layer's requested capacity with ``aeq.calibrate_capacity`` of its own
    counts (``percentile``, ``margin``, aligned to 8).  ``fc_capacity``
    routes the head through the event-driven sparse readout.

    ``ingest=True`` (or an ``ingest_capacity``) sizes the input layer's
    streaming ingestion: ``ingest_depth`` is the admission window in time
    bins (the chunk length) and ``ingest_capacity`` the raw-event buffer
    per admission, by default one input-queue depth of events per (bin,
    channel), padded to a multiple of 64.

    ``tune`` selects how the schedule knobs are derived: ``"analytic"``
    (the sizing model above); ``"measured"`` times candidate (block_e,
    event_par, variant, capacity sharing, t_chunk) settings on ``tune_config.device`` (a ``repro_torch.tune.TuneConfig``;
    CUDA by default) and plans with the winners, persisting them in the
    plan cache; ``"cached"`` loads winners from the cache (``cache_path``,
    else ``REPRO_TORCH_PLAN_CACHE``, else the per-user default) and
    measures only on a miss.  Every candidate gives the same results;
    only the time changes."""
    if tune not in TUNE_MODES:
        raise ValueError(f"tune={tune!r} must be one of {TUNE_MODES}")
    if tune != "analytic":
        from repro_torch.tune import tune_network
        base = dict(capacity=capacity, channel_block=channel_block,
                    block_e=block_e, sat_bits=sat_bits, stats=stats,
                    percentile=percentile, margin=margin,
                    batch_tile=batch_tile, per_layer=per_layer,
                    smem_budget=smem_budget, t_chunk=t_chunk,
                    event_par=event_par, ingest=ingest,
                    ingest_capacity=ingest_capacity, variant=variant,
                    fc_capacity=fc_capacity)
        return tune_network(cfg, mode=tune, base=base, config=tune_config,
                            cache_path=cache_path)
    from .csnn import ConvSpec, conv_out_hw
    conv_specs = [(i, s) for i, s in enumerate(cfg.layers)
                  if isinstance(s, ConvSpec)]
    n = len(conv_specs)

    def per_layer_list(x, seq_types):
        return list(x) if isinstance(x, seq_types) else [x] * n

    caps = per_layer_list(capacity, (list, tuple))
    cbs = per_layer_list(channel_block, (list, tuple))
    eps = per_layer_list(event_par, (list, tuple))
    bes = per_layer_list(block_e, (list, tuple))
    variants = per_layer_list(variant, (list, tuple))
    if any(len(x) != n for x in (caps, cbs, eps, bes, variants)):
        raise ValueError(f"need one capacity/channel_block/event_par/"
                         f"block_e/variant per conv layer ({n}), got "
                         f"{len(caps)}/{len(cbs)}/{len(eps)}/{len(bes)}/"
                         f"{len(variants)}")
    if stats is not None:
        if len(stats) != n:
            raise ValueError(f"need one stats entry per conv layer ({n}), "
                             f"got {len(stats)}")
        caps = [calibrate_capacity(s, percentile=percentile, margin=margin,
                                   align=8) for s in stats]
    if t_chunk is not None:
        t_chunk = snap_t_chunk(cfg.t_steps, t_chunk)
    plans, hw, c_in = [], tuple(cfg.input_hw), cfg.input_channels
    for ci, (idx, spec) in enumerate(conv_specs):
        ing_cap = ing_depth = None
        if ci == 0 and (ingest or ingest_capacity is not None):
            ing_depth = t_chunk if t_chunk is not None else cfg.t_steps
            auto = (effective_capacity(caps[ci], hw[0] * hw[1])
                    * c_in * ing_depth)
            ing_cap = (ingest_capacity if ingest_capacity is not None
                       else pad_capacity(auto))
        plans.append(plan_conv_layer(
            idx, f"conv{idx}", hw, c_in, spec.channels, capacity=caps[ci],
            pool=spec.pool, channel_block=cbs[ci], block_e=bes[ci],
            sat_bits=sat_bits, per_layer=per_layer, smem_budget=smem_budget,
            event_par=eps[ci], ingest_capacity=ing_cap,
            ingest_depth=ing_depth, variant=variants[ci],
            geometry=ConvGeometry(spec.kernel, spec.kernel)))
        hw, c_in = conv_out_hw(hw, spec), spec.channels
    return NetworkPlan(layers=tuple(plans), t_steps=cfg.t_steps,
                       batch_tile=batch_tile, t_chunk=t_chunk,
                       fc_capacity=fc_capacity)
