"""Plan-time invariant registry: prove the LayerPlan/NetworkPlan contract
(port of ``repro.analysis.contracts``).

``plan_network`` encodes the design-time sizing rules; this module
re-proves them from the outside over a geometry sweep grid, so a
regression in the sizing logic, a hand-built plan, or a plan-cache entry
that skips them is caught before any device work.  The measured tuner
loads every cached plan through :func:`audit_plan`.

The rules keep JAX's ids and meaning, with the port's variant names
(``interlaced-cuda``, ``banked-cuda``), except the budget rule:

* ``plan-block-e-divides-depth`` — the event-block grid tiles the queue.
* ``plan-block-e-par-aligned`` — with ``event_par > 1``, parallel groups
  tile event blocks and the segment-padded depth.
* ``plan-capacity-within-fmap`` — effective capacity <= padded H*W.
* ``plan-queue-depth-interlaced`` — depth equals
  ``interlaced_capacity(capacity, event_par, n_banks)``.
* ``plan-channel-block-divides`` — channel blocks tile C_out.
* ``plan-vm-tile-geometry`` — the membrane tile is halo-padded.
* ``plan-out-hw-pool`` — post-pool geometry is ceil-divided.
* ``plan-t-chunk-divides`` — t_chunk | T.
* ``plan-ingest-sizing`` — ingestion buffers cover the admission window,
  on the input layer only.
* ``plan-smem-budget`` — the port's sizing model (one CTA's tile, its
  event-stream blocks and taps) fits :data:`SMEM_PER_BLOCK`.  JAX's
  ``plan-vmem-budget`` models ``batch_tile`` resident tiles against a
  TPU core's VMEM instead.  The rule bounds the sizing model, not a
  kernel launch: the gather kernels stage no tile.
* ``plan-validate-agrees`` — ``NetworkPlan.validate(cfg)`` accepts.
* ``plan-variant-valid`` — pinned variants are dispatchable (JAX's rule
  also checks its streamed-finalize pin; the port's plan has none).
* ``plan-fused-handoff-boundary`` — the fused carrier's geometry lines
  up between producer and consumer.

Every contract is a small pure function registered in ``CONTRACTS``;
``audit_plan`` runs all of them over one (plan, cfg) pair and
``run_contracts`` sweeps :func:`sweep_cases`.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

from repro_torch.core.aeq import interlaced_capacity
from repro_torch.core.csnn import CSNNConfig, ConvSpec, FCSpec
from repro_torch.core.plan import (KERNEL_VARIANTS, LayerPlan, NetworkPlan,
                                   pad_capacity, plan_network)
from repro_torch.kernels.event_conv.ops import EVENT_BYTES, SMEM_PER_BLOCK

from .report import Report

# rule id -> (doc, checker).  A checker flags violations on the report and
# returns the number of obligations it discharged.
CONTRACTS: dict[str, tuple[str, Callable]] = {}


def contract(rule: str, doc: str):
    def register(fn):
        CONTRACTS[rule] = (doc, fn)
        return fn
    return register


def _layer_where(case: str, lp: LayerPlan) -> str:
    return f"plan[{case}].{lp.name}"


@contract("plan-block-e-divides-depth",
          "event-block grid tiles the allocated queue depth exactly")
def _check_block_e(plan: NetworkPlan, cfg, case: str, rep: Report) -> int:
    n = 0
    for lp in plan.layers:
        n += 1
        if lp.block_e < 1 or lp.queue_depth % lp.block_e != 0:
            rep.flag("contracts", "plan-block-e-divides-depth",
                     _layer_where(case, lp),
                     f"block_e={lp.block_e} does not tile queue_depth="
                     f"{lp.queue_depth}")
    return n


@contract("plan-block-e-par-aligned",
          "event_par groups tile event blocks and the segment-padded depth")
def _check_par_alignment(plan: NetworkPlan, cfg, case: str,
                         rep: Report) -> int:
    n = 0
    for lp in plan.layers:
        if lp.event_par <= 1:
            continue
        n += 1
        if lp.block_e % lp.event_par != 0:
            rep.flag("contracts", "plan-block-e-par-aligned",
                     _layer_where(case, lp),
                     f"block_e={lp.block_e} is not a multiple of "
                     f"event_par={lp.event_par}")
        if lp.queue_depth % lp.event_par != 0:
            rep.flag("contracts", "plan-block-e-par-aligned",
                     _layer_where(case, lp),
                     f"queue_depth={lp.queue_depth} is not a multiple of "
                     f"event_par={lp.event_par}")
    return n


@contract("plan-capacity-within-fmap",
          "effective AEQ capacity bounded by the padded feature-map size")
def _check_capacity(plan: NetworkPlan, cfg, case: str, rep: Report) -> int:
    n = 0
    for lp in plan.layers:
        n += 1
        hw = lp.in_hw[0] * lp.in_hw[1]
        if lp.capacity > pad_capacity(hw):
            rep.flag("contracts", "plan-capacity-within-fmap",
                     _layer_where(case, lp),
                     f"capacity={lp.capacity} exceeds padded fmap size "
                     f"pad64({lp.in_hw[0]}*{lp.in_hw[1]})={pad_capacity(hw)}")
        if lp.capacity < 1:
            rep.flag("contracts", "plan-capacity-within-fmap",
                     _layer_where(case, lp),
                     f"capacity={lp.capacity} must be >= 1")
    return n


@contract("plan-queue-depth-interlaced",
          "allocated depth equals the segment-padded interlaced capacity")
def _check_queue_depth(plan: NetworkPlan, cfg, case: str, rep: Report) -> int:
    n = 0
    for lp in plan.layers:
        n += 1
        nb = lp.geometry.n_banks
        want = interlaced_capacity(lp.capacity, lp.event_par, nb)
        if lp.queue_depth != want:
            rep.flag("contracts", "plan-queue-depth-interlaced",
                     _layer_where(case, lp),
                     f"queue_depth={lp.queue_depth} != interlaced_capacity("
                     f"{lp.capacity}, {lp.event_par}, n_banks={nb})={want}")
    return n


@contract("plan-channel-block-divides",
          "channel blocks tile the output channels exactly")
def _check_channel_block(plan: NetworkPlan, cfg, case: str,
                         rep: Report) -> int:
    n = 0
    for lp in plan.layers:
        n += 1
        if lp.channel_block < 1 or lp.c_out % lp.channel_block != 0:
            rep.flag("contracts", "plan-channel-block-divides",
                     _layer_where(case, lp),
                     f"channel_block={lp.channel_block} does not divide "
                     f"c_out={lp.c_out}")
    return n


@contract("plan-vm-tile-geometry",
          "membrane tile is the halo-padded (H+2hh, W+2hw, channel_block)")
def _check_vm_tile(plan: NetworkPlan, cfg, case: str, rep: Report) -> int:
    n = 0
    for lp in plan.layers:
        n += 1
        hh, hw = lp.geometry.halo
        want = (lp.in_hw[0] + 2 * hh, lp.in_hw[1] + 2 * hw,
                lp.channel_block)
        if tuple(lp.vm_tile) != want:
            rep.flag("contracts", "plan-vm-tile-geometry",
                     _layer_where(case, lp),
                     f"vm_tile={lp.vm_tile} != halo-padded {want}")
    return n


@contract("plan-out-hw-pool",
          "post-pool geometry is the ceil-divided feature map")
def _check_out_hw(plan: NetworkPlan, cfg, case: str, rep: Report) -> int:
    n = 0
    for lp in plan.layers:
        n += 1
        h, w = lp.in_hw
        want = (-(-h // lp.pool), -(-w // lp.pool)) if lp.pool else (h, w)
        if tuple(lp.out_hw) != want:
            rep.flag("contracts", "plan-out-hw-pool",
                     _layer_where(case, lp),
                     f"out_hw={lp.out_hw} != {want} for pool={lp.pool}")
    return n


@contract("plan-t-chunk-divides",
          "chunk length divides T (equal-length chunks for slot refill)")
def _check_t_chunk(plan: NetworkPlan, cfg, case: str, rep: Report) -> int:
    if plan.t_chunk is None:
        return 0
    if not (1 <= plan.t_chunk <= plan.t_steps
            and plan.t_steps % plan.t_chunk == 0):
        rep.flag("contracts", "plan-t-chunk-divides", f"plan[{case}]",
                 f"t_chunk={plan.t_chunk} does not divide "
                 f"t_steps={plan.t_steps}")
    return 1


@contract("plan-ingest-sizing",
          "streaming ingestion buffers sized for the admission window")
def _check_ingest(plan: NetworkPlan, cfg, case: str, rep: Report) -> int:
    n = 0
    for li, lp in enumerate(plan.layers):
        if (lp.ingest_capacity is None) != (lp.ingest_depth is None):
            rep.flag("contracts", "plan-ingest-sizing",
                     _layer_where(case, lp),
                     f"ingest_capacity={lp.ingest_capacity} and "
                     f"ingest_depth={lp.ingest_depth} must be set together")
            n += 1
            continue
        if lp.ingest_capacity is None:
            continue
        n += 1
        if li != 0:
            rep.flag("contracts", "plan-ingest-sizing",
                     _layer_where(case, lp),
                     "only the input layer admits raw DVS events; inner "
                     "layers build their queues from upstream spikes")
        if not 1 <= lp.ingest_depth <= plan.t_steps:
            rep.flag("contracts", "plan-ingest-sizing",
                     _layer_where(case, lp),
                     f"ingest_depth={lp.ingest_depth} outside "
                     f"[1, t_steps={plan.t_steps}]")
        window = lp.capacity * lp.c_in * lp.ingest_depth
        if lp.ingest_capacity < window:
            rep.flag("contracts", "plan-ingest-sizing",
                     _layer_where(case, lp),
                     f"ingest_capacity={lp.ingest_capacity} cannot buffer a "
                     f"worst-case admission window of {window} events "
                     f"(capacity={lp.capacity} * c_in={lp.c_in} * "
                     f"depth={lp.ingest_depth})")
    return n


def smem_model_bytes(lp: LayerPlan) -> int:
    """The sizing model behind ``autotune_block_e``/``autotune_event_par``:
    one CTA's membrane tile, resident twice (input and aliased output),
    its double-buffered event-stream block and its taps, in the plan's
    vm dtype."""
    vm_bytes = {None: 4, 8: 1, 16: 2}[lp.sat_bits]
    resident = 2 * math.prod(lp.vm_tile) * vm_bytes
    stream = 2 * lp.block_e * EVENT_BYTES
    taps = lp.geometry.n_banks * lp.channel_block * vm_bytes
    return resident + stream + taps


@contract("plan-smem-budget",
          "sizing model: one CTA tile + stream + taps fit SMEM_PER_BLOCK")
def _check_smem(plan: NetworkPlan, cfg, case: str, rep: Report) -> int:
    n = 0
    for lp in plan.layers:
        n += 1
        used = smem_model_bytes(lp)
        if used > SMEM_PER_BLOCK:
            rep.flag("contracts", "plan-smem-budget",
                     _layer_where(case, lp),
                     f"modelled shared memory {used} B exceeds the "
                     f"{SMEM_PER_BLOCK} B per-block budget (vm_tile="
                     f"{lp.vm_tile}, block_e={lp.block_e})")
    return n


@contract("plan-validate-agrees",
          "NetworkPlan.validate accepts the plan for its own config")
def _check_validate(plan: NetworkPlan, cfg, case: str, rep: Report) -> int:
    if cfg is None:
        return 0
    try:
        plan.validate(cfg)
    except (ValueError, KeyError) as e:
        rep.flag("contracts", "plan-validate-agrees", f"plan[{case}]",
                 f"plan.validate(cfg) rejected the plan: {e}")
    return 1


@contract("plan-variant-valid",
          "pinned kernel variants are dispatchable")
def _check_variant(plan: NetworkPlan, cfg, case: str, rep: Report) -> int:
    n = 0
    for lp in plan.layers:
        n += 1
        if lp.variant is not None and lp.variant not in KERNEL_VARIANTS:
            rep.flag("contracts", "plan-variant-valid",
                     _layer_where(case, lp),
                     f"variant={lp.variant!r} is not one of "
                     f"{KERNEL_VARIANTS}")
        if lp.variant == "interlaced-cuda" and lp.event_par <= 1:
            rep.flag("contracts", "plan-variant-valid",
                     _layer_where(case, lp),
                     f"variant='interlaced-cuda' with event_par="
                     f"{lp.event_par}: the interlaced kernel walks "
                     f"event_par-aligned groups and needs a width > 1")
    return n


@contract("plan-fused-handoff-boundary",
          "fused spike-emission handoff geometry lines up between layers")
def _check_fused_handoff(plan: NetworkPlan, cfg, case: str,
                         rep: Report) -> int:
    n = 0
    for i, lp in enumerate(plan.layers):
        if lp.variant != "fused-handoff":
            continue
        n += 1
        geom = lp.geometry
        hh, hw = geom.halo
        h, w = lp.in_hw
        want = (h + 2 * hh, w + 2 * hw, lp.channel_block)
        if tuple(lp.vm_tile) != want:
            rep.flag("contracts", "plan-fused-handoff-boundary",
                     _layer_where(case, lp),
                     f"vm_tile={tuple(lp.vm_tile)} != halo-padded {want}: "
                     f"the carrier's static bank placements index a "
                     f"ceil({want[0]}/{geom.kh}) x ceil({want[1]}/{geom.kw}) "
                     f"macro grid; any other tile desynchronizes the banks")
        if lp.capacity > h * w:
            rep.flag("contracts", "plan-fused-handoff-boundary",
                     _layer_where(case, lp),
                     f"capacity={lp.capacity} exceeds the {h}x{w} fmap: the "
                     f"carrier's rank truncation must equal the effective "
                     f"AEQ truncation min(capacity, H*W)")
        if i > 0:
            prev = plan.layers[i - 1]
            if tuple(prev.out_hw) != (h, w):
                rep.flag("contracts", "plan-fused-handoff-boundary",
                         _layer_where(case, lp),
                         f"producer {prev.name} emits {tuple(prev.out_hw)} "
                         f"post-pool but this consumer expects in_hw="
                         f"{(h, w)}: the emitted carrier would carry the "
                         f"wrong bank grid")
    return n


def audit_plan(plan: NetworkPlan, cfg: Optional[CSNNConfig] = None, *,
               case: str = "plan", report: Optional[Report] = None) -> Report:
    """Run every registered contract over one (plan, cfg) pair."""
    rep = report if report is not None else Report()
    for rule, (_, fn) in CONTRACTS.items():
        rep.proved(rule, fn(plan, cfg, case, rep))
    return rep


# ---------------------------------------------------------------------------
# Geometry sweep grid: the plans the registry is proven over on every run.
# ---------------------------------------------------------------------------

def sweep_cases() -> list[tuple[str, CSNNConfig, dict]]:
    """(name, cfg, plan_network kwargs): JAX's grid with the port's
    variant names — the paper net, small and rectangular fmaps, pool
    windows that do not divide H/W, 2-channel DVS inputs with streaming
    ingestion, int8/int16 datapaths, explicit and autotuned event_par,
    tiny and oversized capacities, 1x1 and 5x5 windows."""
    paper = CSNNConfig()
    small = CSNNConfig(input_hw=(10, 10),
                       layers=(ConvSpec(4), ConvSpec(4, pool=3), FCSpec(3)),
                       t_steps=4)
    rect = CSNNConfig(input_hw=(17, 13),
                      layers=(ConvSpec(6), ConvSpec(8, pool=3), FCSpec(4)),
                      t_steps=6)
    dvs = CSNNConfig(input_hw=(20, 24), input_channels=2,
                     layers=(ConvSpec(8, pool=2), ConvSpec(4), FCSpec(5)),
                     t_steps=8)
    k1 = CSNNConfig(input_hw=(12, 12),
                    layers=(ConvSpec(4, kernel=1), ConvSpec(4, kernel=1,
                                                            pool=2),
                            FCSpec(3)),
                    t_steps=4)
    wide = CSNNConfig(input_hw=(16, 14),
                      layers=(ConvSpec(6, kernel=5), ConvSpec(4, pool=3),
                              FCSpec(4)),
                      t_steps=5)
    return [
        ("paper", paper, dict(capacity=256, channel_block=8)),
        ("paper-autotuned-par", paper,
         dict(capacity=256, channel_block=8, event_par=None, block_e=None)),
        ("paper-int8-par4", paper,
         dict(capacity=256, channel_block=8, sat_bits=8, event_par=4)),
        ("paper-int16-chunked", paper,
         dict(capacity=256, sat_bits=16, t_chunk=1)),
        ("paper-oversized-capacity", paper, dict(capacity=4096)),
        ("small-tiny-capacity", small, dict(capacity=8)),
        ("small-par2", small, dict(capacity=100, event_par=2, t_chunk=2)),
        ("rect-autotuned", rect,
         dict(capacity=300, channel_block=[3, 4], event_par=None)),
        ("dvs-ingest", dvs,
         dict(capacity=128, event_par=None, t_chunk=4, ingest=True)),
        ("dvs-ingest-explicit", dvs,
         dict(capacity=64, t_chunk=2, ingest=True,
              ingest_capacity=pad_capacity(64 * 2 * 2))),
        ("paper-pinned-variants", paper,
         dict(capacity=256, channel_block=8, event_par=[1, 4, 4],
              variant=["sequential", "banked-cuda", "interlaced-cuda"])),
        ("paper-fused-handoff", paper,
         dict(capacity=256, channel_block=8, t_chunk=5,
              variant=["fused-handoff", "fused-handoff", "fused-handoff"])),
        ("wide-5x5-fused", wide,
         dict(capacity=96, channel_block=2, sat_bits=16,
              variant=[None, "fused-handoff"])),
        ("dvs-ingest-sort-finalize", dvs,
         dict(capacity=128, event_par=None, t_chunk=4, ingest=True,
              variant="banked-cuda")),
        ("k1-pointwise", k1, dict(capacity=64, event_par=2)),
        ("wide-5x5-autotuned", wide,
         dict(capacity=128, channel_block=2, event_par=None)),
        ("wide-5x5-int8-par", wide,
         dict(capacity=96, sat_bits=8, event_par=4, t_chunk=None)),
    ]


def run_contracts(report: Optional[Report] = None) -> Report:
    """Prove every contract over the whole geometry sweep grid."""
    rep = report if report is not None else Report()
    for case, cfg, kwargs in sweep_cases():
        audit_plan(plan_network(cfg, **kwargs), cfg, case=case, report=rep)
    return rep
