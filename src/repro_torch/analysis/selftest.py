"""Seeded-violation self-test: every analyzer must flag every fixture
(port of ``repro.analysis.selftest``).

A static analyzer that silently stops finding things is worse than none,
so each fixture below plants one known violation — a corrupted plan, a
hazard-colliding queue layout, an out-of-range launch shape, a wrapping
(non-saturating) adder, a source breaking a lint rule — and the
corresponding checker must produce a finding with the expected rule id.
A fixture that passes clean becomes a ``selftest-missed`` finding, which
fails the CLI exactly like a real violation would.

Every JAX fixture with a port rule carries over; JAX's oversized-BlockSpec
fixture has none (CUDA has no BlockSpecs), and the out-of-range launch
shape stands for it under ``oob-launch-bounds``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .report import Report


def _expect(out: Report, inner: Report, rule: str, fixture: str) -> None:
    """The seeded fixture must have produced >= 1 finding under `rule`."""
    if any(f.rule == rule for f in inner.findings):
        out.proved("selftest-seeded")
    else:
        out.flag("selftest", "selftest-missed", f"fixture:{fixture}",
                 f"seeded violation was NOT flagged under rule '{rule}' "
                 f"(findings: {[f.rule for f in inner.findings] or 'none'})")


def _paper_plan(**kwargs):
    from repro_torch.core.csnn import CSNNConfig
    from repro_torch.core.plan import plan_network

    return plan_network(CSNNConfig(), capacity=256, **kwargs)


def _broken_plans():
    """(fixture, rule, broken_plan) triples built by corrupting a real
    plan field by field — one violated contract each (JAX's fixtures,
    with the port's variant names and its shared-memory budget)."""
    from repro_torch.core.geometry import ConvGeometry

    plan = _paper_plan(channel_block=8, event_par=4)
    lp = plan.layers[0]

    def relayer(**kw):
        new0 = dataclasses.replace(lp, **kw)
        return dataclasses.replace(plan, layers=(new0,) + plan.layers[1:])

    class _DesyncedDepth:
        """Proxy of a LayerPlan whose allocated depth disagrees with the
        interlaced-capacity formula (the property is derived, so this
        corruption cannot be expressed with dataclasses.replace)."""

        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        @property
        def queue_depth(self):
            return self._inner.queue_depth + 1

    desynced = dataclasses.replace(
        plan, layers=(_DesyncedDepth(lp),) + plan.layers[1:])

    return [
        ("block-e-misaligned", "plan-block-e-divides-depth",
         relayer(block_e=lp.queue_depth - 1)),
        ("par-misaligned", "plan-block-e-par-aligned",
         relayer(block_e=lp.event_par + 1)),
        ("capacity-oversized", "plan-capacity-within-fmap",
         relayer(capacity=10 * lp.in_hw[0] * lp.in_hw[1])),
        ("depth-not-interlaced", "plan-queue-depth-interlaced", desynced),
        ("vm-tile-unpadded", "plan-vm-tile-geometry",
         relayer(vm_tile=(lp.in_hw[0], lp.in_hw[1], lp.channel_block))),
        # 32 float32 channels of a 30x30 tile, resident twice, overflow one
        # block's shared memory (JAX blew its VMEM model with batch_tile)
        ("smem-blown", "plan-smem-budget", _paper_plan(channel_block=32)),
        ("t-chunk-ragged", "plan-t-chunk-divides",
         dataclasses.replace(plan, t_chunk=plan.t_steps + 1)),
        ("ingest-halfset", "plan-ingest-sizing",
         relayer(ingest_capacity=64)),
        ("geometry-wrong-bank-count", "plan-vm-tile-geometry",
         # a 5x5 (25-bank) geometry stamped onto a layer whose tile and
         # queue were sized for the 3x3 (9-bank) layout
         relayer(geometry=ConvGeometry(5, 5))),
        ("variant-bogus", "plan-variant-valid",
         relayer(variant="fused-marvel")),
        ("fused-handoff-desynced-tile", "plan-fused-handoff-boundary",
         relayer(variant="fused-handoff",
                 vm_tile=(lp.in_hw[0], lp.in_hw[1], lp.channel_block))),
        ("fused-handoff-capacity-overrun", "plan-fused-handoff-boundary",
         relayer(variant="fused-handoff",
                 capacity=lp.in_hw[0] * lp.in_hw[1] + 64)),
        ("variant-interlaced-seq-width", "plan-variant-valid",
         relayer(variant="interlaced-cuda", event_par=1)),
        ("variant-bogus-on-inner-layer", "plan-variant-valid",
         dataclasses.replace(
             plan, layers=plan.layers[:1] + (dataclasses.replace(
                 plan.layers[1], variant="fused-marvel"),)
             + plan.layers[2:])),
    ]


def selftest_contracts(out: Report) -> None:
    from .contracts import audit_plan

    for fixture, rule, plan in _broken_plans():
        inner = Report()
        audit_plan(plan, None, case=f"selftest-{fixture}", report=inner)
        _expect(out, inner, rule, fixture)


def selftest_hazards(out: Report) -> None:
    from repro_torch.core.geometry import ConvGeometry

    from .hazards import (check_banked_masks, check_column_disjointness,
                          check_launch_bounds, check_padded_queue,
                          check_patch_bounds, plan_launches)

    # a hazard-colliding interlace scheme: period-2 columns put events 2
    # apart in the same column, whose 3x3 footprints overlap
    inner = Report()
    check_column_disjointness(
        column_of=lambda i, j: (i % 2) * 2 + (j % 2), report=inner)
    _expect(out, inner, "hazard-column-disjoint", "collider-column-map")

    # same failure at k=5: period-3 rows put events 3 apart in one
    # column, but a 5x5 footprint reaches 4 rows — they overlap
    inner = Report()
    check_column_disjointness(
        geometry=ConvGeometry(5, 5),
        column_of=lambda i, j: (i % 3) * 5 + (j % 5), report=inner)
    _expect(out, inner, "hazard-column-disjoint", "collider-column-map-k5")

    # malformed bank-occupancy mask set (wrong bank count)
    inner = Report()
    check_banked_masks(np.ones((4, 3, 3), bool), where="selftest",
                       report=inner)
    _expect(out, inner, "hazard-banked-masks", "malformed-bank-masks")

    # the 3x3 bank count shipped under a 5x5 geometry (25 banks needed)
    inner = Report()
    check_banked_masks(np.ones((9, 2, 2), bool),
                       geometry=ConvGeometry(5, 5), where="selftest",
                       report=inner)
    _expect(out, inner, "hazard-banked-masks", "wrong-bank-count-k5")

    # duplicate event inside one aligned group: same column, overlapping
    # footprints — the parallel scatter would drop one tap
    coords = np.array([[2, 2], [2, 2], [0, 0], [0, 1]], np.int32)
    valid = np.array([1, 1, 0, 0], bool)
    inner = Report()
    check_padded_queue(coords, valid, 2, where="selftest-dup", report=inner)
    _expect(out, inner, "hazard-segment-homogeneous", "duplicate-in-group")

    # column-heterogeneous aligned group (segment_pad contract broken)
    coords = np.array([[0, 0], [0, 1], [3, 3], [3, 3]], np.int32)
    valid = np.array([1, 1, 1, 0], bool)
    inner = Report()
    check_padded_queue(coords, valid, 2, where="selftest-mixed", report=inner)
    _expect(out, inner, "hazard-segment-homogeneous", "mixed-column-group")

    # an event patch overrunning the halo: the gather's clamp would move it
    inner = Report()
    check_patch_bounds(10, 10, coord_hi=(10, 9), where="selftest",
                       report=inner)
    _expect(out, inner, "oob-event-patch", "oob-event-patch")

    # an out-of-range launch shape: 1025 input channels' queues do not fit
    # the gather's 10-bit channel field
    plan = _paper_plan(channel_block=8)
    wide = dataclasses.replace(
        plan, layers=(plan.layers[0], dataclasses.replace(
            plan.layers[1], c_in=1025)) + plan.layers[2:])
    inner = Report()
    check_launch_bounds(plan_launches(wide, "selftest-c-in-1025"),
                        report=inner)
    _expect(out, inner, "oob-launch-bounds", "launch-out-of-range")


def selftest_kernel_audit(out: Report) -> None:
    from .kernel_audit import check_saturation

    def wrapping_apply(vm_p, coords, valid, kernel):
        """A deliberately broken datapath: accumulates in storage width,
        so the max-fan-in drive wraps negative instead of saturating."""
        vm = vm_p.numpy().copy()
        k = kernel.numpy()[::-1, ::-1]
        kh, kw = k.shape[:2]
        for (i, j), v in zip(coords.numpy(), valid.numpy()):
            if v:
                with np.errstate(over="ignore"):
                    vm[i:i + kh, j:j + kw, :] += k
        return vm

    inner = Report()
    check_saturation(wrapping_apply, report=inner)
    _expect(out, inner, "kernel-sat-overflow", "wrapping-adder")


_LINT_FIXTURES = [
    ("mutable-default-dataclass", "lint-mutable-default", "serve/cfgs.py",
     "import dataclasses\n"
     "@dataclasses.dataclass\n"
     "class Cfg:\n"
     "    buckets: list = []\n"),
    ("mutable-default-arg", "lint-mutable-default", "core/util.py",
     "class ServeConfig:\n"
     "    pass\n"
     "def make_engine(model, cfg=ServeConfig()):\n"
     "    return (model, cfg)\n"),
    ("launch-outside-kernels", "lint-kernel-launch-outside-kernels",
     "serve/fastpath.py",
     "import ctypes\n"
     "def fast(x):\n"
     "    return ctypes.CDLL('libevent_conv.so').event_conv_seq_single(x)\n"),
    ("host-sync-in-hot-path", "lint-host-sync-in-hot-path", "core/csnn.py",
     "def _drive(x):\n"
     "    return x.sum().item()\n"
     "def snn_step_chunk(params, state, spikes):\n"
     "    return state + _drive(spikes)\n"),
    ("global-rng", "lint-global-rng", "core/noise.py",
     "import torch\n"
     "def noisy(x):\n"
     "    return x + torch.randn(x.shape)\n"),
    ("reference-import", "lint-reference-import", "core/bridge.py",
     "from repro.core import aeq\n"
     "def build(fmap):\n"
     "    return aeq.build_aeq(fmap, 64)\n"),
]


def selftest_lint(out: Report) -> None:
    from .lint import lint_source

    for fixture, rule, fname, src in _LINT_FIXTURES:
        inner = Report()
        lint_source(src, fname, report=inner)
        _expect(out, inner, rule, fixture)
    # the ignore mechanism must actually suppress
    src = ("class C:\n"
           "    pass\n"
           "def f(c=C()):  # analysis: ignore[lint-mutable-default]\n"
           "    return c\n")
    inner = Report()
    lint_source(src, "core/ok.py", report=inner)
    if inner.ok:
        out.proved("selftest-seeded")
    else:
        out.flag("selftest", "selftest-missed", "fixture:ignore-mechanism",
                 "'# analysis: ignore[rule]' failed to suppress a finding")


def run_selftest(report: Optional[Report] = None) -> Report:
    rep = report if report is not None else Report()
    selftest_contracts(rep)
    selftest_hazards(rep)
    selftest_kernel_audit(rep)
    selftest_lint(rep)
    return rep
