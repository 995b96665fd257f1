"""Symbolic hazard-freedom and static bounds checking of the kernel layer
(port of ``repro.analysis.hazards``).

Every event-parallel path rests on one structural theorem (paper Sec.
"memory interlacing", Fig. 6): **two distinct events of the same
interlace column s = kw*(i%kh)+(j%kw) have disjoint kh x kw write
footprints**, so a whole column (or any same-column group) can be applied
in parallel without double-writing a membrane cell.  The port exploits it
in the interlaced gathers (``event_conv.cu``), the banked conv
(``event_conv_banked.cu``) and the ``segment_pad`` layout that feeds the
interlaced ones.  This module proves the theorem and audits each site,
parameterized over the window geometry (``run_hazards`` sweeps k in
{1, 3, 5}), with JAX's rule ids:

* ``hazard-column-disjoint`` — exhaustive proof over one congruence
  period (a 4k x 4k window sees every residue pair; footprints depend
  only on those, so the finite check is a proof for all H, W).
* ``hazard-mask-routing`` — the port's ``shifted_bank_masks`` (column,
  bank) slices of every one-hot event equal a brute-force enumeration of
  where each tap lands, one tap per bank per column.
* ``hazard-banked-masks`` — a concrete bank-occupancy set admits
  hazard-free whole-column application; run over the port's
  ``build_bank_masks`` of the adversarial maps (JAX runs it on the
  self-test's fixtures only).
* ``hazard-segment-homogeneous`` / ``hazard-segment-replay`` — the port's
  ``build_aeq`` + ``segment_pad`` layouts on adversarial maps: aligned
  groups are column-pure with disjoint footprints, and padding keeps the
  kept-event sequence.
* ``oob-event-patch`` — JAX's rule bounds a ``pl.dslice``; the CUDA
  gather instead clamps each event's window start,
  ``min(max(i, 0), hp - kh)`` (``kernels/csrc/event_conv.cu:261-262``).
  The port's rule proves that clamp is the identity on every valid
  coordinate of [0, H-1] x [0, W-1], so it never redirects a valid
  event's adds.
* ``oob-launch-bounds`` — CUDA has no BlockSpecs (JAX's
  ``oob-blockspec-bounds``).  For every plan of
  ``contracts.sweep_cases()`` and every shape of the kernel audit's sweep,
  the operands the scheduler would hand each wrapper pass that wrapper's
  own checks, called on meta tensors: the gather's packed key
  (``check_gather_limits``), the threshold unit's 2**31-element limit
  (``threshold_pool.kernel._check``) and the banked conv's staging
  against ``SMEM_PER_BLOCK`` (``check_banked``).  The emit's walk limit
  comes from the C library (``threshold_pool_emit_max_cells``), so the
  wrapper checks it on the card only.  The dynamic side of the rule is
  chip_smoke's memcheck run of the kernel audit.
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.geometry import GEOM_3X3, ConvGeometry

from .report import Report

#: Window geometries the proofs sweep — the paper's 3x3 plus the k=1 and
#: k=5 ends of the parametric generalization.
SWEEP_GEOMETRIES = (ConvGeometry(1, 1), GEOM_3X3, ConvGeometry(5, 5))

#: (h, w) fmaps the event-patch proof runs at, per geometry (JAX's five)
PATCH_HW = ((10, 10), (28, 28), (17, 13), (9, 16), (1, 1))


# ---------------------------------------------------------------------------
# Interlace-column disjointness: the hazard-freedom theorem.
# ---------------------------------------------------------------------------

def _footprint(i: int, j: int,
               geometry: ConvGeometry = GEOM_3X3) -> set[tuple[int, int]]:
    """Padded-space cells written by an event centred at unpadded (i, j):
    rows i..i+kh-1, cols j..j+kw-1."""
    kh, kw = geometry.window
    return {(i + a, j + b) for a in range(kh) for b in range(kw)}


def check_column_disjointness(window: Optional[int] = None, *,
                              geometry: ConvGeometry = GEOM_3X3,
                              column_of: Optional[Callable] = None,
                              report: Optional[Report] = None) -> Report:
    """Exhaustively prove same-column footprint disjointness on a window
    covering every congruence case (default 4*max(kh, kw)).
    ``column_of`` overrides the column map (i, j) -> s, which is how the
    self-test seeds a colliding interlace scheme."""
    rep = report if report is not None else Report()
    kh, kw = geometry.window
    if window is None:
        window = 4 * max(kh, kw)
    col = column_of if column_of is not None else geometry.column_index_py
    pixels = list(itertools.product(range(window), range(window)))
    checked = 0
    for (i1, j1), (i2, j2) in itertools.combinations(pixels, 2):
        if col(i1, j1) != col(i2, j2):
            continue
        checked += 1
        if _footprint(i1, j1, geometry) & _footprint(i2, j2, geometry):
            rep.flag("hazards", "hazard-column-disjoint",
                     f"window[{window}x{window},k={kh}x{kw}]",
                     f"events ({i1},{j1}) and ({i2},{j2}) share interlace "
                     f"column {col(i1, j1)} but their {kh}x{kw} write "
                     f"footprints overlap — parallel application would "
                     f"double-write")
    rep.proved("hazard-column-disjoint", checked)
    return rep


# ---------------------------------------------------------------------------
# shifted_bank_masks routing: the n_banks^2 (column, bank) static slices.
# ---------------------------------------------------------------------------

def one_hot_routing(i: int, j: int, hw: tuple[int, int],
                    geometry: ConvGeometry = GEOM_3X3) -> np.ndarray:
    """The port's ``shifted_bank_masks`` of one event at unpadded (i, j) of
    an (H, W) map: its centre padded and banked with ``aeq.interlace``
    (the ``build_bank_masks`` layout of that one kept event), as a
    (n_banks cols, n_banks banks, HB, WB) bool array."""
    from repro_torch.core.aeq import interlace
    from repro_torch.core.event_conv import shifted_bank_masks

    h, w = hw
    hh, hw_ = geometry.halo
    padded = torch.zeros((h + 2 * hh, w + 2 * hw_), dtype=torch.bool)
    padded[i + hh, j + hw_] = True
    return shifted_bank_masks(interlace(padded, geometry), geometry).numpy()


def check_mask_routing(hw: tuple[int, int] = (8, 9), *,
                       geometry: ConvGeometry = GEOM_3X3,
                       report: Optional[Report] = None) -> Report:
    """Verify the n_banks^2 ``shifted_bank_masks`` write masks against a
    brute-force enumeration, one one-hot event at a time.

    For an event at unpadded (i, j) of interlace column s, tap (a, b)
    writes padded cell (i+a, j+b), in bank t = kw*((i+a)%kh) + (j+b)%kw
    at macro cell ((i+a)//kh, (j+b)//kw).  The shifted masks must light
    exactly those n_banks cells in row s, one per bank, and every other
    row must stay dark.
    """
    rep = report if report is not None else Report()
    h, w = hw
    kh, kw = geometry.window
    hh, hw_ = geometry.halo
    nb = geometry.n_banks
    hb, wb = -(-(h + 2 * hh) // kh), -(-(w + 2 * hw_) // kw)
    for i in range(h):
        for j in range(w):
            s = geometry.column_index_py(i, j)
            got = one_hot_routing(i, j, hw, geometry)
            want = np.zeros((nb, nb, hb, wb), bool)
            for a in range(kh):
                for b in range(kw):
                    r, c = i + a, j + b
                    t = kw * (r % kh) + (c % kw)
                    want[s, t, r // kh, c // kw] = True
            if got.shape != want.shape or not np.array_equal(got, want):
                bad = (np.argwhere(got != want) if got.shape == want.shape
                       else [got.shape])
                rep.flag("hazards", "hazard-mask-routing",
                         f"event({i},{j})[k={kh}x{kw}]",
                         f"shifted_bank_masks routes column {s} wrongly at "
                         f"(col, bank, I, J)={tuple(bad[0])} — "
                         f"{len(bad)} cell(s) differ from the brute-force "
                         f"tap enumeration")
                continue
            banks_hit = {int(t) for t in np.argwhere(want[s].any((-2, -1)))
                         .ravel()}
            if banks_hit != set(range(nb)):
                rep.flag("hazards", "hazard-mask-routing",
                         f"event({i},{j})[k={kh}x{kw}]",
                         f"column {s} writes banks {sorted(banks_hit)} — "
                         f"the {nb}-tap footprint must hit each bank "
                         f"exactly once")
            rep.proved("hazard-mask-routing")
    return rep


def check_banked_masks(masks: np.ndarray, *,
                       geometry: ConvGeometry = GEOM_3X3,
                       where: str = "bank-masks",
                       report: Optional[Report] = None) -> Report:
    """Audit a concrete (n_banks, HB, WB) bank-occupancy mask set: every
    pair of occupied cells within one bank must map to padded positions
    >= kh (resp. kw) apart in some axis, i.e. the set admits hazard-free
    whole-column application.  Hand-built or corrupted mask sets are
    rejected before use."""
    rep = report if report is not None else Report()
    kh, kw = geometry.window
    nb = geometry.n_banks
    m = np.asarray(masks)
    if m.ndim != 3 or m.shape[0] != nb:
        rep.flag("hazards", "hazard-banked-masks", where,
                 f"expected ({nb}, HB, WB) bank masks for the {kh}x{kw} "
                 f"geometry, got shape {m.shape}")
        return rep
    for t in range(nb):
        cells = np.argwhere(m[t])
        for (i1, j1), (i2, j2) in itertools.combinations(map(tuple, cells), 2):
            p1 = (kh * i1 + t // kw, kw * j1 + t % kw)
            p2 = (kh * i2 + t // kw, kw * j2 + t % kw)
            if abs(p1[0] - p2[0]) < kh and abs(p1[1] - p2[1]) < kw:
                rep.flag("hazards", "hazard-banked-masks", where,
                         f"bank {t} holds events at padded {p1} and {p2} "
                         f"with overlapping {kh}x{kw} footprints")
        rep.proved("hazard-banked-masks")
    return rep


def check_bank_layout(hw: tuple[int, int] = (11, 13),
                      capacities: Sequence[int] = (16, 64, 1024), *,
                      geometry: ConvGeometry = GEOM_3X3,
                      report: Optional[Report] = None) -> Report:
    """:func:`check_banked_masks` of the port's ``build_bank_masks`` masks
    (the banked conv's carrier content) over the adversarial fmaps, at a
    truncating, a partial and a covering capacity."""
    from repro_torch.core.aeq import build_bank_masks

    rep = report if report is not None else Report()
    h, w = hw
    kh, kw = geometry.window
    for (name, fmap), cap in itertools.product(
            _adversarial_fmaps(h, w, geometry), capacities):
        masks = build_bank_masks(torch.from_numpy(fmap), cap, geometry).masks
        check_banked_masks(masks.numpy(), geometry=geometry,
                           where=f"bank_masks[{name},cap={cap},k={kh}x{kw}]",
                           report=rep)
    return rep


# ---------------------------------------------------------------------------
# segment_pad layout: the interlaced gathers' precondition.
# ---------------------------------------------------------------------------

def _adversarial_fmaps(h: int, w: int,
                      geometry: ConvGeometry = GEOM_3X3
                      ) -> list[tuple[str, np.ndarray]]:
    """Feature maps that stress the queue layout: dense, empty, single
    pixel, checkerboard, one full interlace column, and a seeded random
    (JAX's ``_adversarial_fmaps``, the same numbers)."""
    kh, kw = geometry.window
    rng = np.random.default_rng(0)
    full = np.ones((h, w), bool)
    empty = np.zeros((h, w), bool)
    single = np.zeros((h, w), bool)
    single[h // 2, w // 2] = True
    checker = np.indices((h, w)).sum(0) % 2 == 0
    one_col = np.zeros((h, w), bool)
    one_col[0::kh, 0::kw] = True
    rand = rng.random((h, w)) < 0.3
    return [("full", full), ("empty", empty), ("single", single),
            ("checker", checker), ("one-column", one_col), ("random", rand)]


def padded_layout(fmap: np.ndarray, capacity: int, event_par: int,
                  geometry: ConvGeometry = GEOM_3X3
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(coords, valid) of the port's ``build_aeq`` queue of ``fmap`` and of
    its ``segment_pad`` layout, as numpy arrays."""
    from repro_torch.core.aeq import build_aeq, segment_pad

    q = build_aeq(torch.from_numpy(fmap), capacity, geometry=geometry)
    qp = segment_pad(q, event_par, geometry)
    return (q.coords.numpy(), q.valid.numpy(), qp.coords.numpy(),
            qp.valid.numpy())


def check_segment_layout(hw: tuple[int, int] = (11, 13),
                         capacities: Sequence[int] = (16, 64, 1024),
                         event_pars: Sequence[int] = (2, 4, 8), *,
                         geometry: ConvGeometry = GEOM_3X3,
                         report: Optional[Report] = None) -> Report:
    """Audit the port's ``segment_pad`` layouts on adversarial fmaps: per
    (fmap, capacity, event_par) case, every aligned group is
    column-homogeneous with pairwise-disjoint footprints
    (:func:`check_padded_queue`), and the padded queue replays the exact
    kept-event sequence of the unpadded one."""
    rep = report if report is not None else Report()
    h, w = hw
    kh, kw = geometry.window
    for (name, fmap), cap, par in itertools.product(
            _adversarial_fmaps(h, w, geometry), capacities, event_pars):
        where = f"segment_pad[{name},cap={cap},par={par},k={kh}x{kw}]"
        coords, valid, pcoords, pvalid = padded_layout(fmap, cap, par,
                                                       geometry)
        check_padded_queue(pcoords, pvalid, par, geometry=geometry,
                           where=where, report=rep)
        kept = [tuple(c) for c, v in zip(coords, valid) if v]
        kept_p = [tuple(c) for c, v in zip(pcoords, pvalid) if v]
        if kept != kept_p:
            rep.flag("hazards", "hazard-segment-homogeneous", where,
                     f"segment_pad changed the kept-event sequence "
                     f"({len(kept)} -> {len(kept_p)} events)")
        rep.proved("hazard-segment-replay")
    return rep


def check_padded_queue(coords: np.ndarray, valid: np.ndarray,
                       event_par: int, *,
                       geometry: ConvGeometry = GEOM_3X3,
                       where: str = "queue",
                       report: Optional[Report] = None) -> Report:
    """Check one concrete (E, 2) queue layout for group homogeneity and
    in-group footprint disjointness (seedable with hand-built queues)."""
    rep = report if report is not None else Report()
    kh, kw = geometry.window
    e = coords.shape[0]
    if e % event_par != 0:
        rep.flag("hazards", "hazard-segment-homogeneous", where,
                 f"queue depth {e} is not a multiple of "
                 f"event_par={event_par}")
        return rep
    for g in range(e // event_par):
        sl = slice(g * event_par, (g + 1) * event_par)
        ev = [tuple(map(int, c)) for c, v in zip(coords[sl], valid[sl]) if v]
        cols = {geometry.column_index_py(i, j) for i, j in ev}
        if len(cols) > 1:
            rep.flag("hazards", "hazard-segment-homogeneous", where,
                     f"aligned group {g} mixes interlace columns "
                     f"{sorted(cols)}: events {ev}")
        for (i1, j1), (i2, j2) in itertools.combinations(ev, 2):
            if abs(i1 - i2) < kh and abs(j1 - j2) < kw:
                rep.flag("hazards", "hazard-segment-homogeneous", where,
                         f"group {g} events ({i1},{j1}) and ({i2},{j2}) "
                         f"have overlapping {kh}x{kw} footprints — "
                         f"parallel apply would double-write")
        rep.proved("hazard-segment-homogeneous")
    return rep


# ---------------------------------------------------------------------------
# The gather's window clamp.
# ---------------------------------------------------------------------------

def window_clamp(x: int, padded: int, window: int) -> int:
    """The gather's window start, ``min(max(x, 0), padded - window)``
    (``kernels/csrc/event_conv.cu:261-262``)."""
    return min(max(x, 0), padded - window)


def check_patch_bounds(h: int, w: int, *,
                       geometry: ConvGeometry = GEOM_3X3,
                       coord_hi: Optional[tuple[int, int]] = None,
                       where: Optional[str] = None,
                       report: Optional[Report] = None) -> Report:
    """Prove the gather's window clamp is the identity on every valid
    coordinate: valid events lie in [0, H-1] x [0, W-1] (``coord_hi``
    overrides the upper bounds, the self-test hook), each addresses a
    kh x kw window at that offset of the halo-padded (H+2hh, W+2hw) tile,
    and the clamp must leave every such start where it is — so the patch
    lands inside the tile and no valid event's adds are redirected."""
    rep = report if report is not None else Report()
    kh, kw = geometry.window
    hp, wp = geometry.padded_hw(h, w)
    hi_i, hi_j = coord_hi if coord_hi is not None else (h - 1, w - 1)
    loc = where or f"event_conv[{h}x{w},k={kh}x{kw}]"
    for axis, hi, pad, win in (("i", hi_i, hp, kh), ("j", hi_j, wp, kw)):
        moved = [x for x in range(hi + 1) if window_clamp(x, pad, win) != x]
        if hi < 0:
            rep.flag("hazards", "oob-event-patch", loc,
                     f"{axis}-axis: coordinate upper bound {hi} < 0")
        elif moved:
            rep.flag("hazards", "oob-event-patch", loc,
                     f"{axis}-axis: the window clamp min(max({axis}, 0), "
                     f"{pad} - {win}) moves {len(moved)} valid "
                     f"coordinate(s) from {moved[0]} up: their patch would "
                     f"reach {moved[-1] + win} > padded extent {pad} and "
                     f"land elsewhere")
        else:
            rep.proved("oob-event-patch")
    return rep


# ---------------------------------------------------------------------------
# Launch bounds: what the scheduler hands each wrapper passes its checks.
# ---------------------------------------------------------------------------

def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def conv_launch(kind: str, q: int, hp: int, wp: int, c: int, c_in: int,
                depth: int, geometry: ConvGeometry, dtype: torch.dtype,
                event_par: int = 1) -> Callable[[], None]:
    """The wrapper checks of one conv launch on meta operands: ``kind`` is
    "gather" (queues of ``depth`` slots on Q tiles, or on one tile when
    Q == 1, the single-queue kernel) or "banked" (the carrier)."""
    from repro_torch.kernels.event_conv import kernel as ek

    kh, kw = geometry.window
    nb = geometry.n_banks
    if kind == "banked":
        return lambda: ek.check_banked(
            _meta((q, hp, wp, c), dtype),
            _meta((c_in, q, nb, -(-hp // kh) + 2, -(-wp // kw) + 2),
                  torch.bool),
            _meta((c_in, nb, nb, c), dtype), geometry)
    single = q == 1
    lead = (c_in,) if single else (c_in, q)
    vm = _meta((hp, wp, c) if single else (q, hp, wp, c), dtype)
    coords = _meta(lead + (depth, 2), torch.int32)
    valid = _meta(lead + (depth,), torch.bool)
    kern = _meta((c_in, kh, kw, c), dtype)

    def run():
        ek._check(vm, coords, valid, kern, None, event_par, single=single)
        ek.check_gather_limits(vm, coords, valid, kern)
    return run


def threshold_launch(q: int, h: int, w: int, c: int, halo: tuple[int, int],
                     pool: Optional[int], dtype: torch.dtype
                     ) -> Callable[[], None]:
    """The threshold wrappers' operand checks (base and emit share them)
    on meta operands of Q halo-padded (H, W, C) tiles."""
    from repro_torch.kernels.threshold_pool import kernel as tk

    hh, hw = halo
    vm = _meta((q, h + 2 * hh, w + 2 * hw, c), dtype)
    return lambda: tk._check(vm, _meta((c,), dtype),
                             _meta((q, h, w, c), torch.bool), pool, halo, {})


def plan_launches(plan, case: str = "plan"
                  ) -> list[tuple[str, Callable[[], None]]]:
    """(where, check) of every wrapper launch a plan's conv layers make:
    per layer, one conv and one threshold launch per (channel block, time
    step), at the plan's ``batch_tile`` and at one sample (the
    single-queue kernels)."""
    out = []
    for lp in plan.layers:
        variant = lp.resolve_variant()
        h, w = lp.in_hw
        hp, wp, cb = lp.vm_tile
        kind = "banked" if variant in ("banked-cuda", "fused-handoff") \
            else "gather"
        for q in sorted({plan.batch_tile, 1}):
            where = f"plan[{case}].{lp.name}[{variant},B={q}]"
            out.append((where + ".conv", conv_launch(
                kind, q, hp, wp, cb, lp.c_in, lp.queue_depth, lp.geometry,
                lp.vm_dtype, lp.event_par if variant == "interlaced-cuda"
                else 1)))
            out.append((where + ".threshold", threshold_launch(
                q, h, w, cb, lp.geometry.halo, lp.pool, lp.vm_dtype)))
    return out


def sweep_launches() -> list[tuple[str, Callable[[], None]]]:
    """(where, check) of every launch shape the kernel audit's sweep makes
    (``kernel_audit._sweep``): the four gathers, the banked conv and
    the threshold unit at pool 3 and without a pool."""
    from .kernel_audit import QUEUES, _sweep

    out = []
    for case, h, w, c, block_e, par, dt, kk in _sweep():
        geom = ConvGeometry(kk, kk)
        hp, wp = geom.padded_hw(h, w)
        dtype = getattr(torch, dt)
        e = 4 * block_e
        where = f"sweep[{case}]"
        for q in (QUEUES, 1):
            out.append((f"{where}.gather[Q={q}]", conv_launch(
                "gather", q, hp, wp, c, 1, e, geom, dtype)))
            out.append((f"{where}.interlaced[Q={q}]", conv_launch(
                "gather", q, hp, wp, c, 1, e, geom, dtype, par)))
        out.append((f"{where}.banked", conv_launch(
            "banked", 1, hp, wp, c, 1, e, geom, dtype)))
        for pool in (3, None):
            ph = h + (-h % pool) if pool else h
            pw = w + (-w % pool) if pool else w
            out.append((f"{where}.threshold[pool={pool}]", threshold_launch(
                QUEUES, ph, pw, c, (0, 0), pool, dtype)))
    return out


def check_launch_bounds(launches: Optional[list] = None, *,
                        report: Optional[Report] = None) -> Report:
    """Run each launch's wrapper checks; a ``ValueError`` is a finding.
    ``launches`` defaults to every plan of ``contracts.sweep_cases()``
    and every shape of the kernel audit's sweep."""
    rep = report if report is not None else Report()
    if launches is None:
        from repro_torch.core.plan import plan_network

        from .contracts import sweep_cases
        launches = []
        for case, cfg, kwargs in sweep_cases():
            launches += plan_launches(plan_network(cfg, **kwargs), case)
        launches += sweep_launches()
    for where, check in launches:
        try:
            check()
        except ValueError as e:
            rep.flag("hazards", "oob-launch-bounds", where,
                     f"the wrapper refuses the operands the scheduler would "
                     f"hand it: {e}")
        else:
            rep.proved("oob-launch-bounds")
    return rep


def run_hazards(report: Optional[Report] = None) -> Report:
    """Run every hazard/bounds pass: the geometric ones once per
    :data:`SWEEP_GEOMETRIES` entry, then the launch bounds over every plan
    and sweep shape."""
    rep = report if report is not None else Report()
    for geom in SWEEP_GEOMETRIES:
        check_column_disjointness(geometry=geom, report=rep)
        check_mask_routing(geometry=geom, report=rep)
        check_bank_layout(geometry=geom, report=rep)
        check_segment_layout(geometry=geom, report=rep)
        for h, w in PATCH_HW:
            check_patch_bounds(h, w, geometry=geom, report=rep)
    check_launch_bounds(report=rep)
    return rep
