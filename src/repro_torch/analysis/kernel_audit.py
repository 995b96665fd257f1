"""Audit of each CUDA kernel's wrapper against its plain version (port of
``repro.analysis.kernel_audit``).

Every kernel in ``kernels/`` ships with a plain PyTorch version
(``ref.py``) and an exactness claim.  This pass re-verifies the contract
between the two per sweep geometry and dtype (JAX's ``_sweep``: float32,
int16 and int8, k in {1, 3, 5}), on the audit device: ``cuda`` launches
the seven conv and threshold kernels, the tile path of the batched
interlaced unit and the event-set builder (``aeq_build``) through their
wrappers, ``cpu`` runs the wrappers' plain versions.  The references always run on the CPU.  JAX's four rule
ids:

* ``kernel-shape-contract`` — every wrapper's outputs have the shapes and
  dtypes of its plain version's (JAX compares ``jax.eval_shape``).
* ``kernel-value-parity`` — on JAX's adversarial inputs
  (``default_rng(7)``, drawn in JAX's order): the raw queue with corner
  events, duplicates and ``-1`` sentinels through both sequential gathers;
  the deduplicated AEQ through both interlaced gathers and the tile path
  at the case's ``event_par``; its bank masks through the banked conv; the threshold
  unit at pool 3 and without, base and emit (capacity H*W // 2), the
  emitted masks also against ``aeq.build_fused_handoff``; the event-set
  builder on a map, its complement and a full map read through a strided
  view, at the case's capacity and ``event_par``, against its plain
  version (``build_aeq_batched`` + ``segment_pad``, permuted).  Compared by
  value (``torch.equal``): a CUDA gather skips invalid slots where
  Pallas adds +0.0, so a -0.0 cell stays -0.0.  After a ``cuda`` pass
  every kernel of ``runtime.LAUNCHES`` must have counted a
  launch (``runtime.LAUNCHES``), so none is quietly replaced by its plain
  version.
* ``kernel-checkify`` — torch has no ``checkify``: the plain datapaths
  (``event_conv_ref``, ``threshold_pool_ref``) run on ``default_rng(11)``
  inputs with explicit checks.  Every cell a valid event's patch touches
  lies inside the padded tile, computed from the coordinates (not through
  the datapath's clamp); an unclamped numpy replay of the same queue
  equals the plain version; float outputs are NaN-free.
* ``kernel-sat-overflow`` — int8/int16 saturation at maximum fan-in
  (k*k events around one cell, maximal taps, the tile one tap below the
  rail): every conv unit (the four gathers, the tile path and the banked
  conv) clamps at the bound instead of wrapping, and equals the per-event
  plain version.  ``apply_fn`` replaces the units (the self-test's wrapping
  adder must be flagged).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.geometry import GEOM_3X3, ConvGeometry
from repro_torch.kernels.runtime import LAUNCHES

from .report import Report

_SAT = {8: (-128, 127), 16: (-32768, 32767)}
#: tiles of the batched entries in the shape contract (JAX's q = 3)
QUEUES = 3
#: the seven conv and threshold kernels, the tile path of the batched
#: interlaced unit and the event-set builder, by their launch counters'
#: names
KERNELS = tuple(LAUNCHES)


def _sweep():
    """(name, h, w, c, block_e, event_par, dtype-name, k) geometry grid:
    paper shapes plus rectangular/int corners at 3x3, and the parametric
    windows (1x1 pointwise, 5x5 wide) the planner admits (JAX's grid;
    the gathers ignore ``block_e``, which only sizes E = 4 * block_e)."""
    return [
        ("paper28", 28, 28, 8, 32, 4, "float32", 3),
        ("rect", 10, 12, 8, 16, 4, "float32", 3),
        ("rect-int16", 10, 12, 8, 16, 2, "int16", 3),
        ("small-int8", 7, 9, 4, 6, 2, "int8", 3),
        ("deep-queue", 6, 6, 4, 24, 8, "float32", 3),
        ("pointwise-k1", 10, 10, 4, 8, 2, "float32", 1),
        ("wide-k5", 13, 12, 4, 16, 4, "float32", 5),
        ("wide-k5-int8", 11, 11, 4, 8, 2, "int8", 5),
    ]


def _adversarial_queue(h: int, w: int, e: int, rng,
                       geometry: ConvGeometry = GEOM_3X3
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Raw (coords, valid) stressing the halo/masking contract: the four
    corner events, a kh x kw cluster (maximum per-cell fan-in),
    duplicates, and invalid slots carrying the AEQ's -1 sentinels (JAX's
    ``_adversarial_queue``, the same draws)."""
    hh, hw = geometry.halo
    ci, cj = h // 2, w // 2
    events = [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (0, 0)]
    events += [(ci + di, cj + dj)
               for di in range(-hh, hh + 1) for dj in range(-hw, hw + 1)
               if 0 <= ci + di < h and 0 <= cj + dj < w]
    coords = np.full((e, 2), -1, np.int32)
    valid = np.zeros((e,), bool)
    n = min(len(events), e)
    coords[:n] = np.asarray(events[:n], np.int32)
    valid[:n] = True
    # a few valid events scattered into the tail, invalid gaps between
    for idx in range(n + 2, e, 3):
        coords[idx] = (rng.integers(0, h), rng.integers(0, w))
        valid[idx] = True
    return coords, valid


def _tile_and_kernel(rng, h: int, w: int, c: int, kk: int, dt: str,
                     span: int) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's draws of an (H, W, C) tile and a (k, k, C) kernel: standard
    normals, or integers in [lo // span, hi // span) and [-20, 20)."""
    if dt == "float32":
        vm0 = rng.standard_normal((h, w, c)).astype(np.float32)
        kern = rng.standard_normal((kk, kk, c)).astype(np.float32)
    else:
        lo, hi = _SAT[int(dt[3:])]
        vm0 = rng.integers(lo // span, hi // span, (h, w, c)).astype(dt)
        kern = rng.integers(-20, 20, (kk, kk, c)).astype(dt)
    return torch.from_numpy(vm0), torch.from_numpy(kern)


def _same(a, b) -> bool:
    """Equal by value, shape and dtype (``None`` only equals ``None``)."""
    if a is None or b is None:
        return a is None and b is None
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.cpu(), b.cpu()))


def _padded_masks(fmaps: torch.Tensor, capacity: int,
                  geometry: ConvGeometry) -> torch.Tensor:
    """The banked conv's carrier of (Q, H, W) fmaps: (1, Q, n_banks,
    HB+2, WB+2) bool, the ``build_bank_masks`` masks with one zero macro
    cell per side (as the scheduler's ``_event_sets`` pads them)."""
    from repro_torch.core.aeq import build_bank_masks

    m = build_bank_masks(fmaps, capacity, geometry).masks
    out = m.new_zeros(m.shape[:-2] + (m.shape[-2] + 2, m.shape[-1] + 2))
    out[..., 1:-1, 1:-1] = m
    return out[None]


class RedZones:
    """Places the audit's operands on the audit device inside red zones.

    Each tensor sits in the middle of a byte buffer whose :attr:`ZONE`
    bytes before and after hold :attr:`PATTERN`; :meth:`verify` flags,
    under ``oob-launch-bounds``, every buffer whose zones changed: a
    kernel wrote outside an operand it was handed.  A read outside one
    takes pattern bytes in, which the value comparisons catch.  This is
    the dynamic side of the launch-bounds rule where ``compute-sanitizer``
    cannot attach to the card.
    """

    ZONE = 1 << 16
    PATTERN = 0xA5

    def __init__(self, device, report: Report) -> None:
        self.device = torch.device(device)
        self.rep = report
        self._live: list[tuple[torch.Tensor, int, str]] = []

    def empty(self, shape, dtype) -> torch.Tensor:
        """A zoned tensor of ``shape``, its bytes the pattern too."""
        shape = tuple(shape)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        buf = torch.full((2 * self.ZONE + nbytes,), self.PATTERN,
                         dtype=torch.uint8, device=self.device)
        self._live.append((buf, nbytes, f"{shape} {dtype}"))
        return buf[self.ZONE:self.ZONE + nbytes].view(dtype).view(shape)

    def put(self, t: torch.Tensor) -> torch.Tensor:
        """A zoned copy of ``t`` on the audit device."""
        return self.empty(t.shape, t.dtype).copy_(t)

    def verify(self, where: str) -> None:
        """Check and release every live buffer's zones."""
        for buf, nbytes, what in self._live:
            zones = torch.cat([buf[:self.ZONE], buf[self.ZONE + nbytes:]])
            if bool((zones != self.PATTERN).any()):
                self.rep.flag("kernel_audit", "oob-launch-bounds", where,
                              f"a {what} operand's red zone changed: a "
                              f"kernel wrote outside the operand")
            else:
                self.rep.proved("oob-launch-bounds")
        self._live.clear()


def check_shape_contracts(report: Optional[Report] = None, *,
                          device="cpu") -> Report:
    """Every wrapper on ``device`` against its plain version on the CPU:
    output shapes and dtypes, all seven entries, the tile path and the
    event-set builder (its outputs zoned), per sweep case (the threshold
    unit at pool 3 and without, base and emit)."""
    from repro_torch.core.aeq import build_aeq_batched, segment_pad
    from repro_torch.core.event_conv import tap_matrix
    from repro_torch.kernels.aeq_build.kernel import aeq_build_cuda
    from repro_torch.kernels.aeq_build.ref import aeq_build_ref
    from repro_torch.kernels.event_conv import kernel as ek
    from repro_torch.kernels.event_conv import ref as er
    from repro_torch.kernels.threshold_pool import kernel as tk
    from repro_torch.kernels.threshold_pool.ref import threshold_pool_tile_ref

    rep = report if report is not None else Report()
    zones = RedZones(device, rep)
    put = zones.put
    rng = np.random.default_rng(3)
    brng = np.random.default_rng(13)  # the builder's maps

    def compare(name, got, want):
        got = got if isinstance(got, (list, tuple)) else [got]
        want = want if isinstance(want, (list, tuple)) else [want]
        desc = [None if t is None else (tuple(t.shape), str(t.dtype))
                for t in got]
        wdesc = [None if t is None else (tuple(t.shape), str(t.dtype))
                 for t in want]
        if desc != wdesc:
            rep.flag("kernel_audit", "kernel-shape-contract",
                     f"kernel:{name}",
                     f"wrapper outputs {desc} != plain version {wdesc}")
        else:
            rep.proved("kernel-shape-contract")

    for case, h, w, c, block_e, par, dt, kk in _sweep():
        geom = ConvGeometry(kk, kk)
        hp, wp = geom.padded_hw(h, w)
        dtype = getattr(torch, dt)
        e = 4 * block_e
        vm = torch.from_numpy(rng.integers(-50, 50, (QUEUES, hp, wp, c))
                              ).to(dtype)
        kern = torch.from_numpy(rng.integers(-20, 20, (kk, kk, c))).to(dtype)
        fm = torch.from_numpy(rng.random((QUEUES, h, w)) < 0.4)
        q = build_aeq_batched(fm, e, geometry=geom)
        qp = segment_pad(q, par, geom)
        masks = _padded_masks(fm, e, geom)
        taps = tap_matrix(kern).to(dtype)[None]
        entries = [
            ("event_conv_seq", ek.event_conv_cuda_batched,
             er.event_conv_ref_batched, (vm, q.coords, q.valid, kern), {}),
            ("event_conv_seq_single", ek.event_conv_cuda, er.event_conv_ref,
             (vm[0], q.coords[0], q.valid[0], kern), {}),
            ("event_conv_interlaced", ek.event_conv_cuda_interlaced_batched,
             er.event_conv_ref_interlaced_batched,
             (vm, qp.coords, qp.valid, kern), dict(event_par=par)),
            ("event_conv_interlaced_single", ek.event_conv_cuda_interlaced,
             er.event_conv_ref_interlaced,
             (vm[0], qp.coords[0], qp.valid[0], kern), dict(event_par=par)),
            ("event_conv_interlaced_tile", ek.event_conv_cuda_interlaced_tile,
             er.event_conv_ref_interlaced_batched,
             (vm, qp.coords, qp.valid, kern), dict(event_par=par)),
        ]
        for name, kfn, rfn, args, kw in entries:
            out = zones.empty(args[0].shape, dtype)
            compare(f"{name}[{case}]",
                    kfn(*map(put, args), out=out, **kw), rfn(*args, **kw))
            zones.verify(f"kernel:{name}[{case}]")
        # the event-set builder on a (QUEUES, 2, H, W, C) chunk, its
        # outputs zoned
        spk = torch.from_numpy(brng.random((QUEUES, 2, h, w, c)) < 0.4)
        want = aeq_build_ref(spk, e, par, geom)
        outs = {k: zones.empty(t.shape, t.dtype) for k, t in zip(
            ("coords_out", "valid_out", "count_out"), want)}
        compare(f"aeq_build[{case}]",
                aeq_build_cuda(put(spk), e, par, geom, **outs), want)
        zones.verify(f"kernel:aeq_build[{case}]")
        compare(f"event_conv_banked[{case}]",
                ek.event_conv_cuda_banked(put(vm), put(masks), put(taps),
                                          geometry=geom,
                                          out=zones.empty(vm.shape, dtype)),
                er.event_conv_ref_banked(vm, masks, taps, geom))
        zones.verify(f"kernel:event_conv_banked[{case}]")
        # the threshold unit at the kernel level: H, W padded to the pool
        # window, no halo
        for pool in (3, None):
            th = h + (-h % pool) if pool else h
            tw = w + (-w % pool) if pool else w
            tvm = torch.from_numpy(rng.integers(-50, 50, (QUEUES, th, tw, c))
                                   ).to(dtype)
            bias = torch.zeros((c,), dtype=dtype)
            fired = torch.from_numpy(rng.random((QUEUES, th, tw, c)) < 0.2)
            base = dict(v_t=1.0, pool=pool)
            emit = dict(base, emit_capacity=16, emit_geometry=geom)
            want = threshold_pool_tile_ref(tvm.clone(), bias, fired,
                                           halo=(0, 0), **emit)
            for name, kfn, kw, n_out in (
                    ("threshold_pool", tk.threshold_pool_cuda_batched, base,
                     2),
                    ("threshold_pool_emit", tk.threshold_pool_cuda_emit,
                     emit, 5)):
                # every output the wrapper takes, zoned
                outs = {k: zones.empty(t.shape, t.dtype) for k, t in zip(
                    ("fired_out", "pooled_out", "masks_out", "count_out",
                     "seg_counts_out")[:n_out], want) if t is not None}
                compare(f"{name}[{case},pool={pool}]",
                        kfn(put(tvm), put(bias), put(fired), **kw, **outs),
                        want[:n_out])
                zones.verify(f"kernel:{name}[{case},pool={pool}]")
    return rep


def check_value_parity(report: Optional[Report] = None, *,
                       device="cpu") -> Report:
    """Every wrapper on ``device`` equals its plain version (or the
    sequential oracle) by value on JAX's adversarial inputs.  The conv
    units update their zoned tiles in place, as the scheduler has them."""
    from repro_torch.core.aeq import (build_aeq, build_fused_handoff,
                                      segment_pad)
    from repro_torch.core.event_conv import apply_events, pad_vm, tap_matrix
    from repro_torch.kernels.aeq_build.kernel import aeq_build_cuda
    from repro_torch.kernels.aeq_build.ref import aeq_build_ref
    from repro_torch.kernels.event_conv import kernel as ek
    from repro_torch.kernels.event_conv.ref import (event_conv_ref,
                                                    event_conv_ref_batched)
    from repro_torch.kernels.threshold_pool.ops import threshold_pool

    rep = report if report is not None else Report()
    zones = RedZones(device, rep)
    put = zones.put
    rng = np.random.default_rng(7)
    brng = np.random.default_rng(17)  # the builder's maps

    def hold(ok: bool, where: str, message: str) -> None:
        if ok:
            rep.proved("kernel-value-parity")
        else:
            rep.flag("kernel_audit", "kernel-value-parity", where, message)
        zones.verify(where)

    for case, h, w, c, block_e, par, dt, kk in _sweep():
        geom = ConvGeometry(kk, kk)
        e = 4 * block_e
        vm0, kern = _tile_and_kernel(rng, h, w, c, kk, dt, 2)
        # the raw adversarial queue (duplicates, -1 sentinels) through both
        # sequential gathers; the batched one also takes it reversed
        coords, valid = _adversarial_queue(h, w, e, rng, geom)
        co, va = torch.from_numpy(coords), torch.from_numpy(valid)
        vm_p = pad_vm(vm0, geom)
        want = event_conv_ref(vm_p, co, va, kern)
        tile = put(vm_p)
        got = ek.event_conv_cuda(tile, put(co), put(va), put(kern), out=tile)
        hold(_same(got, want), f"kernel:event_conv_seq_single[{case}]",
             "sequential gather diverges from the plain version on the "
             "adversarial queue (corners/duplicates/-1 sentinels)")
        cob, vab = torch.stack([co, co.flip(0)]), torch.stack([va, va.flip(0)])
        vmb = torch.stack([vm_p, vm_p])
        want = event_conv_ref_batched(vmb, cob, vab, kern)
        tiles = put(vmb)
        got = ek.event_conv_cuda_batched(tiles, put(cob), put(vab),
                                         put(kern), out=tiles)
        hold(_same(got, want), f"kernel:event_conv_seq[{case}]",
             "batched sequential gather diverges from the plain version on "
             "the adversarial queues")
        # the deduplicated, interlace-ordered AEQ of a map and of its
        # complement: both interlaced gathers and the banked conv against
        # the sequential oracle
        fmap = torch.from_numpy(rng.random((h, w)) < 0.4)
        fmaps = torch.stack([fmap, ~fmap])
        queues = [build_aeq(m, e, geometry=geom) for m in fmaps]
        bases = [apply_events(vm_p, q, kern) for q in queues]
        padded = [segment_pad(q, par, geom) for q in queues]
        tile = put(vm_p)
        got = ek.event_conv_cuda_interlaced(
            tile, put(padded[0].coords), put(padded[0].valid), put(kern),
            event_par=par, out=tile)
        hold(_same(got, bases[0]),
             f"kernel:event_conv_interlaced_single[{case}]",
             f"interlaced gather (event_par={par}) diverges from the "
             f"sequential apply_events oracle")
        tiles = put(vmb)
        got = ek.event_conv_cuda_interlaced_batched(
            tiles, put(torch.stack([p.coords for p in padded])),
            put(torch.stack([p.valid for p in padded])), put(kern),
            event_par=par, out=tiles)
        hold(_same(got, torch.stack(bases)),
             f"kernel:event_conv_interlaced[{case}]",
             f"batched interlaced gather (event_par={par}) diverges from the "
             f"sequential apply_events oracle")
        tiles = put(vmb)
        got = ek.event_conv_cuda_interlaced_tile(
            tiles, put(torch.stack([p.coords for p in padded])),
            put(torch.stack([p.valid for p in padded])), put(kern),
            event_par=par, out=tiles)
        hold(_same(got, torch.stack(bases)),
             f"kernel:event_conv_interlaced_tile[{case}]",
             f"interlaced tile path (event_par={par}) diverges from the "
             f"sequential apply_events oracle")
        tiles = put(vmb)
        got = ek.event_conv_cuda_banked(
            tiles, put(_padded_masks(fmaps, e, geom)),
            put(tap_matrix(kern).to(vm0.dtype)[None]), geometry=geom,
            out=tiles)
        hold(_same(got, torch.stack(bases)),
             f"kernel:event_conv_banked[{case}]",
             "banked conv diverges from the sequential apply_events oracle")
        # the event-set builder: a map, its complement and a full one per
        # channel (the capacity truncates them), read through a strided
        # view of a zoned buffer (T, C, B, H, W)
        one = brng.random((2, h, w, c)) < 0.4
        spk = torch.from_numpy(np.stack([one, ~one, np.ones_like(one)]))
        view = put(spk.permute(1, 4, 0, 2, 3).contiguous()).permute(
            2, 0, 3, 4, 1)
        got = aeq_build_cuda(view, e, par, geom)
        hold(all(map(_same, got, aeq_build_ref(spk, e, par, geom))),
             f"kernel:aeq_build[{case}]",
             f"event-set builder (capacity {e}, event_par={par}) diverges "
             f"from build_aeq_batched + segment_pad in the launch layout")
        # the threshold unit, base and emit; a capacity below h*w keeps the
        # rank truncation live
        bias = torch.from_numpy(rng.standard_normal((c,)).astype(np.float32)
                                .astype(dt))
        fired0 = torch.from_numpy((rng.random((h, w, c)) < 0.3)
                                  .astype(np.int8))
        cap = max(1, (h * w) // 2)
        for pool in (3, None):
            where = f"kernel:threshold_pool[{case},pool={pool}]"
            args = dict(v_t=0.0, pool=pool)
            got = threshold_pool(put(vm0), put(bias), put(fired0),
                                 use_kernel=True, **args)
            want = threshold_pool(vm0, bias, fired0, use_kernel=False, **args)
            hold(all(map(_same, got, want)), where,
                 "threshold kernel diverges from the plain version")
            args.update(emit_capacity=cap, emit_geometry=geom)
            got = threshold_pool(put(vm0), put(bias), put(fired0),
                                 use_kernel=True, **args)
            want = threshold_pool(vm0, bias, fired0, use_kernel=False, **args)
            where = f"kernel:threshold_pool_emit[{case},pool={pool}]"
            hold(len(got) == len(want) and all(map(_same, got, want)), where,
                 "fused-emission kernel diverges from the plain version "
                 "(masks/seg_counts not equal)")
            ho = build_fused_handoff(want[2][None, None], cap, geom)
            hold(_same(got[3], ho.masks[0, :, 0].movedim(0, -1)), where,
                 "emitted bank masks differ from the build_fused_handoff "
                 "compaction of the same spike map — the handoff carrier "
                 "would desynchronize from the consumer's contract")
    return rep


def _replay_numpy(vm_p: np.ndarray, coords: np.ndarray, valid: np.ndarray,
                  kern: np.ndarray) -> np.ndarray:
    """Unclamped per-event replay: each valid event adds the rotated kernel
    at its window, saturating int tiles after every event; an
    out-of-tile window raises ``IndexError``."""
    out = vm_p.copy()
    kh, kw = kern.shape[:2]
    k_rot = kern[::-1, ::-1]
    hp, wp = out.shape[:2]
    for (i, j), v in zip(coords, valid):
        if not v:
            continue
        if i < 0 or j < 0 or i + kh > hp or j + kw > wp:
            raise IndexError(f"event ({i}, {j}) patch outside {hp}x{wp}")
        if out.dtype.kind == "f":
            out[i:i + kh, j:j + kw] += k_rot
        else:
            info = np.iinfo(out.dtype)
            wide = out[i:i + kh, j:j + kw].astype(np.int32) + k_rot
            out[i:i + kh, j:j + kw] = np.clip(wide, info.min, info.max)
    return out


def check_checkify(report: Optional[Report] = None) -> Report:
    """The plain datapaths with explicit index and NaN checks on
    ``default_rng(11)`` adversarial inputs (JAX runs them under
    ``checkify``)."""
    from repro_torch.core.event_conv import pad_vm
    from repro_torch.kernels.event_conv.ref import event_conv_ref
    from repro_torch.kernels.threshold_pool.ref import threshold_pool_ref

    rep = report if report is not None else Report()
    rng = np.random.default_rng(11)
    for case, h, w, c, block_e, _par, dt, kk in _sweep():
        geom = ConvGeometry(kk, kk)
        e = 4 * block_e
        coords, valid = _adversarial_queue(h, w, e, rng, geom)
        vm0, kern = _tile_and_kernel(rng, h, w, c, kk, dt, 1)
        vm_p = pad_vm(vm0, geom)
        hp, wp = vm_p.shape[:2]
        where = f"kernel:event_conv_ref[{case}]"
        ev = coords[valid]
        outside = ((ev[:, 0] < 0) | (ev[:, 1] < 0)
                   | (ev[:, 0] + kk > hp) | (ev[:, 1] + kk > wp))
        out = event_conv_ref(vm_p, torch.from_numpy(coords),
                             torch.from_numpy(valid), kern)
        if outside.any():
            rep.flag("kernel_audit", "kernel-checkify", where,
                     f"{int(outside.sum())} valid event patch(es) reach "
                     f"outside the {hp}x{wp} padded tile, e.g. at "
                     f"{tuple(ev[outside][0])}")
        elif not np.array_equal(out.numpy(), _replay_numpy(
                vm_p.numpy(), coords, valid, kern.numpy())):
            rep.flag("kernel_audit", "kernel-checkify", where,
                     "the event gather/scatter differs from the unclamped "
                     "per-event replay of the same queue")
        elif out.is_floating_point() and torch.isnan(out).any():
            rep.flag("kernel_audit", "kernel-checkify", where,
                     "NaN in the float event datapath")
        else:
            rep.proved("kernel-checkify")
        pool = 3
        th, tw = h + (-h % pool), w + (-w % pool)
        dtype = getattr(torch, dt)
        outs = threshold_pool_ref(torch.zeros((th, tw, c), dtype=dtype),
                                  torch.zeros((c,), dtype=dtype),
                                  torch.zeros((th, tw, c), dtype=torch.int8),
                                  v_t=1.0, pool=pool)
        if any(t.is_floating_point() and torch.isnan(t).any() for t in outs):
            rep.flag("kernel_audit", "kernel-checkify",
                     f"kernel:threshold_pool_ref[{case}]",
                     "NaN in the threshold datapath")
        else:
            rep.proved("kernel-checkify")
    return rep


def conv_units(zones: RedZones) -> dict[str, Callable]:
    """The six conv units as ``apply(vm_padded, coords, valid, kernel) ->
    vm_padded`` on CPU tensors of one (Hp, Wp, C) tile and one raw queue,
    each launched through its wrapper on zoned copies (``zones``), in
    place: the sequential gathers on the queue, the interlaced ones (the
    batched unit on both its paths; ``event_par`` 2) on the segment-padded AEQ of the queue's events, the
    banked conv on their carrier."""
    from repro_torch.core.aeq import build_aeq, segment_pad
    from repro_torch.core.event_conv import tap_matrix
    from repro_torch.kernels.event_conv import kernel as ek

    put = zones.put

    def events_map(vm_p, co, va, kern):
        """(geometry, the (H, W) map of the queue's valid events)."""
        geom = ConvGeometry.from_kernel_shape(kern.shape)
        hh, hw = geom.halo
        fmap = torch.zeros((vm_p.shape[0] - 2 * hh, vm_p.shape[1] - 2 * hw),
                           dtype=torch.bool)
        ok = va.to(torch.bool)
        fmap[co[ok, 0].long(), co[ok, 1].long()] = True
        return geom, fmap

    def aeq(vm_p, co, va, kern):
        geom, fmap = events_map(vm_p, co, va, kern)
        return segment_pad(build_aeq(fmap, co.shape[0], geometry=geom), 2,
                           geom)

    def seq(vm_p, co, va, kern):
        tile = put(vm_p)
        return ek.event_conv_cuda(tile, put(co), put(va), put(kern),
                                  out=tile).cpu()

    def seq_batched(vm_p, co, va, kern):
        tiles = put(vm_p[None])
        return ek.event_conv_cuda_batched(
            tiles, put(co[None]), put(va[None]), put(kern),
            out=tiles)[0].cpu()

    def interlaced(vm_p, co, va, kern):
        q = aeq(vm_p, co, va, kern)
        tile = put(vm_p)
        return ek.event_conv_cuda_interlaced(
            tile, put(q.coords), put(q.valid), put(kern), event_par=2,
            out=tile).cpu()

    def interlaced_batched(vm_p, co, va, kern):
        q = aeq(vm_p, co, va, kern)
        tiles = put(vm_p[None])
        return ek.event_conv_cuda_interlaced_batched(
            tiles, put(q.coords[None]), put(q.valid[None]), put(kern),
            event_par=2, out=tiles)[0].cpu()

    def interlaced_tile(vm_p, co, va, kern):
        q = aeq(vm_p, co, va, kern)
        tiles = put(vm_p[None])
        return ek.event_conv_cuda_interlaced_tile(
            tiles, put(q.coords[None]), put(q.valid[None]), put(kern),
            event_par=2, out=tiles)[0].cpu()

    def banked(vm_p, co, va, kern):
        geom, fmap = events_map(vm_p, co, va, kern)
        tiles = put(vm_p[None])
        return ek.event_conv_cuda_banked(
            tiles, put(_padded_masks(fmap[None], fmap.numel(), geom)),
            put(tap_matrix(kern).to(vm_p.dtype)[None]), geometry=geom,
            out=tiles)[0].cpu()

    return {"event_conv_seq": seq_batched, "event_conv_seq_single": seq,
            "event_conv_interlaced": interlaced_batched,
            "event_conv_interlaced_single": interlaced,
            "event_conv_interlaced_tile": interlaced_tile,
            "event_conv_banked": banked}


def check_saturation(apply_fn: Optional[Callable] = None, *,
                     geometry: ConvGeometry = GEOM_3X3,
                     report: Optional[Report] = None,
                     device="cpu") -> Report:
    """int8/int16 saturation-overflow reachability proof.

    The maximum-fan-in configuration: one membrane cell inside the
    footprints of kh*kw events (its full neighbourhood of centres, one
    event per interlace column), every tap maximal, the tile one tap
    below the rail.  Each conv unit (:func:`conv_units` on ``device``, or
    ``apply_fn(vm_padded, coords, valid, kernel) -> vm_padded`` on CPU
    tensors) must clamp at the bound instead of wrapping and equal the
    per-event plain version.
    """
    from repro_torch.core.event_conv import pad_vm
    from repro_torch.kernels.event_conv.ref import event_conv_ref

    rep = report if report is not None else Report()
    zones = RedZones(device, rep)
    units = ({"event_conv": apply_fn} if apply_fn is not None
             else conv_units(zones))
    kh, kw = geometry.window
    hh, hw = geometry.halo
    h = w = 2 * max(kh, kw) + 1
    c = 4
    ci, cj = h // 2, w // 2
    events = [(ci + di, cj + dj)
              for di in range(-hh, hh + 1) for dj in range(-hw, hw + 1)]
    coords = torch.tensor(events, dtype=torch.int32)
    valid = torch.ones((len(events),), dtype=torch.bool)
    ktag = "" if geometry == GEOM_3X3 else f",k={kh}x{kw}"
    for bits, (lo, hi) in _SAT.items():
        dtype = getattr(torch, f"int{bits}")
        tap = hi // (geometry.n_banks + 1) + 1
        vm0 = torch.full((h, w, c), hi - tap, dtype=dtype)  # a tap below
        kern = torch.full((kh, kw, c), tap, dtype=dtype)
        vm_p = pad_vm(vm0, geometry)
        want = event_conv_ref(vm_p, coords, valid, kern).numpy()
        for unit, fn in units.items():
            got = np.asarray(fn(vm_p, coords, valid, kern))
            where = f"kernel:{unit}[int{bits}{ktag}]"
            hot = got[hh + ci, hw + cj]                  # padded centre
            if got.max() > hi or got.min() < lo or got.dtype != want.dtype:
                rep.flag("kernel_audit", "kernel-sat-overflow", where,
                         f"int{bits} accumulation escapes the storage range "
                         f"[{lo}, {hi}] (max={got.max()}, min={got.min()}, "
                         f"{got.dtype}) — the adder wraps instead of "
                         f"saturating")
            elif not (hot == hi).all():
                rep.flag("kernel_audit", "kernel-sat-overflow", where,
                         f"max-fan-in cell ended at {hot} instead of the "
                         f"saturation bound {hi} — the overflow path either "
                         f"wrapped or under-accumulated")
            elif not np.array_equal(got, want):
                rep.flag("kernel_audit", "kernel-sat-overflow", where,
                         "saturating datapath diverges from the per-event "
                         "plain version at the bound")
            else:
                rep.proved("kernel-sat-overflow")
            # widening headroom: one widened add must fit the accumulator
            if 2 * hi + 1 > np.iinfo(np.int32).max:
                rep.flag("kernel_audit", "kernel-sat-overflow", where,
                         f"int{bits} patch+tap exceeds the int32 widened "
                         f"accumulator")
            else:
                rep.proved("kernel-sat-overflow")
            zones.verify(where)
    return rep


def run_kernel_audit(report: Optional[Report] = None, *,
                     device="cuda") -> Report:
    """Every check over the sweep, the wrappers on ``device``.  On a CUDA
    device each kernel of :data:`KERNELS` must count a launch
    (``runtime.LAUNCHES``), or the pass is flagged."""
    rep = report if report is not None else Report()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_kernel_audit(device='cuda') needs a CUDA "
                           "device; pass device='cpu' for the plain versions")
    before = dict(LAUNCHES)
    check_shape_contracts(rep, device=dev)
    check_value_parity(rep, device=dev)
    check_checkify(rep)
    for geom in (ConvGeometry(1, 1), GEOM_3X3, ConvGeometry(5, 5)):
        check_saturation(geometry=geom, report=rep, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for name in KERNELS:
            if LAUNCHES[name] > before[name]:
                rep.proved("kernel-value-parity")
            else:
                rep.flag("kernel_audit", "kernel-value-parity",
                         f"kernel:{name}",
                         "no launch of this CUDA kernel was counted: the "
                         "audit held its plain version against itself")
    return rep
