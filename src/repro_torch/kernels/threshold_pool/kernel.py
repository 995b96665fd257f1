"""Wrappers of the batched threshold-unit CUDA kernels
(``kernels/csrc/threshold_pool.cu``; they replace ``threshold_pool_pallas``
in its base mode and in its emit mode, ``emit_capacity``).

The kernels take the halo-padded membrane tiles with their halo offsets
and update the inner region in place, so the scheduler never copies the
strided inner view out and back.  CPU tensors run the plain version
(``ref.threshold_pool_tile_ref``), which does the same in place.  The
base kernel picks its access width itself: four channels per access
where C % 4 == 0 and every operand's address is aligned, one otherwise
(an odd C, or a view at an odd offset).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.aeq import handoff_shape
from repro_torch.core.geometry import GEOM_3X3, ConvGeometry
from repro_torch.core.threshold import as_vm_scalar
from repro_torch.kernels import runtime

from .ref import threshold_pool_tile_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = runtime.load("threshold_pool")
    if not getattr(lib, "_typed", False):
        lib.threshold_pool_batched.argtypes = (
            [_P] * 5 + [_I] * 7 + [ctypes.c_float, _I, _I, _P])
        lib.threshold_pool_batched.restype = _I
        lib.threshold_pool_emit.argtypes = (
            [_P] * 8 + [_I] * 10 + [ctypes.c_float, _I, _I, _P])
        lib.threshold_pool_emit.restype = _I
        lib.threshold_pool_emit_max_cells.argtypes = []
        lib.threshold_pool_emit_max_cells.restype = _I
        lib._typed = True
    return lib


def _check(vm_padded, bias, fired, pool, halo, outs) -> tuple:
    """Validate the base operands; returns (q, h, w, c, ph, pw)."""
    if vm_padded.ndim != 4 or vm_padded.dtype not in runtime.DTYPE_CODES:
        raise ValueError(f"vm tiles must be (Q, Hp, Wp, C) float32/int16/"
                         f"int8, got {tuple(vm_padded.shape)} {vm_padded.dtype}")
    hh, hw = halo
    q, hp, wp, c = vm_padded.shape
    h, w = hp - 2 * hh, wp - 2 * hw
    if h < 1 or w < 1:
        raise ValueError(f"halo {halo} leaves no inner region in a "
                         f"{hp}x{wp} tile")
    if bias.shape != (c,) or bias.dtype != vm_padded.dtype:
        raise ValueError(f"bias must be ({c},) {vm_padded.dtype}, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if fired.shape != (q, h, w, c) or fired.dtype != torch.bool:
        raise ValueError(f"fired must be ({q}, {h}, {w}, {c}) bool, got "
                         f"{tuple(fired.shape)} {fired.dtype}")
    if pool is not None and pool < 1:
        raise ValueError(f"pool must be >= 1, got {pool}")
    p = pool or 1
    ph, pw = -(-h // p), -(-w // p)
    want = {"fired_out": ((q, h, w, c), torch.bool),
            "pooled_out": ((q, ph, pw, c), torch.bool)}
    for name, t in outs.items():
        shape, dtype = want[name]
        if t is not None and (t.shape != shape or t.dtype != dtype):
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if vm_padded.numel() >= 2**31:  # the kernels' offsets are 32-bit
        raise ValueError(f"vm tiles {tuple(vm_padded.shape)} hold 2**31 "
                         f"elements or more; the threshold kernels take "
                         f"fewer")
    return q, h, w, c, ph, pw


def _require_contiguous(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _vt_args(v_t, dtype) -> tuple[float, int]:
    thr = as_vm_scalar(v_t, dtype)
    return float(thr), (thr if isinstance(thr, int) else 0)


def threshold_pool_cuda_batched(
    vm_padded: torch.Tensor,
    bias: torch.Tensor,
    fired: torch.Tensor,
    *,
    v_t: float,
    pool: Optional[int],
    halo: tuple[int, int] = (0, 0),
    fired_out: Optional[torch.Tensor] = None,
    pooled_out: Optional[torch.Tensor] = None,
):
    """Bias + threshold + m-TTFS indicator + optional OR-pool over Q tiles.

    vm_padded: (Q, H+2hh, W+2hw, C) float32/int16/int8, updated in place
    on its inner region; bias (C,) in vm's dtype; fired (Q, H, W, C) bool.
    ``fired_out`` (may be ``fired`` itself) and ``pooled_out`` receive the
    results when given.  Returns (spikes bool (Q, H, W, C), pooled bool
    (Q, ceil(H/p), ceil(W/p), C) or None without a pool).
    """
    q, h, w, c, ph, pw = _check(vm_padded, bias, fired, pool, halo,
                                {"fired_out": fired_out,
                                 "pooled_out": pooled_out})
    if not runtime.use_kernel(vm_padded, bias, fired):
        spikes, pooled = threshold_pool_tile_ref(vm_padded, bias, fired,
                                                 v_t=v_t, pool=pool, halo=halo)
        if fired_out is not None:
            spikes = fired_out.copy_(spikes)
        if pooled_out is not None and pooled is not None:
            pooled = pooled_out.copy_(pooled)
        return spikes, pooled
    _require_contiguous(vm=vm_padded, bias=bias, fired=fired,
                        fired_out=fired_out, pooled_out=pooled_out)
    if fired_out is None:
        fired_out = torch.empty_like(fired)
    if pool is not None and pooled_out is None:
        pooled_out = torch.empty((q, ph, pw, c), dtype=torch.bool,
                                 device=vm_padded.device)
    lib = _lib()
    status = lib.threshold_pool_batched(
        vm_padded.data_ptr(), bias.data_ptr(), fired.data_ptr(),
        fired_out.data_ptr(),
        pooled_out.data_ptr() if pool is not None else None,
        q, h, w, c, halo[0], halo[1], pool or 1,
        *_vt_args(v_t, vm_padded.dtype),
        runtime.DTYPE_CODES[vm_padded.dtype], runtime.stream_ptr(vm_padded))
    runtime.LAUNCHES["threshold_pool"] += 1
    runtime.check(lib, status, "threshold_pool_batched")
    return fired_out, (pooled_out if pool is not None else None)


def threshold_pool_cuda_emit(
    vm_padded: torch.Tensor,
    bias: torch.Tensor,
    fired: torch.Tensor,
    *,
    v_t: float,
    pool: Optional[int],
    halo: tuple[int, int] = (0, 0),
    emit_capacity: int,
    emit_geometry: ConvGeometry = GEOM_3X3,
    fired_out: Optional[torch.Tensor] = None,
    pooled_out: Optional[torch.Tensor] = None,
    masks_out: Optional[torch.Tensor] = None,
    count_out: Optional[torch.Tensor] = None,
    seg_counts_out: Optional[torch.Tensor] = None,
):
    """:func:`threshold_pool_cuda_batched` with fused spike emission.

    Besides the base outputs, the pooled map (the spikes without a pool)
    of every (tile q, channel c) leaves the unit compacted into the
    consumer's carrier under ``emit_geometry``, truncated to
    ``emit_capacity`` events in interlace order.  Returns (spikes, pooled
    or None, masks bool (C, Q, n_banks, HBp+2, WBp+2), count int32 (C, Q)
    spike demand before truncation, seg_counts int32 (C, Q, n_banks)
    kept events per interlace column).  ``masks_out`` may be the
    contiguous slab ``FusedHandoff.masks[t, c0:c0+C]``; every cell of it,
    the zero ring included, is written on each launch.
    """
    q, h, w, c, ph, pw = _check(vm_padded, bias, fired, pool, halo,
                                {"fired_out": fired_out,
                                 "pooled_out": pooled_out})
    if emit_capacity < 1:
        raise ValueError(f"emit_capacity must be >= 1, got {emit_capacity}")
    emit_geometry.require_event_compatible("threshold_pool_cuda_emit")
    nb = emit_geometry.n_banks
    mshape = (c, q) + handoff_shape(1, 1, 1, (ph, pw), emit_geometry)[3:]
    for name, t, shape, dtype in (
            ("masks_out", masks_out, mshape, torch.bool),
            ("count_out", count_out, (c, q), torch.int32),
            ("seg_counts_out", seg_counts_out, (c, q, nb), torch.int32)):
        if t is not None and (t.shape != shape or t.dtype != dtype):
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if not runtime.use_kernel(vm_padded, bias, fired):
        res = threshold_pool_tile_ref(vm_padded, bias, fired, v_t=v_t,
                                      pool=pool, halo=halo,
                                      emit_capacity=emit_capacity,
                                      emit_geometry=emit_geometry)
        outs = (fired_out, pooled_out, masks_out, count_out, seg_counts_out)
        return tuple(r if o is None or r is None else o.copy_(r)
                     for r, o in zip(res, outs))
    _require_contiguous(vm=vm_padded, bias=bias, fired=fired,
                        fired_out=fired_out, pooled_out=pooled_out,
                        masks_out=masks_out, count_out=count_out,
                        seg_counts_out=seg_counts_out)
    dev = vm_padded.device
    if fired_out is None:
        fired_out = torch.empty_like(fired)
    if pool is not None and pooled_out is None:
        pooled_out = torch.empty((q, ph, pw, c), dtype=torch.bool, device=dev)
    if masks_out is None:
        masks_out = torch.empty(mshape, dtype=torch.bool, device=dev)
    if count_out is None:
        count_out = torch.empty((c, q), dtype=torch.int32, device=dev)
    if seg_counts_out is None:
        seg_counts_out = torch.empty((c, q, nb), dtype=torch.int32,
                                     device=dev)
    lib = _lib()
    kh, kw = emit_geometry.kh, emit_geometry.kw
    cells = nb * -(-ph // kh) * -(-pw // kw)
    if cells > lib.threshold_pool_emit_max_cells():
        raise ValueError(f"emission from a {ph}x{pw} map walks {cells} "
                         f"interlace cells per slab, over the "
                         f"{lib.threshold_pool_emit_max_cells()} one "
                         f"thread block cluster takes")
    status = lib.threshold_pool_emit(
        vm_padded.data_ptr(), bias.data_ptr(), fired.data_ptr(),
        fired_out.data_ptr(),
        pooled_out.data_ptr() if pool is not None else None,
        masks_out.data_ptr(), count_out.data_ptr(), seg_counts_out.data_ptr(),
        q, h, w, c, halo[0], halo[1], pool or 1, kh, kw, emit_capacity,
        *_vt_args(v_t, vm_padded.dtype),
        runtime.DTYPE_CODES[vm_padded.dtype], runtime.stream_ptr(vm_padded))
    runtime.LAUNCHES["threshold_pool_emit"] += 1
    runtime.check(lib, status, "threshold_pool_emit")
    return (fired_out, pooled_out if pool is not None else None, masks_out,
            count_out, seg_counts_out)
