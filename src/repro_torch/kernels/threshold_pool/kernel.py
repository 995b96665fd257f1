"""Wrapper of the batched threshold-unit CUDA kernel
(``kernels/csrc/threshold_pool.cu``; replaces ``threshold_pool_pallas`` in
its base mode, without fused emission).

The kernel takes the halo-padded membrane tiles with their halo offsets
and updates the inner region in place, so the scheduler never copies the
strided inner view out and back.  CPU tensors run the plain version
(``ref.threshold_pool_tile_ref``), which does the same in place.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

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
        lib._typed = True
    return lib


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
    for name, t, shape in (("fired_out", fired_out, (q, h, w, c)),
                           ("pooled_out", pooled_out, (q, ph, pw, c))):
        if t is not None and (t.shape != shape or t.dtype != torch.bool):
            raise ValueError(f"{name} must be {shape} bool, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if not runtime.use_kernel(vm_padded, bias, fired):
        spikes, pooled = threshold_pool_tile_ref(vm_padded, bias, fired,
                                                 v_t=v_t, pool=pool, halo=halo)
        if fired_out is not None:
            spikes = fired_out.copy_(spikes)
        if pooled_out is not None and pooled is not None:
            pooled = pooled_out.copy_(pooled)
        return spikes, pooled
    for name, t in (("vm", vm_padded), ("bias", bias), ("fired", fired),
                    ("fired_out", fired_out), ("pooled_out", pooled_out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if fired_out is None:
        fired_out = torch.empty_like(fired)
    if pool is not None and pooled_out is None:
        pooled_out = torch.empty((q, ph, pw, c), dtype=torch.bool,
                                 device=vm_padded.device)
    lib = _lib()
    thr = as_vm_scalar(v_t, vm_padded.dtype)
    status = lib.threshold_pool_batched(
        vm_padded.data_ptr(), bias.data_ptr(), fired.data_ptr(),
        fired_out.data_ptr(),
        pooled_out.data_ptr() if pool is not None else None,
        q, h, w, c, hh, hw, p, float(thr),
        thr if isinstance(thr, int) else 0,
        runtime.DTYPE_CODES[vm_padded.dtype], runtime.stream_ptr(vm_padded))
    runtime.LAUNCHES["threshold_pool"] += 1
    runtime.check(lib, status, "threshold_pool_batched")
    return fired_out, (pooled_out if pool is not None else None)
