"""Wrappers of the batched event-conv CUDA kernels:
``kernels/csrc/event_conv.cu`` (they replace ``event_conv_pallas_batched``
and ``event_conv_pallas_interlaced_batched``) and
``kernels/csrc/event_conv_banked.cu`` (the counterpart of the jnp
``apply_banked_columns_fused``, the conv unit of the banked and
fused-handoff variants).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``ref.py``) for CPU tensors.  It checks device, dtype, shape and
contiguity first, launches on the current stream without synchronising,
and counts the launch in ``runtime.LAUNCHES``.  The tile is updated in
place when ``out`` is the input tile (the scheduler does this, as the
Pallas kernels aliased their input); otherwise a fresh tensor is
returned.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.geometry import ConvGeometry
from repro_torch.kernels import runtime

from .ref import (event_conv_ref_banked, event_conv_ref_batched,
                  event_conv_ref_interlaced_batched)

#: shared memory one CTA may use on Hopper (227 KB), less a margin for
#: the kernel's static shared variables
SMEM_PER_BLOCK = 232448
_SMEM_LIMIT = SMEM_PER_BLOCK - 1024

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = runtime.load("event_conv")
    if not getattr(lib, "_typed", False):
        lib.event_conv_seq_batched.argtypes = [_P] * 5 + [_I] * 8 + [_P]
        lib.event_conv_seq_batched.restype = _I
        lib.event_conv_interlaced_batched.argtypes = [_P] * 5 + [_I] * 9 + [_P]
        lib.event_conv_interlaced_batched.restype = _I
        lib.event_conv_smem_bytes.argtypes = [_I] * 8
        lib.event_conv_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _banked_lib():
    lib = runtime.load("event_conv_banked")
    if not getattr(lib, "_typed", False):
        lib.event_conv_banked.argtypes = [_P] * 3 + [_I] * 10 + [_P]
        lib.event_conv_banked.restype = _I
        lib._typed = True
    return lib


def _check(vm_padded, coords, valid, kernel, out, event_par: int) -> None:
    if vm_padded.ndim != 4:
        raise ValueError(f"vm tiles must be (Q, Hp, Wp, C), got shape "
                         f"{tuple(vm_padded.shape)}")
    if vm_padded.dtype not in runtime.DTYPE_CODES:
        raise ValueError(f"unsupported vm dtype {vm_padded.dtype}; expected "
                         f"float32, int16 or int8")
    q, hp, wp, c = vm_padded.shape
    if coords.ndim != 3 or coords.shape[-1] != 2 or coords.shape[0] != q:
        raise ValueError(
            f"queue count mismatch: vm has {q} tiles, coords describe "
            f"{coords.shape[0] if coords.ndim else 0} queues (coords must be "
            f"(Q, E, 2), got {tuple(coords.shape)})")
    if coords.dtype != torch.int32:
        raise ValueError(f"coords must be int32, got {coords.dtype}")
    if valid.shape != coords.shape[:-1]:
        raise ValueError(f"valid bits shape {tuple(valid.shape)} does not "
                         f"match event coords {tuple(coords.shape)}")
    if valid.dtype not in (torch.bool, torch.int8, torch.uint8):
        raise ValueError(f"valid must be bool/int8/uint8, got {valid.dtype}")
    if kernel.ndim != 3 or kernel.shape[-1] != c:
        raise ValueError(f"kernel must be (kh, kw, {c}), got "
                         f"{tuple(kernel.shape)}")
    if kernel.dtype != vm_padded.dtype:
        raise ValueError(f"kernel dtype {kernel.dtype} must match vm dtype "
                         f"{vm_padded.dtype} (cast with .to(vm.dtype))")
    kh, kw = kernel.shape[:2]
    if kh % 2 == 0 or kw % 2 == 0 or hp < kh or wp < kw:
        raise ValueError(f"kernel window ({kh}, {kw}) must be odd and fit "
                         f"the halo-padded tile ({hp}, {wp})")
    e = coords.shape[1]
    if event_par > 1 and e % event_par:
        raise ValueError(
            f"event stream length E={e} must be a multiple of event_par="
            f"{event_par}: go through ops.event_conv_batched or "
            f"aeq.segment_pad, which pad the queues for you")
    if out is not None and (out.shape != vm_padded.shape
                            or out.dtype != vm_padded.dtype
                            or out.device != vm_padded.device):
        raise ValueError("out must match vm in shape, dtype and device")


def _launch(entry: str, vm_padded, coords, valid, kernel, out, event_par):
    for name, t in (("vm", vm_padded), ("coords", coords), ("valid", valid),
                    ("kernel", kernel), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    q, hp, wp, c = vm_padded.shape
    e = coords.shape[1]
    kh, kw = kernel.shape[:2]
    lib = _lib()
    item = vm_padded.element_size()
    smem = lib.event_conv_smem_bytes(e, hp, wp, c, kh, kw, event_par, item)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"one queue's tile ({hp}x{wp}x{c} x {item} B) plus its {e}-slot "
            f"queue needs {smem} B of shared memory, over the "
            f"{_SMEM_LIMIT} B a CTA may use: lower the plan's channel_block")
    args = [vm_padded.data_ptr(), out.data_ptr(), coords.data_ptr(),
            valid.data_ptr(), kernel.data_ptr(), q, e, hp, wp, c, kh, kw]
    if event_par > 1:
        args.append(event_par)
    args += [runtime.DTYPE_CODES[vm_padded.dtype], runtime.stream_ptr(vm_padded)]
    status = getattr(lib, entry)(*args)
    runtime.LAUNCHES["event_conv_interlaced" if event_par > 1
                     else "event_conv_seq"] += 1
    runtime.check(lib, status, entry)
    return out


def event_conv_cuda_batched(vm_padded: torch.Tensor, coords: torch.Tensor,
                            valid: torch.Tensor, kernel: torch.Tensor, *,
                            out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Apply Q event queues, each in queue order, to Q halo-padded tiles.

    vm_padded: (Q, Hp, Wp, C) float32/int16/int8; coords (Q, E, 2) int32
    in unpadded space; valid (Q, E) bool; kernel (kh, kw, C) unrotated, in
    vm's dtype, shared by every queue.  Returns the updated tiles (``out``
    when given; ``out=vm_padded`` updates in place).
    """
    _check(vm_padded, coords, valid, kernel, out, 1)
    if not runtime.use_kernel(vm_padded, coords, valid, kernel):
        res = event_conv_ref_batched(vm_padded, coords, valid, kernel)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(vm_padded)
    return _launch("event_conv_seq_batched", vm_padded, coords, valid,
                   kernel, out, 1)


def event_conv_cuda_interlaced_batched(vm_padded: torch.Tensor,
                                       coords: torch.Tensor,
                                       valid: torch.Tensor,
                                       kernel: torch.Tensor, *,
                                       event_par: int,
                                       out: Optional[torch.Tensor] = None
                                       ) -> torch.Tensor:
    """Interlace-parallel :func:`event_conv_cuda_batched`: ``event_par``
    same-column events per step.

    Same contract, with E a multiple of ``event_par``.  Feed it
    segment-padded queues (``aeq.segment_pad``), where every aligned group
    is column-homogeneous; a mixed group runs in queue order.  Bit-exact
    vs the sequential kernel on any queue without repeated coordinates.
    """
    if event_par < 2:
        raise ValueError(
            f"event_par={event_par}: the interlaced kernel needs >= 2 events "
            f"per group (use event_conv_cuda_batched for the sequential "
            f"schedule)")
    _check(vm_padded, coords, valid, kernel, out, event_par)
    if not runtime.use_kernel(vm_padded, coords, valid, kernel):
        res = event_conv_ref_interlaced_batched(vm_padded, coords, valid,
                                                kernel, event_par=event_par)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(vm_padded)
    return _launch("event_conv_interlaced_batched", vm_padded, coords, valid,
                   kernel, out, event_par)


def event_conv_cuda_banked(vm_padded: torch.Tensor, masks: torch.Tensor,
                           taps: torch.Tensor, *, geometry: ConvGeometry,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Apply every input channel's events, given as padded bank occupancy,
    to Q halo-padded tiles in one launch.

    vm_padded (Q, Hp, Wp, C) float32/int16/int8; masks (C_in, Q, n_banks,
    HB+2, WB+2) bool with HB, WB = ceil(Hp/kh), ceil(Wp/kw) — one time
    step of a ``FusedHandoff`` carrier; taps (C_in, n_banks, n_banks, C)
    in vm's dtype (``event_conv.tap_matrix`` per input channel).  Returns
    the updated tiles (``out=vm_padded`` updates in place).
    """
    if vm_padded.ndim != 4 or vm_padded.dtype not in runtime.DTYPE_CODES:
        raise ValueError(f"vm tiles must be (Q, Hp, Wp, C) float32/int16/"
                         f"int8, got {tuple(vm_padded.shape)} {vm_padded.dtype}")
    q, hp, wp, c = vm_padded.shape
    kh, kw = geometry.window
    nb = geometry.n_banks
    c_in = masks.shape[0] if masks.ndim else 0
    want = (c_in, q, nb, -(-hp // kh) + 2, -(-wp // kw) + 2)
    if tuple(masks.shape) != want or masks.dtype != torch.bool:
        raise ValueError(f"masks must be {want} bool for {q} tiles of "
                         f"{hp}x{wp} under the {kh}x{kw} geometry, got "
                         f"{tuple(masks.shape)} {masks.dtype}")
    if tuple(taps.shape) != (c_in, nb, nb, c) or taps.dtype != vm_padded.dtype:
        raise ValueError(f"taps must be ({c_in}, {nb}, {nb}, {c}) "
                         f"{vm_padded.dtype}, got {tuple(taps.shape)} "
                         f"{taps.dtype}")
    if out is not None and (out.shape != vm_padded.shape
                            or out.dtype != vm_padded.dtype
                            or out.device != vm_padded.device):
        raise ValueError("out must match vm in shape, dtype and device")
    if not runtime.use_kernel(vm_padded, masks, taps):
        res = event_conv_ref_banked(vm_padded, masks, taps, geometry)
        return res if out is None else out.copy_(res)
    for name, t in (("vm", vm_padded), ("masks", masks), ("taps", taps),
                    ("out", out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out is None:
        out = vm_padded.clone()
    elif out.data_ptr() != vm_padded.data_ptr():
        out.copy_(vm_padded)
    lib = _banked_lib()
    status = lib.event_conv_banked(
        out.data_ptr(), masks.data_ptr(), taps.data_ptr(), q, hp, wp, c,
        c_in, kh, kw, want[3], want[4], runtime.DTYPE_CODES[vm_padded.dtype],
        runtime.stream_ptr(vm_padded))
    runtime.LAUNCHES["event_conv_banked"] += 1
    runtime.check(lib, status, "event_conv_banked")
    return out
