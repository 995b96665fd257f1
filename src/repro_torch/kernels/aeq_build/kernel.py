"""Wrapper of the event-set builder (``kernels/csrc/aeq_build.cu``): dense
binary spike maps into the conv unit's segment-padded interlaced queues,
already in its launch layout.  It replaces no Pallas kernel (the JAX
package builds its queues with jnp); it replaces the torch sort, scans
and scatter of ``aeq.build_aeq_batched`` plus ``aeq.segment_pad``.

CPU tensors run the plain version (``ref.aeq_build_ref``); a CUDA tensor
launches the kernel or the wrapper raises.  The launch reads the spikes
through their strides (any view), allocates its outputs, runs on the
current stream without synchronising and counts itself in
``runtime.LAUNCHES["aeq_build"]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.aeq import interlaced_capacity
from repro_torch.core.geometry import GEOM_3X3, ConvGeometry
from repro_torch.kernels import runtime

from .ref import aeq_build_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = runtime.load("aeq_build")
    if not getattr(lib, "_typed", False):
        lib.aeq_build.argtypes = ([_P] * 4 + [_I] * 5 + [_L] * 5 + [_I] * 5
                                  + [_P])
        lib.aeq_build.restype = _I
        lib.aeq_build_smem_budget.argtypes = []
        lib.aeq_build_smem_budget.restype = _I
        lib._typed = True
    return lib


def _check(spikes, capacity: int, event_par: int) -> None:
    if not isinstance(spikes, torch.Tensor) or spikes.ndim != 5:
        raise ValueError(f"spikes must be a (B, T, H, W, C_in) tensor, got "
                         f"{getattr(spikes, 'shape', type(spikes).__name__)}")
    if spikes.dtype != torch.bool:
        raise ValueError(f"spikes must be bool, got {spikes.dtype}")
    h, w = spikes.shape[2:4]
    if h < 1 or w < 1:
        raise ValueError(f"spike maps must be at least 1x1, got {h}x{w}")
    if capacity < 0 or event_par < 1:
        raise ValueError(f"capacity must be >= 0 and event_par >= 1, got "
                         f"{capacity} and {event_par}")


def aeq_build_cuda(spikes: torch.Tensor, capacity: int, event_par: int,
                   geometry: ConvGeometry = GEOM_3X3, *,
                   coords_out: Optional[torch.Tensor] = None,
                   valid_out: Optional[torch.Tensor] = None,
                   count_out: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The queues of every (t, b, c_in) map of ``spikes`` (B, T, H, W, C_in)
    bool: coords (T, C_in, B, cap_pad, 2) int32 and valid (T, C_in, B,
    cap_pad) bool, contiguous, in interlace order, truncated at
    ``capacity`` and, for ``event_par`` > 1, segment-padded
    (``cap_pad = aeq.interlaced_capacity(capacity, event_par)``; else
    ``capacity``), and count (T, B, C_in) int32, the demand.  The
    ``*_out`` tensors, where given, receive them (every element is
    written)."""
    _check(spikes, capacity, event_par)
    b, t, h, w, c = spikes.shape
    cap_pad = interlaced_capacity(capacity, event_par, geometry.n_banks)
    outs = (coords_out, valid_out, count_out)
    for name, o, shape, dtype in (
            ("coords_out", coords_out, (t, c, b, cap_pad, 2), torch.int32),
            ("valid_out", valid_out, (t, c, b, cap_pad), torch.bool),
            ("count_out", count_out, (t, b, c), torch.int32)):
        if o is not None and (o.shape != shape or o.dtype != dtype
                              or not o.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} {dtype}, "
                             f"got {tuple(o.shape)} {o.dtype}")
    if not runtime.use_kernel(spikes, *(o for o in outs if o is not None)):
        res = aeq_build_ref(spikes, capacity, event_par, geometry)
        return tuple(r if o is None else o.copy_(r)
                     for r, o in zip(res, outs))
    kh, kw = geometry.kh, geometry.kw
    lib = _lib()
    words = -(-(-(-h // kh) * -(-w // kw)) // 32)
    if 4 * geometry.n_banks * words > lib.aeq_build_smem_budget():
        raise ValueError(f"a {h}x{w} map stages {4 * geometry.n_banks * words}"
                         f" bytes of bits per channel, over the "
                         f"{lib.aeq_build_smem_budget()} a CTA holds")
    if t * b * c >= 2**31:
        raise ValueError(f"{t * b * c} queues: the builder takes fewer than "
                         f"2**31")
    dev = spikes.device
    coords = coords_out if coords_out is not None else torch.empty(
        (t, c, b, cap_pad, 2), dtype=torch.int32, device=dev)
    valid = valid_out if valid_out is not None else torch.empty(
        (t, c, b, cap_pad), dtype=torch.bool, device=dev)
    count = count_out if count_out is not None else torch.empty(
        (t, b, c), dtype=torch.int32, device=dev)
    if coords.data_ptr() % 8:
        raise ValueError("coords_out must be 8-byte aligned (int32 pairs)")
    status = lib.aeq_build(
        spikes.data_ptr(), coords.data_ptr(), valid.data_ptr(),
        count.data_ptr(), b, t, h, w, c, *spikes.stride(), kh, kw,
        min(capacity, h * w), event_par, cap_pad, runtime.stream_ptr(spikes))
    runtime.LAUNCHES["aeq_build"] += 1
    runtime.check(lib, status, "aeq_build")
    return coords, valid, count
