"""Public wrapper of the threshold unit (port of
``repro.kernels.threshold_pool.ops``): validates, pads H/W to the pool
window with a fill that never spikes, dispatches kernel vs plain version,
crops.  The TPU's lane padding of C is gone: a CUDA thread owns one
channel, so any C works."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.geometry import GEOM_3X3, ConvGeometry

from .kernel import threshold_pool_cuda_batched, threshold_pool_cuda_emit
from .ref import threshold_pool_ref

_NEG = {torch.float32: -3e38, torch.int8: -128, torch.int16: -32768}


def threshold_pool(
    vm: torch.Tensor,
    bias: torch.Tensor,
    fired: torch.Tensor,
    *,
    v_t: float,
    pool: Optional[int] = None,
    use_kernel: bool = True,
    emit_capacity: Optional[int] = None,
    emit_geometry: ConvGeometry = GEOM_3X3,
):
    """Fused bias + threshold + m-TTFS indicator + optional OR-max-pool.

    vm: (H, W, C) or (Q, H, W, C); bias: (C,); fired: bool/int8 like vm.
    Returns (vm_out, fired_out bool, spikes_out bool — the fired map, or
    the pooled (ceil(H/p), ceil(W/p)) map with a pool).

    ``emit_capacity`` turns on fused spike emission: two more outputs in
    the JAX layout, masks bool (n_banks, HBp+2, WBp+2, C) and seg_counts
    int32 (n_banks, C) (with a leading Q for stacked tiles) — spikes_out
    compacted into the next layer's fused-handoff carrier under
    ``emit_geometry``.
    """
    if vm.ndim not in (3, 4):
        raise ValueError(f"vm must be (H, W, C) or (Q, H, W, C), got shape "
                         f"{tuple(vm.shape)}")
    if vm.dtype not in _NEG:
        supported = ", ".join(str(d) for d in _NEG)
        raise ValueError(f"unsupported vm dtype {vm.dtype}; expected one of "
                         f"{supported}")
    single = vm.ndim == 3
    c = vm.shape[-1]
    if bias.shape != (c,):
        raise ValueError(f"bias must have shape ({c},) to match vm channels, "
                         f"got {tuple(bias.shape)}")
    if fired.shape != vm.shape:
        raise ValueError(f"fired shape {tuple(fired.shape)} must match vm "
                         f"shape {tuple(vm.shape)}")
    if pool is not None and pool < 1:
        raise ValueError(f"pool must be >= 1, got {pool}")
    if emit_capacity is not None and emit_capacity < 1:
        raise ValueError(f"emit_capacity must be >= 1, got {emit_capacity}")
    if single:
        vm, fired = vm[None], fired[None]
    q, h, w, _ = vm.shape
    pw_ = pool if pool is not None else 1
    hp, wp = h + (-h % pw_), w + (-w % pw_)
    # padded cells must never spike
    vm_p = torch.full((q, hp, wp, c), _NEG[vm.dtype], dtype=vm.dtype,
                      device=vm.device)
    vm_p[:, :h, :w] = vm
    fired_p = torch.zeros((q, hp, wp, c), dtype=torch.bool, device=vm.device)
    fired_p[:, :h, :w] = fired != 0
    b = bias.to(vm.dtype)
    emitted = ()
    if use_kernel and emit_capacity is not None:
        spikes, pooled, masks, _, seg = threshold_pool_cuda_emit(
            vm_p, b, fired_p, v_t=v_t, pool=pool,
            emit_capacity=emit_capacity, emit_geometry=emit_geometry)
        vm_out = vm_p
        # carrier layout (C, Q, ...) -> the JAX layout (Q, ..., C)
        emitted = (masks.permute(1, 2, 3, 4, 0), seg.permute(1, 2, 0))
    elif use_kernel:
        spikes, pooled = threshold_pool_cuda_batched(vm_p, b, fired_p,
                                                     v_t=v_t, pool=pool)
        vm_out = vm_p
    else:
        vm_out, spikes, pooled, *emitted = threshold_pool_ref(
            vm_p, b, fired_p, v_t=v_t, pool=pool,
            emit_capacity=emit_capacity, emit_geometry=emit_geometry)
        if emitted:
            emitted = (emitted[0] != 0, emitted[1])
    vm_out = vm_out[:, :h, :w]
    fired_out = spikes[:, :h, :w] != 0
    if pool is None:
        spikes_out = fired_out
    else:
        spikes_out = pooled[:, :-(-h // pool), :-(-w // pool)] != 0
    out = (vm_out, fired_out, spikes_out) + tuple(emitted)
    return tuple(x[0] for x in out) if single else out
