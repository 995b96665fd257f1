"""Plain PyTorch versions of the threshold unit (port of
``repro.kernels.threshold_pool.ref`` without ``emit_capacity``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantization import SAT_RANGE
from repro_torch.core.threshold import as_vm_scalar, or_pool


def _bias_add(vm: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    b = bias.to(vm.dtype)
    sat = SAT_RANGE.get(vm.dtype)
    if sat is None:
        return vm + b
    return (vm.to(torch.int32) + b.to(torch.int32)).clamp(*sat).to(vm.dtype)


def threshold_pool_ref(vm: torch.Tensor, bias: torch.Tensor,
                       fired: torch.Tensor, *, v_t: float,
                       pool: Optional[int]):
    """(..., H, W, C) potentials; H and W multiples of ``pool``.

    Returns (vm_new, spikes int8 (..., H, W, C), pooled int8
    (..., H/p, W/p, C)); without a pool the third output is the spikes.
    """
    vm_new = _bias_add(vm, bias)
    spikes = (vm_new > as_vm_scalar(v_t, vm.dtype)) | (fired != 0)
    if pool is not None:
        *lead, h, w, c = spikes.shape
        s = spikes.reshape(*lead, h // pool, pool, w // pool, pool, c)
        pooled = s.any(dim=-2).any(dim=-3)
    else:
        pooled = spikes
    return vm_new, spikes.to(torch.int8), pooled.to(torch.int8)


def threshold_pool_tile_ref(vm_padded: torch.Tensor, bias: torch.Tensor,
                            fired: torch.Tensor, *, v_t: float,
                            pool: Optional[int], halo: tuple[int, int]):
    """The function of the CUDA kernel: (Q, H+2hh, W+2hw, C) tiles updated
    in place on their inner region; returns (spikes bool (Q, H, W, C),
    pooled bool (Q, ceil(H/p), ceil(W/p), C) or None).  The ragged pool
    edge counts only real cells, like the scheduler's pad-with-False
    pool."""
    hh, hw = halo
    q, hp, wp, c = vm_padded.shape
    inner = vm_padded[:, hh:hp - hh, hw:wp - hw]
    vm_new, spikes, _ = threshold_pool_ref(inner, bias, fired, v_t=v_t,
                                           pool=None)
    inner.copy_(vm_new)
    spikes = spikes.to(torch.bool)
    if pool is None:
        return spikes, None
    return spikes, or_pool(spikes.movedim(-1, 1), pool).movedim(1, -1)
