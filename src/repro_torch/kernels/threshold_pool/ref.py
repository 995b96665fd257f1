"""Plain PyTorch versions of the threshold unit (port of
``repro.kernels.threshold_pool.ref``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.aeq import interlace, place_padded_banks, ranked_keep
from repro_torch.core.geometry import GEOM_3X3, ConvGeometry
from repro_torch.core.quantization import SAT_RANGE
from repro_torch.core.threshold import as_vm_scalar, or_pool


def _bias_add(vm: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    b = bias.to(vm.dtype)
    sat = SAT_RANGE.get(vm.dtype)
    if sat is None:
        return vm + b
    return (vm.to(torch.int32) + b.to(torch.int32)).clamp(*sat).to(vm.dtype)


def emit_banked(spikes_map: torch.Tensor, *, capacity: int,
                geometry: ConvGeometry = GEOM_3X3
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused spike emission: bank an output spike map as it leaves the
    threshold unit.

    spikes_map: (..., H', W', C) bool/int8, the unit's (post-pool) output.
    Returns (masks (..., n_banks, HBp+2, WBp+2, C) bool, seg_counts
    (..., n_banks, C) int32): per channel, the next layer's fused-handoff
    occupancy under ``geometry`` (the consumer's window), truncated to
    ``capacity`` by :func:`aeq.ranked_keep`, and the kept events per
    interlace column.  Equal to ``aeq.build_fused_handoff`` over the same
    map.
    """
    sp = spikes_map != 0
    h, w = sp.shape[-3:-1]
    il = interlace(sp.movedim(-1, -3), geometry)   # (..., C, nb, HB, WB)
    kept_il, _, seg_counts = ranked_keep(il, capacity, (h, w))
    masks = place_padded_banks(kept_il, (h, w), geometry)
    return masks.movedim(-4, -1), seg_counts.movedim(-2, -1)


def threshold_pool_ref(vm: torch.Tensor, bias: torch.Tensor,
                       fired: torch.Tensor, *, v_t: float,
                       pool: Optional[int],
                       emit_capacity: Optional[int] = None,
                       emit_geometry: ConvGeometry = GEOM_3X3):
    """(..., H, W, C) potentials; H and W multiples of ``pool``.

    Returns (vm_new, spikes int8 (..., H, W, C), pooled int8
    (..., H/p, W/p, C)); without a pool the third output is the spikes.
    With ``emit_capacity`` also (masks int8 (..., n_banks, HBp+2, WBp+2,
    C), seg_counts int32 (..., n_banks, C)) from :func:`emit_banked` of
    the pooled map.
    """
    vm_new = _bias_add(vm, bias)
    spikes = (vm_new > as_vm_scalar(v_t, vm.dtype)) | (fired != 0)
    if pool is not None:
        *lead, h, w, c = spikes.shape
        s = spikes.reshape(*lead, h // pool, pool, w // pool, pool, c)
        pooled = s.any(dim=-2).any(dim=-3)
    else:
        pooled = spikes
    out = (vm_new, spikes.to(torch.int8), pooled.to(torch.int8))
    if emit_capacity is None:
        return out
    masks, seg_counts = emit_banked(pooled, capacity=emit_capacity,
                                    geometry=emit_geometry)
    return out + (masks.to(torch.int8), seg_counts)


def threshold_pool_tile_ref(vm_padded: torch.Tensor, bias: torch.Tensor,
                            fired: torch.Tensor, *, v_t: float,
                            pool: Optional[int], halo: tuple[int, int],
                            emit_capacity: Optional[int] = None,
                            emit_geometry: ConvGeometry = GEOM_3X3):
    """The function of the CUDA kernels: (Q, H+2hh, W+2hw, C) tiles updated
    in place on their inner region; returns (spikes bool (Q, H, W, C),
    pooled bool (Q, ceil(H/p), ceil(W/p), C) or None).  The ragged pool
    edge counts only real cells, like the scheduler's pad-with-False
    pool.

    With ``emit_capacity`` (the emit kernel) it returns three more
    outputs, in the carrier's channel-major layout: masks bool
    (C, Q, n_banks, HBp+2, WBp+2), count int32 (C, Q) — the spike demand
    before truncation — and seg_counts int32 (C, Q, n_banks), all of the
    pooled map (the spikes without a pool).
    """
    hh, hw = halo
    q, hp, wp, c = vm_padded.shape
    inner = vm_padded[:, hh:hp - hh, hw:wp - hw]
    vm_new, spikes, _ = threshold_pool_ref(inner, bias, fired, v_t=v_t,
                                           pool=None)
    inner.copy_(vm_new)
    spikes = spikes.to(torch.bool)
    pooled = (None if pool is None
              else or_pool(spikes.movedim(-1, 1), pool).movedim(1, -1))
    if emit_capacity is None:
        return spikes, pooled
    out_map = spikes if pooled is None else pooled
    masks, seg_counts = emit_banked(out_map, capacity=emit_capacity,
                                    geometry=emit_geometry)
    count = out_map.sum(dim=(1, 2), dtype=torch.int32)         # (Q, C)
    return (spikes, pooled, masks.permute(4, 0, 1, 2, 3).contiguous(),
            count.T.contiguous(), seg_counts.permute(2, 0, 1).contiguous())
