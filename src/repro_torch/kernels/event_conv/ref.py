"""Plain PyTorch versions of the event-conv kernels.

Semantics: for every valid event (i, j) of a queue, add the
180-degree-rotated (kh, kw, C) kernel into that queue's halo-padded tile
at [i:i+kh, j:j+kw, :] (the halo puts the event at the window centre);
int8/int16 tiles saturate after every event.  The banked kernel takes the
events as padded bank occupancy (the fused-handoff carrier) instead of
queues.  These are what the wrappers in ``kernel.py`` run for CPU
tensors, and what ``chip_smoke.py`` holds the CUDA kernels against on the
card.
"""
from __future__ import annotations

import torch

from repro_torch.core.aeq import column_index
from repro_torch.core.event_conv import (apply_banked_columns_fused, bank_vm,
                                         replay_events_, rotate_kernel,
                                         unbank_vm)
from repro_torch.core.geometry import ConvGeometry


def event_conv_ref(vm_padded: torch.Tensor, coords: torch.Tensor,
                   valid: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """One tile (Hp, Wp, C): coords (E, 2) or (C_in, E, 2), valid (E,) or
    (C_in, E), kernel (kh, kw, C) or (C_in, kh, kw, C)."""
    return event_conv_ref_batched(vm_padded[None], coords[..., None, :, :],
                                  valid[..., None, :], kernel)[0]


def event_conv_ref_batched(vm_padded: torch.Tensor, coords: torch.Tensor,
                           valid: torch.Tensor, kernel: torch.Tensor
                           ) -> torch.Tensor:
    """Q independent queue replays, in queue order (the oracle of
    ``event_conv_cuda_batched``): vm (Q, Hp, Wp, C), coords (Q, E, 2),
    valid (Q, E), kernel (kh, kw, C) shared; or, with a leading input
    channel axis, coords (C_in, Q, E, 2), valid (C_in, Q, E) and kernel
    (C_in, kh, kw, C), replayed channel by channel in order (the JAX
    scheduler's per-channel Pallas calls).  Slots that are invalid in every
    queue of a channel are skipped: they would add zeros."""
    if coords.ndim == 3:
        coords, valid, kernel = coords[None], valid[None], kernel[None]
    vm = vm_padded.clone(memory_format=torch.contiguous_format)
    for ci in range(coords.shape[0]):
        k_rot = rotate_kernel(kernel[ci]).to(vm.dtype)
        steps = valid[ci].to(torch.bool).any(dim=0).nonzero().flatten()
        replay_events_(vm, coords[ci], valid[ci], k_rot, steps)
    return vm


def interlaced_keep(coords: torch.Tensor, valid: torch.Tensor,
                    event_par: int, geometry: ConvGeometry) -> torch.Tensor:
    """Slots the interlaced kernel applies, as a (Q, E) bool mask.

    Per aligned group of ``event_par`` slots: the first valid slot is the
    anchor; when every valid slot shares the anchor's interlace column the
    group is applied as one gather -> add -> scatter, whose windows are
    disjoint except for repeated coordinates, which land once (every copy
    writes the same updated patch).  A mixed group runs in queue order.
    So a slot is applied iff it is valid and not a repeat of an earlier
    valid slot of a column-homogeneous group.
    """
    q, e = valid.shape
    g = e // event_par
    v = valid.to(torch.bool).reshape(q, g, event_par)
    c = coords.reshape(q, g, event_par, 2).long()
    col = column_index(c[..., 0], c[..., 1], geometry)
    first = torch.argmax(v.to(torch.uint8), dim=-1, keepdim=True)
    acol = torch.gather(col, -1, first)
    homog = (~v | (col == acol)).all(dim=-1, keepdim=True)
    same = (c[..., :, None, :] == c[..., None, :, :]).all(dim=-1)  # [p, r]
    earlier = torch.ones(event_par, event_par, dtype=torch.bool,
                         device=v.device).tril(-1)                # r < p
    repeat = (same & earlier & v[..., None, :]).any(dim=-1)
    return (v & ~(homog & repeat)).reshape(q, e)


def event_conv_ref_interlaced_batched(vm_padded: torch.Tensor,
                                      coords: torch.Tensor,
                                      valid: torch.Tensor,
                                      kernel: torch.Tensor, *,
                                      event_par: int) -> torch.Tensor:
    """Oracle of ``event_conv_cuda_interlaced_batched``: the sequential
    replay of the slots :func:`interlaced_keep` applies, input channel by
    input channel.  vm (Q, Hp, Wp, C); coords (Q, E, 2), valid (Q, E),
    kernel (kh, kw, C); or, with a leading input-channel axis, coords
    (C_in, Q, E, 2), valid (C_in, Q, E), kernel (C_in, kh, kw, C).  On
    queues without repeated coordinates (every AEQ) that is the plain
    sequential replay."""
    if coords.ndim == 3:
        coords, valid, kernel = coords[None], valid[None], kernel[None]
    geom = ConvGeometry.from_kernel_shape(kernel.shape[1:])
    c_in, q, e = valid.shape
    keep = interlaced_keep(coords.reshape(c_in * q, e, 2),
                           valid.reshape(c_in * q, e), event_par, geom)
    return event_conv_ref_batched(vm_padded, coords, keep.reshape(c_in, q, e),
                                  kernel)


def event_conv_ref_interlaced(vm_padded: torch.Tensor, coords: torch.Tensor,
                              valid: torch.Tensor, kernel: torch.Tensor, *,
                              event_par: int) -> torch.Tensor:
    """One tile (the oracle of ``event_conv_cuda_interlaced``): vm (Hp,
    Wp, C), coords (E, 2) or (C_in, E, 2), valid (E,) or (C_in, E), kernel
    (kh, kw, C) or (C_in, kh, kw, C)."""
    return event_conv_ref_interlaced_batched(
        vm_padded[None], coords[..., None, :, :], valid[..., None, :], kernel,
        event_par=event_par)[0]


def event_conv_ref_banked(vm_padded: torch.Tensor, masks: torch.Tensor,
                          taps: torch.Tensor, geometry: ConvGeometry
                          ) -> torch.Tensor:
    """Oracle of ``event_conv_cuda_banked``: ``bank_vm``, then
    ``apply_banked_columns_fused`` once per input channel, then
    ``unbank_vm``.  vm (Q, Hp, Wp, C); masks (C_in, Q, n_banks, HBp+2,
    WBp+2) bool; taps (C_in, n_banks, n_banks, C) in vm's dtype.  Returns
    a new tensor."""
    hp, wp = vm_padded.shape[1:3]
    vb = bank_vm(vm_padded, geometry)
    for ci in range(masks.shape[0]):
        vb = apply_banked_columns_fused(vb, masks[ci], taps[ci], geometry)
    return unbank_vm(vb, hp, wp, geometry)
