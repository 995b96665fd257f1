"""Public wrappers around the event-conv kernels, plus the event-pipeline
sizing rules (port of ``repro.kernels.event_conv.ops``).

``event_conv`` (one queue) and ``event_conv_batched`` (a stack of
queues) halo-pad, segment-pad for ``event_par > 1``, pad the event axis
to ``block_e``, validate shapes with actionable messages before any
launch, and crop back.

The sizing rules keep JAX's formulas with one change of residency model.
The TPU plan modelled ``batch_tile`` tiles resident against 16 MiB of
VMEM; the port models one tile against the shared memory of one block,
:data:`SMEM_PER_BLOCK` (the gather kernels stage no tile, so the model
only chooses a schedule).
``block_e`` and ``event_par`` only choose a schedule — every setting gives
the same result — while the rules that change results (``snap_divisor``
for the channel block, and the capacity rules in ``core/plan.py`` and
``core/aeq.py``) are JAX's, unchanged.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.aeq import BatchedEventQueue, EventQueue, segment_pad
from repro_torch.core.event_conv import crop_vm, pad_vm
from repro_torch.core.geometry import GEOM_3X3, ConvGeometry

from .kernel import (SMEM_PER_BLOCK, event_conv_cuda, event_conv_cuda_batched,
                     event_conv_cuda_interlaced,
                     event_conv_cuda_interlaced_batched)
from .ref import event_conv_ref, event_conv_ref_batched

# Bytes one queue slot streams: (i, j) int32 coords + a valid byte.
EVENT_BYTES = 2 * 4 + 1


def snap_divisor(n: int, requested: int) -> int:
    """Largest divisor of ``n`` <= ``requested``."""
    requested = max(1, min(requested, n))
    if n % requested == 0:
        return requested
    return max(d for d in range(1, requested + 1) if n % d == 0)


def autotune_block_e(capacity: int, vm_tile: tuple[int, ...] = (), *,
                     vm_bytes: int = 4,
                     smem_budget: int = SMEM_PER_BLOCK) -> int:
    """Event-block size for a queue of ``capacity`` slots: the JAX rule
    (double-buffered blocks beside the resident tile, ~4 blocks per queue,
    floor 64), with ``vm_tile`` one CTA's tile and the budget one block's
    shared memory.  Always a divisor of ``capacity``."""
    if capacity <= 0:
        return 1
    resident = 2 * math.prod(vm_tile) * vm_bytes if vm_tile else 0
    spare = max(smem_budget - resident, 2 * EVENT_BYTES)
    cap = max(spare // (2 * EVENT_BYTES), 1)
    granule = max(capacity // 4, 64)
    return snap_divisor(capacity, min(capacity, cap, granule))


def snap_block_e_for_par(depth: int, block_e: int, event_par: int) -> int:
    """A multiple of ``event_par`` dividing the segment-padded ``depth``."""
    return event_par * snap_divisor(depth // event_par,
                                    max(1, block_e // event_par))


def autotune_event_par(capacity: int, vm_tile: tuple[int, ...] = (), *,
                       vm_bytes: int = 4, smem_budget: int = SMEM_PER_BLOCK,
                       max_par: int = 8,
                       geometry: ConvGeometry = GEOM_3X3) -> int:
    """Interlaced event-parallel width: the JAX rule (``event_par`` patches
    beside the resident tile, at least ~2 groups per average column
    segment, a power of two, floor 1) against one block's shared
    memory."""
    if capacity < 2:
        return 1
    nb = geometry.n_banks
    resident = 2 * math.prod(vm_tile) * vm_bytes if vm_tile else 0
    channels = vm_tile[-1] if vm_tile else 1
    patch_bytes = 2 * nb * channels * vm_bytes
    spare = max(smem_budget - resident, 0)
    cap = spare // patch_bytes if patch_bytes else max_par
    target = min(max_par, cap, max(capacity // (2 * nb), 1))
    par = 1
    while par * 2 <= target:
        par *= 2
    return par


def candidate_block_es(capacity: int, vm_tile: tuple[int, ...] = (), *,
                       vm_bytes: int = 4,
                       smem_budget: int = SMEM_PER_BLOCK) -> list[int]:
    """The measured tuner's ``block_e`` candidates: the analytic pick
    (:func:`autotune_block_e`) and its neighbours one octave down and up
    to the whole queue, snapped to divisors of ``capacity`` under the same
    ceiling (JAX's set against one block's shared memory).  Sorted,
    deduplicated, never empty.  The gathers ignore ``block_e``; it reaches
    only ``LayerStats.event_block``."""
    prior = autotune_block_e(capacity, vm_tile, vm_bytes=vm_bytes,
                             smem_budget=smem_budget)
    if capacity <= 0:
        return [prior]
    resident = 2 * math.prod(vm_tile) * vm_bytes if vm_tile else 0
    spare = max(smem_budget - resident, 2 * EVENT_BYTES)
    cap = max(spare // (2 * EVENT_BYTES), 1)
    cands = {prior}
    for req in (prior // 2, prior * 2, prior * 4, capacity):
        if req >= 1:
            cands.add(snap_divisor(capacity, min(req, cap)))
    return sorted(cands)


def validate_event_shapes(coords: torch.Tensor, valid: torch.Tensor,
                          vm_padded: torch.Tensor | None = None, *,
                          block_e: int | None = None,
                          event_par: int = 1,
                          batched: bool = False,
                          geometry: ConvGeometry | None = None) -> None:
    """Validate event-stream shapes before any padding or launch, with the
    fix spelled out (JAX's messages, unchanged)."""
    geo = f" [{geometry.describe()} geometry]" if geometry is not None else ""
    want = 3 if batched else 2
    kind = "batched " if batched else ""
    if coords.ndim != want or coords.shape[-1] != 2:
        raise ValueError(
            f"{kind}event coords must be {'(Q, E, 2)' if batched else '(E, 2)'}"
            f" (i, j) address pairs, got shape {tuple(coords.shape)}{geo}")
    if valid.shape != coords.shape[:-1]:
        raise ValueError(
            f"valid bits shape {tuple(valid.shape)} does not match event "
            f"coords {tuple(coords.shape)} — expected "
            f"{tuple(coords.shape[:-1])}{geo}")
    if batched and vm_padded is not None and vm_padded.shape[0] != coords.shape[0]:
        raise ValueError(
            f"queue count mismatch: vm stack has {vm_padded.shape[0]} tiles "
            f"but coords describe {coords.shape[0]} queues{geo}")
    if block_e is not None and block_e < 1:
        raise ValueError(f"block_e={block_e} must be >= 1{geo}")
    if event_par < 1:
        raise ValueError(f"event_par={event_par} must be >= 1{geo}")
    if event_par > 1 and block_e is not None and block_e % event_par != 0:
        raise ValueError(
            f"block_e={block_e} must be a multiple of event_par={event_par} "
            f"so parallel groups tile the event blocks evenly (plan_network "
            f"snaps both; pass block_e=None to autotune){geo}")
    if geometry is not None:
        geometry.require_event_compatible("event_conv")


def _pad_events(queue: EventQueue | BatchedEventQueue, block_e: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The queue's coords and valid bits, the event axis padded with
    invalid (0, 0) slots to a multiple of ``block_e``; contiguous."""
    pad = -queue.capacity % block_e
    coords = torch.nn.functional.pad(queue.coords, (0, 0, 0, pad))
    valid = torch.nn.functional.pad(queue.valid, (0, pad))
    return coords.contiguous(), valid.contiguous()


def _size_block_e(block_e: int | None, depth: int, tile: tuple[int, ...],
                  vm_bytes: int, event_par: int) -> int:
    """``block_e``, or (``None``) the autotuned block for a queue of
    ``depth`` slots and a resident ``tile``."""
    if block_e is not None:
        return block_e
    block_e = autotune_block_e(depth, tile, vm_bytes=vm_bytes)
    if event_par > 1:
        block_e = snap_block_e_for_par(depth, block_e, event_par)
    return block_e


def event_conv(
    vm: torch.Tensor,
    queue: EventQueue,
    kernel: torch.Tensor,
    *,
    block_e: int | None = 128,
    use_kernel: bool = True,
    event_par: int = 1,
) -> torch.Tensor:
    """Event-driven conv accumulation onto one unpadded (H, W, C) tile, or
    an (H, W) map with an (kh, kw) kernel.

    The (kh, kw, C) kernel fixes the geometry.  The wrapper halo-pads,
    pads the event axis to ``block_e`` (``None`` autotunes it), and crops
    back.  ``event_par > 1`` segment-pads the queue and dispatches the
    interlaced kernel; ``use_kernel=False`` runs the plain sequential
    replay.
    """
    if vm.ndim == 2:
        out = event_conv(vm[:, :, None], queue, kernel[:, :, None],
                         block_e=block_e, use_kernel=use_kernel,
                         event_par=event_par)
        return out[:, :, 0]
    geom = ConvGeometry.from_kernel_shape(kernel.shape)
    hh, hw = geom.halo
    validate_event_shapes(queue.coords, queue.valid, block_e=block_e,
                          event_par=event_par, geometry=geom)
    if event_par > 1:
        queue = segment_pad(queue, event_par, geom)
    block_e = _size_block_e(
        block_e, queue.capacity,
        (vm.shape[0] + 2 * hh, vm.shape[1] + 2 * hw) + tuple(vm.shape[2:]),
        vm.element_size(), event_par)
    coords, valid = _pad_events(queue, block_e)
    vm_p = pad_vm(vm, geom)
    k = kernel.to(vm.dtype)
    if use_kernel and event_par > 1:
        out = event_conv_cuda_interlaced(vm_p, coords, valid, k,
                                         event_par=event_par, out=vm_p)
    elif use_kernel:
        out = event_conv_cuda(vm_p, coords, valid, k, out=vm_p)
    else:
        out = event_conv_ref(vm_p, coords, valid, k)
    return crop_vm(out, geom)


def event_conv_batched(
    vm: torch.Tensor,
    queues: BatchedEventQueue,
    kernel: torch.Tensor,
    *,
    block_e: int | None = 128,
    use_kernel: bool = True,
    event_par: int = 1,
) -> torch.Tensor:
    """Batched event-driven conv accumulation onto unpadded (Q, H, W, C)
    tiles.

    ``queues`` has one leading dim Q matching ``vm``; the (kh, kw, C)
    kernel is shared by every queue and fixes the geometry.  The wrapper
    halo-pads, pads the event axis to ``block_e`` (``None`` sizes it with
    :func:`autotune_block_e`), and crops back.  ``event_par > 1``
    segment-pads the queues and dispatches the interlaced kernel;
    ``use_kernel=False`` runs the plain sequential replay.
    """
    if queues.coords.ndim != 3:
        raise ValueError("event_conv_batched expects queues with one leading "
                         f"dim, got coords shape {tuple(queues.coords.shape)}")
    geom = ConvGeometry.from_kernel_shape(kernel.shape)
    hh, hw = geom.halo
    validate_event_shapes(queues.coords, queues.valid, vm, block_e=block_e,
                          event_par=event_par, batched=True, geometry=geom)
    if event_par > 1:
        queues = segment_pad(queues, event_par, geom)
    block_e = _size_block_e(
        block_e, queues.capacity,
        (vm.shape[1] + 2 * hh, vm.shape[2] + 2 * hw) + tuple(vm.shape[3:]),
        vm.element_size(), event_par)
    coords, valid = _pad_events(queues, block_e)
    q, h, w = vm.shape[:3]
    vm_p = vm.new_zeros((q, h + 2 * hh, w + 2 * hw) + tuple(vm.shape[3:]))
    vm_p[:, hh:hh + h, hw:hw + w] = vm
    k = kernel.to(vm.dtype)
    if use_kernel and event_par > 1:
        out = event_conv_cuda_interlaced_batched(vm_p, coords, valid, k,
                                                 event_par=event_par)
    elif use_kernel:
        out = event_conv_cuda_batched(vm_p, coords, valid, k)
    else:
        out = event_conv_ref_batched(vm_p, coords, valid, k)
    return out[:, hh:hh + h, hw:hw + w]
