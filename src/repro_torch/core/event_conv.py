"""Event-driven convolution (paper Sec. V-B, Fig. 4; main-path port of
``repro.core.event_conv``).

To convolve a binary fmap with a k x k kernel, walk its Address-Event
Queue: each event at (i, j) adds the 180-degree-rotated kernel into the
window of the halo-padded membrane tile at (i, j).  The result equals
the sliding-window convolution, while the work scales with the number of
events.  The halo (kh//2, kw//2 per side) replaces the FPGA's
out-of-bounds detection: edge events write into it, and it is cropped.

Integer datapaths saturate after every event (``quantization.acc``);
saturating per event is not the same as clipping once at the end, so the
plain loops here replay events one at a time, vectorized over the batch
of queues.  ``replay_events_`` is the one plain event loop: the plain
versions of the CUDA kernels (``kernels/event_conv/ref.py``) run it too.
"""
from __future__ import annotations

import torch

from .aeq import EventQueue
from .geometry import GEOM_3X3, ConvGeometry
from .quantization import acc


def pad_vm(vm: torch.Tensor, geometry: ConvGeometry = GEOM_3X3) -> torch.Tensor:
    """(H, W, ...) -> (H+2*hh, W+2*hw, ...) zero halo."""
    hh, hw = geometry.halo
    out = vm.new_zeros((vm.shape[0] + 2 * hh, vm.shape[1] + 2 * hw)
                       + tuple(vm.shape[2:]))
    out[hh:hh + vm.shape[0], hw:hw + vm.shape[1]] = vm
    return out


def crop_vm(vm_padded: torch.Tensor,
            geometry: ConvGeometry = GEOM_3X3) -> torch.Tensor:
    """Remove the halo (identity for the k=1 zero halo)."""
    hh, hw = geometry.halo
    hp, wp = vm_padded.shape[:2]
    return vm_padded[hh:hp - hh, hw:wp - hw]


def rotate_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """180 degree rotation over the two leading (spatial) axes (Fig. 4)."""
    return kernel.flip(0, 1)


def kernel_geometry(kernel: torch.Tensor, where: str) -> ConvGeometry:
    """Geometry implied by the kernel's (kh, kw, ...) shape; rejects even
    windows with an actionable message."""
    try:
        return ConvGeometry.from_kernel_shape(kernel.shape)
    except ValueError as e:
        raise ValueError(
            f"{where}: kernel shape {tuple(kernel.shape)} does not define "
            f"a valid interlaced geometry ({e})") from None


def replay_events_(vm: torch.Tensor, coords: torch.Tensor,
                   valid: torch.Tensor, k_rot: torch.Tensor,
                   steps) -> torch.Tensor:
    """Apply queue slots ``steps`` (in order) of every queue, in place.

    vm: (Q, Hp, Wp, C) contiguous; coords (Q, E, 2); valid (Q, E) bool;
    k_rot (kh, kw, C) already rotated and in vm's dtype.  Each step is one
    event per queue, vectorized over Q.  Invalid slots add zeros at the
    (0, 0) corner, as in the JAX step; window starts are clamped into the
    tile like ``lax.dynamic_slice`` clamps them.  Indices and
    contributions of all steps are formed up front, so a step is one
    gather, one (saturating) add and one scatter.
    """
    q, hp, wp, c = vm.shape
    kh, kw = k_rot.shape[:2]
    dev = vm.device
    v = valid[:, steps].to(torch.bool)                      # (Q, S)
    i = torch.where(v, coords[:, steps, 0], 0).clamp(0, hp - kh).long()
    j = torch.where(v, coords[:, steps, 1], 0).clamp(0, wp - kw).long()
    offs = (torch.arange(kh, device=dev)[:, None] * wp
            + torch.arange(kw, device=dev)[None, :]).reshape(-1)
    idx = ((i * wp + j)[..., None] + offs)[..., None]       # (Q, S, khkw, 1)
    k_flat = k_rot.reshape(kh * kw, c)
    contrib = torch.where(v[..., None, None], k_flat, torch.zeros_like(k_flat))
    flat = vm.view(q, hp * wp, c)
    for s in range(v.shape[1]):
        ix = idx[:, s].expand(q, kh * kw, c)
        flat.scatter_(1, ix, acc(flat.gather(1, ix), contrib[:, s]))
    return vm


def apply_events(vm_padded: torch.Tensor, queue: EventQueue,
                 kernel: torch.Tensor) -> torch.Tensor:
    """Accumulate one event queue into a padded (Hp, Wp[, C]) tile with an
    unrotated (kh, kw[, C]) kernel."""
    kernel_geometry(kernel, "apply_events")
    squeeze = vm_padded.ndim == 2
    vm = vm_padded[None, ..., None] if squeeze else vm_padded[None]
    k = kernel[..., None] if squeeze else kernel
    out = apply_events_batched(vm, queue.coords[None], queue.valid[None],
                               queue.coords.new_full((1,), queue.capacity),
                               k, block=max(queue.capacity, 1))
    return out[0, ..., 0] if squeeze else out[0]


def apply_events_batched(vm_padded: torch.Tensor, coords: torch.Tensor,
                         valid: torch.Tensor, counts: torch.Tensor,
                         kernel: torch.Tensor, *, block: int = 64
                         ) -> torch.Tensor:
    """Apply one event queue per batch member, early-exiting together.

    vm_padded: (Q, Hp, Wp[, C]); coords (Q, E, 2); valid (Q, E); counts
    (Q,) spike demand; kernel (kh, kw[, C]) shared by every queue.  The
    walk covers whole blocks of ``block`` slots while a block starts below
    ``max(counts)`` — the batch drains when its fullest queue drains.
    Skipped tail slots are all invalid, so the result is that of the full
    walk.  Returns a new tensor.
    """
    kernel_geometry(kernel, "apply_events_batched")
    squeeze = vm_padded.ndim == 3
    vm = (vm_padded[..., None] if squeeze else vm_padded).clone(
        memory_format=torch.contiguous_format)
    k = kernel[..., None] if squeeze else kernel
    k_rot = rotate_kernel(k).to(vm.dtype)
    cap = coords.shape[1]
    max_count = int(counts.max()) if counts.numel() else 0
    n_steps = min(cap, -(-max_count // block) * block)
    replay_events_(vm, coords, valid, k_rot, slice(0, n_steps))
    return vm[..., 0] if squeeze else vm
