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

``dense_conv`` (and ``conv2d_same`` under it) is the frame-based oracle:
the sliding-window convolution in full float32, TF32 switched off for
the call only.

The banked machinery (``bank_vm`` ... ``apply_events_banked_batched``)
applies a whole interlace column at once: a cell receives at most one
event per column, so one masked add per (column, bank) replaces the event
walk, and the s = 0..n_banks-1 order keeps each cell's adds in queue
order, per-event saturation included.
"""
from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import torch

from .aeq import EventQueue
from .geometry import GEOM_3X3, ConvGeometry
from .quantization import SAT_RANGE, acc


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


def apply_events_blocked(vm_padded: torch.Tensor, queue: EventQueue,
                         kernel: torch.Tensor, *, block: int = 64
                         ) -> torch.Tensor:
    """:func:`apply_events` with block-granular early exit: whole blocks
    of ``block`` slots while a block starts below ``queue.count``, so the
    work scales with ceil(count / block), not with the capacity."""
    return apply_events_batched(vm_padded[None], queue.coords[None],
                                queue.valid[None], queue.count.reshape(1),
                                kernel, block=block)[0]


@contextmanager
def _fp32_convolutions():
    """cuDNN convolutions in full float32 inside the block: TF32 is off
    for the block only, and the process-wide switch is restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def conv2d_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME cross-correlation (``lax.conv_general_dilated`` with NHWC /
    HWIO / NHWC and padding ``"SAME"``) of float x (N, H, W, C_in) with an
    odd (kh, kw, C_in, C_out) kernel, in full float32."""
    kh, kw = kernel.shape[:2]
    with _fp32_convolutions():
        out = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
            padding=(kh // 2, kw // 2))
    return out.permute(0, 2, 3, 1)


def dense_conv(fmap: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Sliding-window oracle: SAME conv of a binary (H, W) fmap with a
    float (kh, kw) or (kh, kw, C_out) kernel; returns (H, W) or (H, W,
    C_out) in the kernel's dtype.  The frame-based baseline the paper
    compares against (SIES-style)."""
    if not kernel.dtype.is_floating_point:
        raise ValueError(f"dense_conv takes a float kernel, got "
                         f"{kernel.dtype}")
    k = kernel[:, :, None, None] if kernel.ndim == 2 else kernel[:, :, None]
    out = conv2d_same(fmap.to(kernel.dtype)[None, :, :, None], k)[0]
    return out[:, :, 0] if kernel.ndim == 2 else out


# ---------------------------------------------------------------------------
# Memory-interlaced application (banked membrane tiles).
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _interlace_tables(kh: int = 3, kw: int = 3):
    """Static (column, bank) routing of the interlaced conv update, as
    tuples indexed [s][t] (n_banks x n_banks): PERM = flat tap index a*kw+b
    that column-s events write into bank t; DI/DJ = macro-cell shift of
    that write against the event's centre bank, in {-1, 0, +1} for every
    odd window; COL_BANK[s] = padded-space bank holding column-s centres
    (i+hh, j+hw)."""
    hh, hw = kh // 2, kw // 2
    nb = kh * kw
    perm, di, dj, col_bank = [], [], [], []
    for s in range(nb):
        si, sj = divmod(s, kw)
        col_bank.append(((si + hh) % kh) * kw + (sj + hw) % kw)
        prow, drow, jrow = [], [], []
        for t in range(nb):
            ti, tj = divmod(t, kw)
            a = (ti - si) % kh
            b = (tj - sj) % kw
            prow.append(a * kw + b)
            drow.append((si + a) // kh - (si + hh) // kh)
            jrow.append((sj + b) // kw - (sj + hw) // kw)
        perm.append(tuple(prow))
        di.append(tuple(drow))
        dj.append(tuple(jrow))
    return tuple(perm), tuple(di), tuple(dj), tuple(col_bank)


def bank_vm(vm_padded: torch.Tensor,
            geometry: ConvGeometry = GEOM_3X3) -> torch.Tensor:
    """(..., Hp, Wp, C) halo-padded tile -> (..., n_banks, HB, WB, C) RAM
    banks: bank t = kw*(r%kh) + (c%kw) of padded cell (r, c) at macro
    address (r//kh, c//kw).  Hp/Wp are zero-padded up to window
    multiples; ``unbank_vm`` drops those cells again."""
    kh, kw = geometry.kh, geometry.kw
    *lead, hp, wp, c = vm_padded.shape
    hb, wb = -(-hp // kh), -(-wp // kw)
    nl = len(lead)
    v = vm_padded.new_zeros((*lead, kh * hb, kw * wb, c))
    v[..., :hp, :wp, :] = vm_padded
    v = v.reshape(*lead, hb, kh, wb, kw, c)
    v = v.permute(*range(nl), nl + 1, nl + 3, nl, nl + 2, nl + 4)
    return v.reshape(*lead, kh * kw, hb, wb, c)


def unbank_vm(vm_banked: torch.Tensor, hp: int, wp: int,
              geometry: ConvGeometry = GEOM_3X3) -> torch.Tensor:
    """Inverse of :func:`bank_vm`: (..., n_banks, HB, WB, C) ->
    (..., Hp, Wp, C), contiguous."""
    kh, kw = geometry.kh, geometry.kw
    *lead, _, hb, wb, c = vm_banked.shape
    nl = len(lead)
    v = vm_banked.reshape(*lead, kh, kw, hb, wb, c)
    v = v.permute(*range(nl), nl + 2, nl, nl + 3, nl + 1, nl + 4)
    v = v.reshape(*lead, kh * hb, kw * wb, c)
    return v[..., :hp, :wp, :].contiguous()


def shifted_bank_masks(masks: torch.Tensor,
                       geometry: ConvGeometry = GEOM_3X3) -> torch.Tensor:
    """Bank occupancy (..., n_banks, HB, WB) -> per-(column, bank) write
    masks (..., n_banks cols, n_banks banks, HB, WB): entry [s, t, I, J]
    is True iff bank t's cell (I, J) receives column s's tap — column s's
    centre mask shifted by (DI, DJ)[s, t], as static slices of one
    array padded by a macro cell per side."""
    _, di_t, dj_t, col_bank = _interlace_tables(geometry.kh, geometry.kw)
    nb = geometry.n_banks
    hb, wb = masks.shape[-2:]
    nl = masks.ndim - 3
    mp = masks.new_zeros(masks.shape[:-2] + (hb + 2, wb + 2))
    mp[..., 1:-1, 1:-1] = masks
    per_col = []
    for s in range(nb):
        m = mp[..., col_bank[s], :, :]
        per_bank = []
        for t in range(nb):
            r0, c0 = 1 - di_t[s][t], 1 - dj_t[s][t]
            per_bank.append(m[..., r0:r0 + hb, c0:c0 + wb])
        per_col.append(torch.stack(per_bank, dim=nl))
    return torch.stack(per_col, dim=nl)


def tap_matrix(kernel: torch.Tensor) -> torch.Tensor:
    """(kh, kw, ...) unrotated kernel -> (n_banks cols, n_banks banks, ...)
    taps: entry [s, t] is the (180-degree-rotated) tap that column-s
    events add into bank t."""
    geom = kernel_geometry(kernel, "tap_matrix")
    perm, _, _, _ = _interlace_tables(geom.kh, geom.kw)
    k_rot = rotate_kernel(kernel)
    flat = k_rot.reshape((geom.n_banks,) + tuple(k_rot.shape[2:]))
    # an asynchronous copy of the index: a blocking one would wait for
    # the work queued on the device
    return flat[torch.tensor(perm).to(kernel.device, non_blocking=True)]


def _acc_masked(bank: torch.Tensor, tap: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """bank + tap*mask, saturating for int dtypes.  mask is 0/1, so a cell
    gets exactly ``tap`` or nothing (only the sign of an untouched zero
    may differ, which compares equal); clipping an untouched in-range
    int cell is the identity, so per-event saturation is kept."""
    m = mask[..., None]
    sat = SAT_RANGE.get(bank.dtype)
    if sat is None:
        return bank + tap * m.to(bank.dtype)
    wide = bank.to(torch.int32) + tap.to(torch.int32) * m.to(torch.int32)
    return wide.clamp(*sat).to(bank.dtype)


def apply_banked_columns(vm_banked: torch.Tensor, smasks: torch.Tensor,
                         taps: torch.Tensor) -> torch.Tensor:
    """Apply one queue's events to a banked tile, one column at a time.

    vm_banked (..., n_banks, HB, WB, C) from :func:`bank_vm`; smasks
    (..., n_banks cols, n_banks banks, HB, WB) from
    :func:`shifted_bank_masks`; taps (n_banks, n_banks, C) from
    :func:`tap_matrix` in vm's dtype.  Bank-major, columns s = 0.. in
    order within each bank: equal to the event walk bit for bit.
    """
    nb = taps.shape[0]
    banks = []
    for t in range(nb):
        bank = vm_banked[..., t, :, :, :]
        for s in range(nb):
            bank = _acc_masked(bank, taps[s, t], smasks[..., s, t, :, :])
        banks.append(bank)
    return torch.stack(banks, dim=-4)


def apply_banked_columns_fused(vm_banked: torch.Tensor,
                               padded_masks: torch.Tensor,
                               taps: torch.Tensor,
                               geometry: ConvGeometry = GEOM_3X3
                               ) -> torch.Tensor:
    """:func:`apply_banked_columns` reading the fused-handoff carrier:
    padded_masks (..., n_banks, HB+2, WB+2) bool is the centre occupancy
    with one macro cell of padding per side, and each (s, t) write mask is
    its static slice ``[COL_BANK[s], 1-DI[s,t]:, 1-DJ[s,t]:]``."""
    _, di_t, dj_t, col_bank = _interlace_tables(geometry.kh, geometry.kw)
    nb = geometry.n_banks
    hb, wb = vm_banked.shape[-3], vm_banked.shape[-2]
    banks = []
    for t in range(nb):
        bank = vm_banked[..., t, :, :, :]
        for s in range(nb):
            r0, c0 = 1 - di_t[s][t], 1 - dj_t[s][t]
            m = padded_masks[..., col_bank[s], r0:r0 + hb, c0:c0 + wb]
            bank = _acc_masked(bank, taps[s, t], m)
        banks.append(bank)
    return torch.stack(banks, dim=-4)


def apply_events_banked(vm_padded: torch.Tensor, masks: torch.Tensor,
                        kernel: torch.Tensor) -> torch.Tensor:
    """Banked counterpart of :func:`apply_events` for one tile:
    vm_padded (Hp, Wp[, C]); masks (n_banks, HB, WB) bank occupancy
    (``aeq.build_bank_masks``); kernel (kh, kw[, C]) unrotated."""
    kernel_geometry(kernel, "apply_events_banked")
    squeeze = vm_padded.ndim == 2
    vm = vm_padded[..., None] if squeeze else vm_padded
    k = kernel[..., None] if squeeze else kernel
    out = apply_events_banked_batched(vm[None], masks[None], k)[0]
    return out[..., 0] if squeeze else out


def apply_events_banked_batched(vm_padded: torch.Tensor, masks: torch.Tensor,
                                kernel: torch.Tensor) -> torch.Tensor:
    """Banked path over a stack of tiles: vm_padded (Q, Hp, Wp, C); masks
    (Q, n_banks, HB, WB); kernel (kh, kw, C) shared.  Equal to the
    per-queue event walk."""
    geom = kernel_geometry(kernel, "apply_events_banked_batched")
    hp, wp = vm_padded.shape[-3:-1]
    return unbank_vm(
        apply_banked_columns(bank_vm(vm_padded, geom),
                             shifted_bank_masks(masks, geom),
                             tap_matrix(kernel).to(vm_padded.dtype)),
        hp, wp, geom)
