"""Address-Event Queue (AEQ): runtime compaction of sparse binary fmaps
(paper Secs. V-A / VI-A; main-path port of ``repro.core.aeq``).

A binary fmap becomes a fixed-capacity queue of the (i, j) coordinates of
its ones, in the paper's interlaced column order (column
s = kw*(i%kh) + (j%kw), then i, then j), which makes same-column events
hazard-free.  The static capacity plays the role of the BRAM queue depth:
events beyond it are dropped from the tail of that order, exactly as a
full hardware queue would, and every builder here truncates identically
to the JAX package (the serve plan truncates on the main path).

Every queue also carries its column segments (``seg_offsets`` /
``seg_counts``); ``segment_pad`` re-lays a queue so each segment starts
at and is padded to a multiple of ``event_par`` — the layout the
interlaced conv kernel consumes.  ``build_launch_queues`` gives the
queues of a whole spike chunk in the conv unit's launch layout: on the
card one launch of the builder kernel (``kernels/aeq_build``), on the CPU
its plain version, ``build_aeq_batched`` then ``segment_pad``.

The banked variants skip the queue: ``interlace`` lays a map out as the
n_banks membrane RAM banks, ``ranked_keep`` truncates by cumulative ranks
instead of a sort (the same kept events), and ``build_bank_masks`` /
``build_fused_handoff`` place the kept events' centres into padded banks
(``BankedEvents``; ``FusedHandoff``, the carrier between fused layers).

Streaming ingestion skips the dense frame: raw DVS address events
(t, y, x, polarity) are appended into a :class:`StreamState`, whose
occupancy already sits in the interlace-column banks
(``append_events`` / ``append_events_batched``: duplicates dedupe,
out-of-window rows drop, order never matters).  ``stream_frames`` views
the banks as the binned frames, which ``build_launch_queues`` compacts as
it compacts any spike chunk, and ``fused_handoff_from_banks`` builds the
fused carrier straight from them.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .geometry import GEOM_3X3, ConvGeometry


class EventQueue(NamedTuple):
    """One fixed-capacity queue of address events.

    coords: (capacity, 2) int32 (i, j); -1 where ~valid.
    valid:  (capacity,) bool.
    count:  () int32 spike demand (may exceed the kept events).
    seg_offsets/seg_counts: (n_banks,) int32 interlace column segments,
        None for raster-ordered queues.
    """

    coords: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor
    seg_offsets: Optional[torch.Tensor] = None
    seg_counts: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]


class BatchedEventQueue(NamedTuple):
    """A stack of queues sharing one capacity: coords (..., cap, 2),
    valid (..., cap), count (...,), segments (..., n_banks)."""

    coords: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor
    seg_offsets: Optional[torch.Tensor] = None
    seg_counts: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.coords.shape[-2]

    def queue_at(self, index: tuple) -> EventQueue:
        return EventQueue(
            coords=self.coords[index], valid=self.valid[index],
            count=self.count[index],
            seg_offsets=None if self.seg_offsets is None
            else self.seg_offsets[index],
            seg_counts=None if self.seg_counts is None
            else self.seg_counts[index])


def column_index(i, j, geometry: ConvGeometry = GEOM_3X3):
    """Interlace column s = kw*(i % kh) + (j % kw)."""
    return geometry.column_of(i, j)


def interlaced_capacity(capacity: int, event_par: int,
                        n_banks: int = 9) -> int:
    """Queue depth of the ``segment_pad`` layout: worst case adds
    n_banks*(event_par-1) slots, rounded up to an event_par multiple."""
    if event_par <= 1:
        return capacity
    base = capacity + n_banks * (event_par - 1)
    return -(-base // event_par) * event_par


def _order_keys(h: int, w: int, interlaced: bool,
                geometry: ConvGeometry = GEOM_3X3,
                device=None) -> torch.Tensor:
    """(H*W,) int32 read-order key per pixel: (column s, i, j) or raster."""
    ii, jj = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    if interlaced:
        key = column_index(ii, jj, geometry) * (h * w) + ii * w + jj
    else:
        key = ii * w + jj
    return key.to(torch.int32)


def _kept_segments(flat: torch.Tensor, h: int, w: int, kept: torch.Tensor,
                   geometry: ConvGeometry = GEOM_3X3
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(seg_offsets, seg_counts), both (N, n_banks) int32, of the first
    ``kept`` events in interlaced order: truncation drops from the tail,
    so column s keeps clip(kept - cum_s, 0, count_s).

    The per-column totals come from a reshape-sum over (kh, kw) macro
    cells instead of JAX's one-hot sum; both count the same pixels.
    """
    kh, kw = geometry.kh, geometry.kw
    n = flat.shape[0]
    x = flat.reshape(n, h, w).to(torch.int32)
    x = torch.nn.functional.pad(x, (0, -w % kw, 0, -h % kh))
    hb, wb = x.shape[1] // kh, x.shape[2] // kw
    full = x.reshape(n, hb, kh, wb, kw).sum(dim=(1, 3)).reshape(n, kh * kw)
    full = full.to(torch.int32)
    cum = torch.cumsum(full, dim=-1) - full  # exclusive
    seg_counts = torch.minimum(torch.clamp(kept[:, None] - cum, min=0), full)
    seg_offsets = torch.cumsum(seg_counts, dim=-1) - seg_counts
    return seg_offsets.to(torch.int32), seg_counts.to(torch.int32)


def build_aeq_batched(fmaps: torch.Tensor, capacity: int, *,
                      interlaced: bool = True,
                      geometry: ConvGeometry = GEOM_3X3
                      ) -> BatchedEventQueue:
    """Compact a stack of binary fmaps (..., H, W) in one batched sort.

    Keys of active pixels are unique, so the sort order is fully
    determined; the ties among inactive pixels (the ``big`` key) are
    masked to -1 and ``valid=False``.  Bit-exact vs the JAX builder
    (tests/test_torch_encoding_aeq.py).
    """
    *lead, h, w = fmaps.shape
    nb = geometry.n_banks
    n = math.prod(lead)
    flat = fmaps.reshape(n, h * w).to(torch.bool)
    big = nb * h * w + 1
    order = _order_keys(h, w, interlaced, geometry, device=fmaps.device)
    keys = torch.where(flat, order[None, :],
                       torch.full((), big, dtype=torch.int32,
                                  device=fmaps.device))
    sorted_keys, perm = torch.sort(keys, dim=-1)
    take_n = min(capacity, h * w)
    take = perm[:, :take_n].to(torch.int32)
    valid = sorted_keys[:, :take_n] < big
    coords = torch.stack([take // w, take % w], dim=-1)
    coords = torch.where(valid[..., None], coords, -1).to(torch.int32)
    if take_n < capacity:
        pad = capacity - take_n
        coords = torch.cat([coords, coords.new_full((n, pad, 2), -1)], dim=1)
        valid = torch.cat([valid, valid.new_zeros((n, pad))], dim=1)
    count = flat.sum(dim=-1).to(torch.int32)
    seg_off = seg_cnt = None
    if interlaced:
        kept = torch.clamp(count, max=take_n)
        seg_off, seg_cnt = _kept_segments(flat, h, w, kept, geometry)
        seg_off = seg_off.reshape(*lead, nb)
        seg_cnt = seg_cnt.reshape(*lead, nb)
    return BatchedEventQueue(
        coords=coords.reshape(*lead, capacity, 2),
        valid=valid.reshape(*lead, capacity),
        count=count.reshape(tuple(lead)),
        seg_offsets=seg_off, seg_counts=seg_cnt)


def build_aeq(fmap: torch.Tensor, capacity: int, *, interlaced: bool = True,
              geometry: ConvGeometry = GEOM_3X3) -> EventQueue:
    """Compact one binary fmap (H, W): the one-fmap view of
    :func:`build_aeq_batched`."""
    bq = build_aeq_batched(fmap[None], capacity, interlaced=interlaced,
                           geometry=geometry)
    return bq.queue_at((0,))


def segment_pad(queue: BatchedEventQueue | EventQueue, event_par: int,
                geometry: ConvGeometry = GEOM_3X3
                ) -> BatchedEventQueue | EventQueue:
    """Re-lay an interlaced queue so column segments are event_par-aligned.

    Each segment keeps its events in order, starts at a multiple of
    ``event_par`` and is padded with invalid slots, so every aligned
    group of ``event_par`` slots holds one column (or padding).  Capacity
    becomes ``interlaced_capacity(cap, event_par)``; ``seg_offsets``
    point into the padded layout.
    """
    if queue.seg_offsets is None:
        raise ValueError("segment_pad needs an interlaced queue carrying "
                         "column segments (build_aeq(..., interlaced=True))")
    single = isinstance(queue, EventQueue)
    if single:
        queue = BatchedEventQueue(*(x[None] for x in queue))
    coords, valid = queue.coords, queue.valid
    nb = geometry.n_banks
    lead = coords.shape[:-2]
    n = math.prod(lead)
    cap = coords.shape[-2]
    cap_pad = interlaced_capacity(cap, event_par, nb)
    coords = coords.reshape(n, cap, 2)
    valid = valid.reshape(n, cap)
    seg_cnt = queue.seg_counts.reshape(n, nb).to(torch.int64)
    seg_off = queue.seg_offsets.reshape(n, nb).to(torch.int64)

    pad_cnt = -(-seg_cnt // event_par) * event_par
    pad_off = torch.cumsum(pad_cnt, dim=-1) - pad_cnt
    col = column_index(coords[..., 0].to(torch.int64),
                       coords[..., 1].to(torch.int64), geometry)
    col = torch.where(valid, col, 0)
    rank = (torch.arange(cap, device=coords.device)[None, :]
            - torch.gather(seg_off, -1, col))
    newpos = torch.gather(pad_off, -1, col) + rank
    newpos = torch.where(valid, newpos, cap_pad)  # one dump slot, cut below
    oc = coords.new_full((n, cap_pad + 1, 2), -1)
    oc.scatter_(1, newpos[..., None].expand(n, cap, 2), coords)
    ov = valid.new_zeros((n, cap_pad + 1))
    ov.scatter_(1, newpos, valid)
    out = BatchedEventQueue(
        coords=oc[:, :cap_pad].reshape(*lead, cap_pad, 2).contiguous(),
        valid=ov[:, :cap_pad].reshape(*lead, cap_pad).contiguous(),
        count=queue.count,
        seg_offsets=pad_off.to(torch.int32).reshape(*lead, nb),
        seg_counts=queue.seg_counts)
    return out.queue_at((0,)) if single else out


def build_launch_queues(spikes: torch.Tensor, capacity: int, event_par: int,
                        geometry: ConvGeometry = GEOM_3X3
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The conv unit's queues of a (B, T, H, W, C_in) bool spike chunk,
    already in its launch layout: coords (T, C_in, B, cap_pad, 2) int32
    and valid (T, C_in, B, cap_pad) bool, contiguous, and the demand
    count (T, B, C_in) int32.  ``cap_pad`` is
    ``interlaced_capacity(capacity, event_par)``, ``capacity`` at
    ``event_par`` 1.

    Equal to ``segment_pad(build_aeq_batched(fmaps, capacity),
    event_par)`` over the (t, b, c_in) maps, permuted to (t, c_in, b):
    that composition is the plain version a CPU tensor runs; a CUDA
    tensor launches the builder kernel (``kernels/aeq_build``), which
    reads ``spikes`` through its strides."""
    from repro_torch.kernels.aeq_build.kernel import aeq_build_cuda
    return aeq_build_cuda(spikes, capacity, event_par, geometry)


def scatter_aeq(queue: EventQueue, shape: tuple[int, int]) -> torch.Tensor:
    """Inverse of build_aeq: expand an EventQueue back into a binary fmap."""
    fmap = torch.zeros(shape, dtype=torch.bool, device=queue.coords.device)
    kept = queue.coords[queue.valid].long()
    fmap[kept[:, 0], kept[:, 1]] = True
    return fmap


def calibrate_capacity(spike_counts, *, percentile: float = 99.9,
                       margin: float = 1.25, align: int = 8) -> int:
    """Queue capacity covering an observed spike-count distribution: the
    ``percentile`` count times a safety ``margin``, rounded up to
    ``align`` (the analogue of sizing the FPGA's queue BRAM from a
    calibration run).  ``spike_counts``: any array or tensor of counts."""
    if isinstance(spike_counts, torch.Tensor):
        # calibration reads counts on the host by design; a planned
        # forward never calls it (plan_network only when plan is None)
        # analysis: ignore[lint-host-sync-in-hot-path]
        spike_counts = spike_counts.detach().cpu().numpy()
    counts = np.asarray(spike_counts, dtype=np.float64).ravel()
    if counts.size == 0:
        return align
    cap = float(np.percentile(counts, percentile)) * margin
    return int(np.ceil(max(cap, 1.0) / align) * align)


def calibrate_capacities(per_layer_counts, *, percentile: float = 99.9,
                         margin: float = 1.25, align: int = 8) -> list[int]:
    """One :func:`calibrate_capacity` per conv layer, e.g. from
    ``[st.in_spike_counts for st in stats]`` of a calibration run; feed
    the result to ``plan_network(cfg, capacity=...)``."""
    return [calibrate_capacity(c, percentile=percentile, margin=margin,
                               align=align) for c in per_layer_counts]


# ---------------------------------------------------------------------------
# Memory interlacing (paper Fig. 6) and the banked / fused-handoff carriers.
# ---------------------------------------------------------------------------

def _pad_hw(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Zero-pad the two trailing axes at their ends (any dtype, bool too)."""
    if not (ph or pw):
        return x
    h, w = x.shape[-2:]
    out = x.new_zeros(x.shape[:-2] + (h + ph, w + pw))
    out[..., :h, :w] = x
    return out


def interlace(vm: torch.Tensor,
              geometry: ConvGeometry = GEOM_3X3) -> torch.Tensor:
    """(..., H, W) -> (..., n_banks, ceil(H/kh), ceil(W/kw)) memory columns.

    Column s = kw*(i%kh) + (j%kw); within a column, the element of macro
    cell (I, J) = (i//kh, j//kw) lives at address (I, J), so any kh x kw
    window touches each column once.  Leading axes pass through.
    """
    kh, kw = geometry.kh, geometry.kw
    *lead, h, w = vm.shape
    vm = _pad_hw(vm, -h % kh, -w % kw)
    hh, ww = vm.shape[-2:]
    nl = len(lead)
    blocks = vm.reshape(*lead, hh // kh, kh, ww // kw, kw)
    blocks = blocks.permute(*range(nl), nl + 1, nl + 3, nl, nl + 2)
    return blocks.reshape(*lead, kh * kw, hh // kh, ww // kw)


def deinterlace(cols: torch.Tensor, shape: tuple[int, int],
                geometry: ConvGeometry = GEOM_3X3) -> torch.Tensor:
    """Inverse of :func:`interlace`, cropped back to (..., H, W)."""
    kh, kw = geometry.kh, geometry.kw
    *lead, _, bh, bw = cols.shape
    nl = len(lead)
    blocks = cols.reshape(*lead, kh, kw, bh, bw)
    blocks = blocks.permute(*range(nl), nl + 2, nl, nl + 3, nl + 1)
    return blocks.reshape(*lead, bh * kh, bw * kw)[..., :shape[0], :shape[1]]


class BankedEvents(NamedTuple):
    """Kept events of a queue, laid out as the n_banks membrane RAM banks.

    masks: (..., n_banks, HB, WB) bool — a kept event's halo-padded centre
        (i+hh, j+hw) sits in padded-space bank kw*((i+hh)%kh)+(j+hw)%kw at
        macro cell ((i+hh)//kh, (j+hw)//kw): ``event_conv.bank_vm``'s
        banking of the membrane tile.
    count: (...,) int32 spike demand (may exceed the kept events).
    seg_counts: (..., n_banks) int32 kept events per interlace column s.
    """

    masks: torch.Tensor
    count: torch.Tensor
    seg_counts: torch.Tensor


def ranked_keep(il: torch.Tensor, capacity: int, hw: tuple[int, int]
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-free capacity truncation on interlaced occupancy.

    il: (..., n_banks, HB, WB) bool centre-bank occupancy of an unpadded
    (H, W) fmap.  Within a column, (I, J) raster order is the (i, j)
    order, so an event's rank in the (s, i, j) read order is the events of
    earlier columns plus the earlier events of its column (exclusive
    cumulative sums); truncation keeps ranks below min(capacity, H*W),
    which is ``build_aeq_batched``'s tail drop.  Returns (kept occupancy,
    count (...,) int32 demand, seg_counts (..., n_banks) int32 kept per
    column).
    """
    h, w = hw
    hb, wb = il.shape[-2:]
    il_flat = il.reshape(il.shape[:-2] + (hb * wb,))
    seg_full = il_flat.sum(dim=-1, dtype=torch.int32)
    count = seg_full.sum(dim=-1, dtype=torch.int32)
    seg_off = torch.cumsum(seg_full, dim=-1, dtype=torch.int32) - seg_full
    kept = torch.clamp(count, max=min(capacity, h * w))
    seg_counts = torch.minimum(torch.clamp(kept[..., None] - seg_off, min=0),
                               seg_full)
    if capacity >= h * w:
        return il, count, seg_counts
    il_i = il_flat.to(torch.int32)
    rank = seg_off[..., None] + torch.cumsum(il_i, dim=-1,
                                             dtype=torch.int32) - il_i
    kept_il = il_flat & (rank < kept[..., None, None])
    return kept_il.reshape(il.shape), count, seg_counts


def place_padded_banks(kept_il: torch.Tensor, hw: tuple[int, int],
                       geometry: ConvGeometry = GEOM_3X3) -> torch.Tensor:
    """Re-bank unpadded centre occupancy into the padded fused layout.

    kept_il: (..., n_banks, HB, WB) bool over the unpadded fmap.  Returns
    (..., n_banks, HBp+2, WBp+2) bool: column s's cells land in the
    padded-space centre bank ((si+hh)%kh)*kw + (sj+hw)%kw at the static
    macro offset (1 + (si+hh)//kh, 1 + (sj+hw)//kw) — the masks of
    :func:`build_bank_masks` with one zero macro cell per side.
    """
    h, w = hw
    kh, kw = geometry.kh, geometry.kw
    hh, hw_ = geometry.halo
    nb = geometry.n_banks
    hb, wb = kept_il.shape[-2:]
    hbp, wbp = -(-(h + 2 * hh) // kh), -(-(w + 2 * hw_) // kw)
    mp = kept_il.new_zeros(kept_il.shape[:-3] + (nb, hbp + 2, wbp + 2))
    for s in range(nb):
        si, sj = divmod(s, kw)
        tb = ((si + hh) % kh) * kw + (sj + hw_) % kw
        oi = 1 + (si + hh) // kh
        oj = 1 + (sj + hw_) // kw
        mp[..., tb, oi:oi + hb, oj:oj + wb] = kept_il[..., s, :, :]
    return mp


def build_bank_masks(fmaps: torch.Tensor, capacity: int,
                     geometry: ConvGeometry = GEOM_3X3) -> BankedEvents:
    """Compact binary fmaps (..., H, W) straight into the n_banks RAM banks:
    the kept events (the first min(capacity, H*W) in (s, i, j) order, as
    in the queue) by cumulative ranks (:func:`ranked_keep`), banked in
    padded space."""
    *lead, h, w = fmaps.shape
    hh, hw_ = geometry.halo
    n = math.prod(lead)
    flat = fmaps.reshape(n, h, w).to(torch.bool)
    kept_il, count, seg_counts = ranked_keep(interlace(flat, geometry),
                                             capacity, (h, w))
    kept_map = deinterlace(kept_il, (h, w), geometry)
    padded = kept_map.new_zeros((n, h + 2 * hh, w + 2 * hw_))
    padded[:, hh:hh + h, hw_:hw_ + w] = kept_map
    masks = interlace(padded, geometry)
    return BankedEvents(masks=masks.reshape(*lead, *masks.shape[-3:]),
                        count=count.reshape(tuple(lead)),
                        seg_counts=seg_counts.reshape(*lead,
                                                      geometry.n_banks))


class FusedHandoff(NamedTuple):
    """Fused spike-emission carrier between adjacent conv layers.

    masks: (T, C, B, n_banks, HBp+2, WBp+2) bool — the kept events'
        centre-bank occupancy (the content of :class:`BankedEvents` masks)
        with one zero macro cell per side, laid out time-major and then
        input-channel-major for the consumer.
    count: (T, B, C) int32 spike demand per queue, before truncation.
    """

    masks: torch.Tensor
    count: torch.Tensor


def handoff_shape(t_steps: int, c: int, b: int, hw: tuple[int, int],
                  geometry: ConvGeometry = GEOM_3X3) -> tuple:
    """Shape of :attr:`FusedHandoff.masks` for an (H, W) fmap under
    ``geometry`` (the consumer's window)."""
    h, w = hw
    hh, hw_ = geometry.halo
    return (t_steps, c, b, geometry.n_banks,
            -(-(h + 2 * hh) // geometry.kh) + 2,
            -(-(w + 2 * hw_) // geometry.kw) + 2)


def check_handoff(ho: FusedHandoff, c: int, hw: tuple[int, int],
                  geometry: ConvGeometry = GEOM_3X3) -> None:
    """Raise unless ``ho`` is a carrier of C-channel (H, W) fmaps under
    ``geometry``: the bank count and the padded bank grid must be the
    consumer's, or its slices would read the wrong cells."""
    if ho.masks.ndim != 6 or ho.masks.dtype != torch.bool:
        raise ValueError(f"carrier masks must be (T, C, B, n_banks, HBp+2, "
                         f"WBp+2) bool, got {tuple(ho.masks.shape)} "
                         f"{ho.masks.dtype}")
    t_steps, _, b = ho.masks.shape[:3]
    want = handoff_shape(t_steps, c, b, hw, geometry)
    if ho.masks.shape[3] != want[3]:
        raise ValueError(f"carrier must carry {want[3]} columns for the "
                         f"{geometry.kh}x{geometry.kw} geometry, got "
                         f"{ho.masks.shape[3]}")
    if tuple(ho.masks.shape) != want:
        raise ValueError(f"carrier masks {tuple(ho.masks.shape)} do not "
                         f"match hw={tuple(hw)}, c={c} under the "
                         f"{geometry.kh}x{geometry.kw} geometry (want "
                         f"{want})")
    if tuple(ho.count.shape) != (t_steps, b, c) or ho.count.dtype != torch.int32:
        raise ValueError(f"carrier count must be ({t_steps}, {b}, {c}) int32, "
                         f"got {tuple(ho.count.shape)} {ho.count.dtype}")


def build_fused_handoff(spikes: torch.Tensor, capacity: int,
                        geometry: ConvGeometry = GEOM_3X3) -> FusedHandoff:
    """Compact a (B, T, H, W, C) spike chunk straight into the fused
    handoff carrier: one reshape/permute interlaces the chunk,
    :func:`ranked_keep` truncates, :func:`place_padded_banks` banks the
    kept centres.  Mask content and counts equal :func:`build_bank_masks`
    over the same fmaps."""
    b, t, h, w, c = spikes.shape
    kh, kw = geometry.kh, geometry.kw
    x = _pad_hw(spikes.to(torch.bool).movedim(-1, 2), -h % kh, -w % kw)
    hb, wb = x.shape[-2] // kh, x.shape[-1] // kw
    # (B, T, C, HB, kh, WB, kw) -> (T, C, B, kh, kw, HB, WB): interlace's
    # bank order s = kw*(i%kh) + j%kw
    il = x.reshape(b, t, c, hb, kh, wb, kw).permute(1, 2, 0, 4, 6, 3, 5)
    il = il.reshape(t, c, b, geometry.n_banks, hb, wb)
    kept_il, count, _ = ranked_keep(il, capacity, (h, w))
    return FusedHandoff(masks=place_padded_banks(kept_il, (h, w), geometry),
                        count=count.transpose(1, 2).contiguous())


# ---------------------------------------------------------------------------
# Streaming DVS ingestion: incremental AEQ append.
# ---------------------------------------------------------------------------

class StreamChunk(NamedTuple):
    """A fixed-depth buffer of raw DVS address events awaiting ingestion.

    events: (..., N, 4) int32, one (t, y, x, polarity) row per event: ``t``
        the time bin inside the ingestion window, ``polarity`` the input
        channel.  Rows beyond ``num`` are padding; rows with out-of-window
        coordinates are dropped on append.
    num: (...,) int32 valid leading rows per buffer.
    """

    events: torch.Tensor
    num: torch.Tensor

    @property
    def buffer(self) -> int:
        return self.events.shape[-2]


class StreamState(NamedTuple):
    """Ingestion state of one T-bin input window.

    banks: (..., T, C, n_banks, HB, WB) bool per-(bin, channel) pixel
        occupancy held in the interlace-column banks (bank
        s = kw*(y%kh) + x%kw, macro cell (y//kh, x//kw)); no dense (H, W)
        frame is kept.  Leading dims (a batch) pass through
        ``append_events_batched``.
    """

    banks: torch.Tensor


def init_stream_state(hw: tuple[int, int], t_bins: int, channels: int,
                      lead: tuple = (),
                      geometry: ConvGeometry = GEOM_3X3,
                      device="cuda") -> StreamState:
    """Empty ingestion state for a (T, C, H, W) input window."""
    h, w = hw
    hb, wb = -(-h // geometry.kh), -(-w // geometry.kw)
    return StreamState(banks=torch.zeros(
        (*lead, t_bins, channels, geometry.n_banks, hb, wb),
        dtype=torch.bool, device=device))


def make_stream_chunk(events, buffer: Optional[int] = None,
                      device="cuda") -> StreamChunk:
    """Pad an (N, 4) event list to a fixed-depth :class:`StreamChunk` on
    ``device``; ``buffer`` defaults to N, and pad rows carry t=-1 so they
    never land even where ``num`` is ignored."""
    ev = np.asarray(events, dtype=np.int32).reshape(-1, 4)
    n = ev.shape[0]
    depth = n if buffer is None else buffer
    if n > depth:
        raise ValueError(f"{n} events exceed the chunk buffer depth {depth}")
    out = np.full((depth, 4), -1, np.int32)
    out[:n] = ev
    return StreamChunk(events=torch.from_numpy(out).to(device),
                       num=torch.tensor(n, dtype=torch.int32, device=device))


def _append_rows(banks: torch.Tensor, events: torch.Tensor,
                 num: torch.Tensor, hw: tuple[int, int],
                 geometry: ConvGeometry) -> torch.Tensor:
    """Set the occupancy bit of every in-window row of ``events`` (L, N, 4)
    in ``banks`` (L, T, C, n_banks, HB, WB), in place; ``num`` (L,)."""
    h, w = hw
    t_bins, channels = banks.shape[1:3]
    ev = events.to(torch.int64)
    t, y, x, p = ev.unbind(-1)
    rows = torch.arange(ev.shape[-2], device=ev.device)
    ok = ((rows[None, :] < num[:, None])
          & (t >= 0) & (t < t_bins) & (y >= 0) & (y < h)
          & (x >= 0) & (x < w) & (p >= 0) & (p < channels))
    lead = torch.arange(ev.shape[0], device=ev.device)[:, None].expand_as(t)
    t, y, x, p, lead = t[ok], y[ok], x[ok], p[ok], lead[ok]
    banks[lead, t, p, column_index(y, x, geometry), y // geometry.kh,
          x // geometry.kw] = True
    return banks


def append_events(state: StreamState, chunk: StreamChunk,
                  hw: tuple[int, int],
                  geometry: ConvGeometry = GEOM_3X3) -> StreamState:
    """Merge one chunk of raw events into the ingestion state (a new
    state; ``state`` is left as it was).  Setting bits is idempotent, so
    duplicates (a pixel re-firing inside one bin) dedupe to the one bit
    the binned path sees; rows outside the (T, C, H, W) window and
    padding rows are dropped; any chunking or order of one event set
    gives the same state."""
    banks = _append_rows(state.banks.clone()[None], chunk.events[None],
                         chunk.num.reshape(1), hw, geometry)
    return StreamState(banks=banks[0])


def append_events_batched(state: StreamState, chunk: StreamChunk,
                          hw: tuple[int, int],
                          geometry: ConvGeometry = GEOM_3X3) -> StreamState:
    """:func:`append_events` over matching leading dims (e.g. a slot
    batch): banks (..., T, C, n_banks, HB, WB) + events (..., N, 4)."""
    lead = tuple(state.banks.shape[:-5])
    if (tuple(chunk.events.shape[:-2]) != lead
            or tuple(chunk.num.shape) != lead):
        raise ValueError(
            f"chunk leading dims {tuple(chunk.events.shape[:-2])} do not "
            f"match state leading dims {lead}")
    n = math.prod(lead)
    banks = _append_rows(
        state.banks.reshape(n, *state.banks.shape[-5:]).clone(),
        chunk.events.reshape(n, chunk.buffer, 4), chunk.num.reshape(n),
        hw, geometry)
    return StreamState(banks=banks.reshape(state.banks.shape))


def stream_frames(state: StreamState, hw: tuple[int, int],
                  geometry: ConvGeometry = GEOM_3X3) -> torch.Tensor:
    """Dense (..., T, C, H, W) bool view of the ingestion state: the frames
    the binned path builds from the same events."""
    _check_banks(state.banks, hw, geometry)
    return deinterlace(state.banks, hw, geometry)


def _check_banks(banks: torch.Tensor, hw: tuple[int, int],
                 geometry: ConvGeometry) -> None:
    h, w = hw
    kh, kw = geometry.kh, geometry.kw
    got_nb, hb, wb = banks.shape[-3:]
    if got_nb != geometry.n_banks:
        raise ValueError(f"stream banks must carry {geometry.n_banks} "
                         f"columns for the {kh}x{kw} geometry, got {got_nb}")
    if (hb, wb) != (-(-h // kh), -(-w // kw)):
        raise ValueError(f"stream banks {(hb, wb)} do not match hw={hw} "
                         f"under the {kh}x{kw} geometry")


def fused_handoff_from_banks(banks: torch.Tensor, capacity: int,
                             hw: tuple[int, int],
                             geometry: ConvGeometry = GEOM_3X3
                             ) -> FusedHandoff:
    """The fused carrier straight from streamed banks (B, T, C, n_banks,
    HB, WB): they already are the interlaced centre occupancy that
    :func:`build_fused_handoff` computes, so no dense frame is built: rank
    truncation, then :func:`place_padded_banks`.  Equal to binning the same
    events and calling :func:`build_fused_handoff`."""
    _check_banks(banks, hw, geometry)
    il = banks.permute(1, 2, 0, 3, 4, 5)          # (T, C, B, nb, HB, WB)
    kept_il, count, _ = ranked_keep(il, capacity, hw)
    return FusedHandoff(masks=place_padded_banks(kept_il, hw, geometry),
                        count=count.transpose(1, 2).contiguous())
