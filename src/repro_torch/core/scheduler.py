"""Channel-multiplexed layer scheduling (paper Sec. V-D, Algorithm 1;
port of ``repro.core.scheduler``).

Per conv layer and time chunk: ONE batched compaction (``_event_sets``)
builds every (t, b, c_in) event set from the layer's input, whatever its
form — dense frames, a fused-handoff carrier or a :class:`aeq.StreamState`
of ingested DVS events; then, for each output-channel block and each time
step, the conv unit applies the events of every input channel to the
block's B membrane tiles, and one threshold-unit launch per (block, t)
adds the bias, fires against the m-TTFS latch and OR-pools (the JAX
package's per-step ``threshold_unit`` plus its ``_pool_all`` over the
whole output, fused).  The membrane tiles are updated in place (the
port's choice: the Pallas kernels aliased their input the same way).

Variants (``LayerPlan.resolve_variant``):

* ``"sequential"`` — queues, one ``event_conv_cuda_batched`` launch per
  (block, t) over all input channels, applied channel by channel as the
  JAX package's ``c_in`` loop applies them;
* ``"interlaced-cuda"`` — segment-padded queues, one
  ``event_conv_cuda_interlaced_batched`` launch per (block, t) over all
  input channels: the same gather with the interlaced keep predicate;
* ``"banked-cuda"`` — padded bank masks (``aeq.build_bank_masks`` plus a
  zero macro cell per side), one ``event_conv_cuda_banked`` launch per
  (block, t) over all input channels;
* ``"fused-handoff"`` — the same kernel over the fused-handoff carrier.

The two queue variants build every (t, b, c_in) queue of the chunk with
one ``aeq.build_launch_queues`` (on the card one launch of the builder
kernel, ``kernels/aeq_build``), already in the launch layout.  Streamed
input takes the same route over its banks viewed as frames
(``aeq.stream_frames``); the fused variant takes its carrier straight
from the banks (``aeq.fused_handoff_from_banks``).

Fused spike emission.  The JAX package builds the carrier at the layer
boundary with ``aeq.build_fused_handoff`` of the producer's dense
output; its emit-mode threshold kernel computes the same carrier
(tests/test_fused_handoff.py).  The port produces it there: when the
next layer is pinned to ``"fused-handoff"``, ``snn_step_chunk`` hands
this runner the consumer's ``(capacity, geometry)`` as ``emit``, every
threshold launch is ``threshold_pool_cuda_emit`` writing its slab of the
carrier, and the runner returns the carrier in place of the dense
spikes.  At the network edge the fused layer builds its carrier from the
dense input with ``aeq.build_fused_handoff``.

One sample.  A batch of one (``run_conv_layer_planned`` runs the same
body on one) launches the single-queue kernels for its queue variants
(``event_conv_cuda`` and ``event_conv_cuda_interlaced``, the same
gather over one tile, one launch per (block, t)); the banked
variants feed the banked kernel a one-tile carrier (JAX builds it with
``build_fused_handoff`` at every layer of this path, so nothing is
emitted between layers there).  ``run_conv_layer_dense`` is the
frame-based oracle, ``run_fc_head`` the one-sample head; the kwargs
shims ``run_conv_layer`` and ``run_conv_layer_batched`` derive a
one-layer plan on the fly.

Spans.  Inside the layer's ``csnn.conv<i>`` (``csnn.snn_step_chunk``),
a batched chunk marks the build of its event sets and their layout for
the launches (``_event_sets``, then the per-block slabs) as
``csnn.conv<i>.queues`` (two ranges a chunk: the build, then the
layout), and the per-(block, t) launch loop as ``csnn.conv<i>.launches``
(args ``n_blocks``, ``t_steps``); ``conv<i>`` is the layer's parameter
key, its index among the conv layers, which precede the head.  Without a
profiler each costs one check (``runtime.spans``).

The kernels' wrappers run their plain versions for CPU tensors, so the
same code is the CPU reference path.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.kernels.event_conv.kernel import (
    event_conv_cuda, event_conv_cuda_banked, event_conv_cuda_batched,
    event_conv_cuda_interlaced, event_conv_cuda_interlaced_batched)
from repro_torch.kernels.threshold_pool.kernel import (
    threshold_pool_cuda_batched, threshold_pool_cuda_emit)
from repro_torch.runtime.spans import span

from .aeq import (FusedHandoff, StreamState, build_bank_masks,
                  build_fused_handoff, build_launch_queues, check_handoff,
                  fused_handoff_from_banks, handoff_shape, stream_frames)
from .event_conv import conv2d_same, tap_matrix
from .geometry import ConvGeometry
from .plan import LayerPlan, plan_conv_layer
from .threshold import as_vm_scalar, or_pool

#: the consumer's (capacity, geometry) a producer emits its carrier for
Emit = Optional[tuple[int, ConvGeometry]]
BANKED = ("banked-cuda", "fused-handoff")


class LayerStats(NamedTuple):
    """Per-layer observability (Table III, capacity calibration).  The
    batched runner gives the shapes below; ``run_conv_layer_planned``
    (one sample) drops the leading B."""

    in_spike_counts: torch.Tensor   # (B, T, C_in) events fed to the conv unit
    out_spike_counts: torch.Tensor  # (B, T, C_out) spikes (pre-pool)
    in_sparsity: torch.Tensor       # (B,) fraction of zeros in the input
    event_block: int = 0            # chosen block_e
    event_par: int = 1              # interlaced parallel width


class ConvCarry(NamedTuple):
    """One conv layer's carry between time steps over a sample batch."""

    vm: torch.Tensor     # (B, H+2hh, W+2hw, C_out) halo-padded potentials
    fired: torch.Tensor  # (B, H, W, C_out) bool m-TTFS latches


def init_conv_carry(lp: LayerPlan, batch: int, device="cuda") -> ConvCarry:
    """Fresh (all-zero) carry for one conv layer and ``batch`` samples."""
    h, w = lp.in_hw
    hh, hw = lp.geometry.halo
    return ConvCarry(
        vm=torch.zeros((batch, h + 2 * hh, w + 2 * hw, lp.c_out),
                       dtype=lp.vm_dtype, device=device),
        fired=torch.zeros((batch, h, w, lp.c_out), dtype=torch.bool,
                          device=device))


def _split_blocks(arr: torch.Tensor, n_blocks: int, cb: int) -> torch.Tensor:
    """(B, ..., C_out) -> (n_blocks, B, ..., Cb), contiguous: channel c maps
    to block c // Cb, lane c % Cb."""
    out = arr.reshape(arr.shape[:-1] + (n_blocks, cb))
    return out.movedim(-2, 0).contiguous()


def _merge_blocks(arr: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_split_blocks``."""
    out = arr.movedim(0, -2)
    return out.reshape(out.shape[:-2] + (-1,))


def run_conv_layer_batched_chunk(
    spikes_in: Union[torch.Tensor, FusedHandoff, StreamState],
    kernels: torch.Tensor,
    bias: torch.Tensor,
    v_t,
    lp: LayerPlan,
    carry: ConvCarry,
    *,
    emit: Emit = None,
    collect_stats: bool = True,
) -> tuple[Union[torch.Tensor, FusedHandoff], ConvCarry,
           Optional[LayerStats]]:
    """Step one conv layer through a chunk of time steps from ``carry``.

    spikes_in: (B, t_chunk, H, W, C_in) bool dense frames, the
    :class:`FusedHandoff` carrier a producer emitted for this layer (only
    when it is pinned to ``"fused-handoff"``), or a :class:`StreamState`
    of ingested input events with banks (B, t_chunk, C_in, n_banks, HB,
    WB) (equal to binning the events into frames).  ``emit``: the next
    layer's (capacity, geometry) when that layer is pinned to
    ``"fused-handoff"``.  Returns (spikes_out (B, t_chunk, H', W', C_out)
    bool — or, with ``emit``, the carrier of those spikes — new carry,
    chunk LayerStats, or None without ``collect_stats``: then no statistic
    is computed).  Chaining chunks equals one whole-T call.
    """
    variant = lp.resolve_variant()
    with span(f"{lp.name}.queues"):
        events, counts, sparsity, shape = _event_sets(
            spikes_in, lp, collect_stats=collect_stats)
    return _run_chunk_from_events(
        events, counts, sparsity, shape, kernels, bias, v_t, lp, carry,
        variant=variant, emit=emit, collect_stats=collect_stats)


def _event_sets(x: Union[torch.Tensor, FusedHandoff, StreamState],
                lp: LayerPlan, *, collect_stats: bool):
    """The conv unit's event sets of one chunk of a layer's input, in any
    of its three forms (dense frames, carrier, ingested banks), for the
    layer's variant: (events, demand (t, B, C_in), input sparsity (B,) or
    None without ``collect_stats``, chunk shape (B, t, H, W, C_in)).

    ``events`` are, for the queue variants, ``aeq.build_launch_queues``'s
    (coords, valid) over the dense frames (streamed banks viewed as
    frames: one builder launch on the card); for ``"banked-cuda"`` the
    bank masks with one zero macro cell per side (t, C_in, B, n_banks,
    HB+2, WB+2); for ``"fused-handoff"`` the carrier's masks — the one
    given, or built from the dense frames at the network edge or from the
    banks.  The sparsity is the frames' zero share, or for a carrier
    1 - demand / cells (integer sums below 2**24 in float32: exact).
    """
    variant = lp.resolve_variant()
    h, w = lp.in_hw
    if isinstance(x, FusedHandoff) and variant != "fused-handoff":
        raise ValueError(f"a FusedHandoff carrier feeds only a layer pinned "
                         f"to 'fused-handoff'; {lp.name} resolves to "
                         f"{variant!r}")
    if variant == "fused-handoff":
        if isinstance(x, FusedHandoff):
            check_handoff(x, lp.c_in, (h, w), lp.geometry)
            ho = x
        elif isinstance(x, StreamState):
            ho = fused_handoff_from_banks(x.banks, lp.capacity, (h, w),
                                          lp.geometry)
        else:  # the network edge: dense input frames
            ho = build_fused_handoff(x, lp.capacity, lp.geometry)
        t_steps, c_in, b_sz = ho.masks.shape[:3]
        sparsity = None
        if collect_stats:
            total = ho.count.to(torch.float32).sum(dim=(0, 2))
            sparsity = 1.0 - total / float(t_steps * h * w * c_in)
        return ho.masks, ho.count, sparsity, (b_sz, t_steps, h, w, c_in)
    if isinstance(x, StreamState):  # the banks' frame view
        x = stream_frames(x, (h, w), lp.geometry).permute(0, 1, 3, 4, 2)
    b_sz, t_steps, _, _, c_in = x.shape
    if variant == "banked-cuda":
        banked = build_bank_masks(x.permute(1, 0, 4, 2, 3), lp.capacity,
                                  lp.geometry)  # (t, B, C_in, H, W) maps
        m = banked.masks.transpose(1, 2)
        events = m.new_zeros(m.shape[:-2] + (m.shape[-2] + 2,
                                             m.shape[-1] + 2))
        events[..., 1:-1, 1:-1] = m
        counts = banked.count
    else:
        coords, valid, counts = build_launch_queues(
            x.to(torch.bool), lp.capacity, lp.event_par, lp.geometry)
        events = (coords, valid)
    sparsity = (1.0 - x.to(torch.float32).mean(dim=(1, 2, 3, 4))
                if collect_stats else None)
    return events, counts, sparsity, (b_sz, t_steps, h, w, c_in)


def _run_chunk_from_events(
    events: Union[tuple[torch.Tensor, torch.Tensor], torch.Tensor],
    counts: torch.Tensor,
    sparsity: Optional[torch.Tensor],
    shape: tuple[int, int, int, int, int],
    kernels: torch.Tensor,
    bias: torch.Tensor,
    v_t,
    lp: LayerPlan,
    carry: ConvCarry,
    *,
    variant: str,
    emit: Emit,
    collect_stats: bool,
) -> tuple[Union[torch.Tensor, FusedHandoff], ConvCarry,
           Optional[LayerStats]]:
    """Shared chunk body: consume the pre-built event sets — for the queue
    variants (coords (t, C_in, B, cap, 2), valid (t, C_in, B, cap)), one
    contiguous (C_in, B, cap) slab per t and conv launch; for the banked
    ones the padded bank masks (t, C_in, B, n_banks, HB+2, WB+2) — and
    their (t, B, C_in) demand.  Without ``collect_stats`` no LayerStats
    (the third result is None; ``sparsity`` is then None)."""
    b_sz, t_steps, h, w, c_in = shape
    single = b_sz == 1  # one queue per launch: the single-queue kernels
    c_out = kernels.shape[-1]
    cb = lp.channel_block
    n_blocks = c_out // cb
    vm_dtype = lp.vm_dtype
    hh, hw = lp.geometry.halo
    kh, kw = kernels.shape[:2]
    dev = carry.vm.device

    # the event sets laid out for the launches: one slab per (block, t)
    with span(f"{lp.name}.queues"):
        if variant in BANKED:
            # (nb, nb, C_in, C_out) tap routing -> (n_blocks, C_in, nb, nb,
            # Cb); weights cast like JAX's astype(vm.dtype) (truncation
            # toward zero)
            nb = lp.geometry.n_banks
            taps = (tap_matrix(kernels).to(vm_dtype)
                    .reshape(nb, nb, c_in, n_blocks, cb).permute(3, 2, 0, 1, 4)
                    .contiguous())
        else:
            coords, valid = events
            kb = (kernels.reshape(kh, kw, c_in, n_blocks, cb)
                  .permute(3, 2, 0, 1, 4).to(vm_dtype).contiguous())
            if variant == "interlaced-cuda":
                conv = partial(event_conv_cuda_interlaced_batched,
                               event_par=lp.event_par)
                conv_single = partial(event_conv_cuda_interlaced,
                                      event_par=lp.event_par)
            else:
                conv, conv_single = event_conv_cuda_batched, event_conv_cuda
        bb = bias.reshape(n_blocks, cb).to(vm_dtype)
        vm_b = _split_blocks(carry.vm.to(vm_dtype), n_blocks, cb)
        fired0 = _split_blocks(carry.fired, n_blocks, cb)
        spikes = torch.empty((n_blocks, t_steps, b_sz, h, w, cb),
                             dtype=torch.bool, device=dev)
        pooled = None
        if lp.pool is not None:
            oh, ow = -(-h // lp.pool), -(-w // lp.pool)
            pooled = torch.empty((n_blocks, t_steps, b_sz, oh, ow, cb),
                                 dtype=torch.bool, device=dev)
        if emit is not None:
            cap_e, geom_e = emit
            # carrier of the (post-pool) output; each launch writes the
            # contiguous slab [t, block's channels]
            out_masks = torch.empty(
                handoff_shape(t_steps, c_out, b_sz, lp.out_hw, geom_e),
                dtype=torch.bool, device=dev)
            out_count = torch.empty((t_steps, c_out, b_sz), dtype=torch.int32,
                                    device=dev)
            out_seg = torch.empty((t_steps, c_out, b_sz, geom_e.n_banks),
                                  dtype=torch.int32, device=dev)

    with span(f"{lp.name}.launches", n_blocks=n_blocks, t_steps=t_steps):
        for blk in range(n_blocks):
            vm = vm_b[blk]
            tile = vm[0]  # the sample's tile when the batch is one
            fired = fired0[blk]
            c0, c1 = blk * cb, (blk + 1) * cb
            for t in range(t_steps):
                if variant in BANKED:
                    event_conv_cuda_banked(vm, events[t], taps[blk],
                                           geometry=lp.geometry, out=vm)
                elif single:  # all C_in in one launch, on the one tile
                    conv_single(tile, coords[t, :, 0], valid[t, :, 0], kb[blk],
                                out=tile)
                else:
                    conv(vm, coords[t], valid[t], kb[blk], out=vm)
                pooled_t = None if pooled is None else pooled[blk, t]
                if emit is None:
                    threshold_pool_cuda_batched(
                        vm, bb[blk].contiguous(), fired, v_t=v_t, pool=lp.pool,
                        halo=(hh, hw), fired_out=spikes[blk, t],
                        pooled_out=pooled_t)
                else:
                    threshold_pool_cuda_emit(
                        vm, bb[blk].contiguous(), fired, v_t=v_t, pool=lp.pool,
                        halo=(hh, hw), emit_capacity=cap_e,
                        emit_geometry=geom_e,
                        fired_out=spikes[blk, t], pooled_out=pooled_t,
                        masks_out=out_masks[t, c0:c1],
                        count_out=out_count[t, c0:c1],
                        seg_counts_out=out_seg[t, c0:c1])
                fired = spikes[blk, t]

    new_carry = ConvCarry(vm=_merge_blocks(vm_b),
                          fired=_merge_blocks(spikes[:, -1]))

    def merge(x):  # (n_blocks, t, B, H, W, Cb) -> (B, t, H, W, C_out)
        return x.permute(2, 1, 3, 4, 0, 5).reshape(
            x.shape[2], t_steps, x.shape[3], x.shape[4], c_out)

    if emit is not None:
        out = FusedHandoff(masks=out_masks,
                           count=out_count.transpose(1, 2).contiguous())
    elif pooled is not None:
        out = merge(pooled)
    else:
        out = merge(spikes)
    stats = None
    if collect_stats:
        # the pre-pool spikes: a pooled or carrier output is merged again
        dense = merge(spikes) if emit is not None or pooled is not None \
            else out
        stats = LayerStats(
            in_spike_counts=counts.transpose(0, 1),  # (B, t, C_in)
            out_spike_counts=dense.sum(dim=(2, 3), dtype=torch.int32),
            in_sparsity=sparsity,
            event_block=lp.block_e,
            event_par=lp.event_par,
        )
    return out, new_carry, stats


def run_conv_layer_planned(
    spikes_in: torch.Tensor,
    kernels: torch.Tensor,
    bias: torch.Tensor,
    v_t,
    lp: LayerPlan,
) -> tuple[torch.Tensor, LayerStats]:
    """Run one spiking conv layer for all T steps of ONE sample,
    Algorithm-1 style.

    spikes_in: (T, H, W, C_in) bool; kernels (kh, kw, C_in, C_out)
    unrotated, the window matching ``lp.geometry``; bias (C_out,).
    Returns (spikes_out (T, H', W', C_out) bool, LayerStats with
    in_spike_counts (T, C_in), out_spike_counts (T, C_out) and a scalar
    in_sparsity).
    """
    carry = init_conv_carry(lp, 1, device=spikes_in.device)
    out, _, st = run_conv_layer_batched_chunk(
        spikes_in[None], kernels, bias, v_t, lp, carry)
    return out[0], st._replace(in_spike_counts=st.in_spike_counts[0],
                               out_spike_counts=st.out_spike_counts[0],
                               in_sparsity=st.in_sparsity[0])


def _shim_plan(spikes_shape, kernels, *, capacity, pool, channel_block,
               sat_bits, block_e=None) -> LayerPlan:
    """The one-layer plan of the kwargs shims (JAX's
    ``plan_conv_layer(0, "conv", ...)``)."""
    h, w, c_in = spikes_shape[-3:]
    return plan_conv_layer(
        0, "conv", (h, w), c_in, kernels.shape[-1], capacity=capacity,
        pool=pool, channel_block=channel_block, block_e=block_e,
        sat_bits=sat_bits,
        geometry=ConvGeometry.from_kernel_shape(kernels.shape))


def run_conv_layer(
    spikes_in: torch.Tensor,
    kernels: torch.Tensor,
    bias: torch.Tensor,
    v_t,
    *,
    capacity: int,
    pool: Optional[int] = None,
    channel_block: int = 1,
    sat_bits: Optional[int] = None,
) -> tuple[torch.Tensor, LayerStats]:
    """Kwargs shim over :func:`run_conv_layer_planned`: derives a
    one-layer plan from the loose knobs.  The membrane dtype follows
    ``sat_bits``; the tensors' device picks kernels or plain path."""
    lp = _shim_plan(spikes_in.shape, kernels, capacity=capacity, pool=pool,
                    channel_block=channel_block, sat_bits=sat_bits)
    return run_conv_layer_planned(spikes_in, kernels, bias, v_t, lp)


def run_conv_layer_batched_planned(
    spikes_in: torch.Tensor,
    kernels: torch.Tensor,
    bias: torch.Tensor,
    v_t,
    lp: LayerPlan,
) -> tuple[torch.Tensor, LayerStats]:
    """Algorithm 1 over a sample batch (B, T, H, W, C_in): one whole-T
    :func:`run_conv_layer_batched_chunk` from a fresh carry.  Returns
    (spikes_out (B, T, H', W', C_out), LayerStats)."""
    carry = init_conv_carry(lp, spikes_in.shape[0], device=spikes_in.device)
    spikes_out, _, stats = run_conv_layer_batched_chunk(
        spikes_in, kernels, bias, v_t, lp, carry)
    return spikes_out, stats


def run_conv_layer_batched(
    spikes_in: torch.Tensor,
    kernels: torch.Tensor,
    bias: torch.Tensor,
    v_t,
    *,
    capacity: int,
    pool: Optional[int] = None,
    channel_block: int = 1,
    sat_bits: Optional[int] = None,
    event_block: Optional[int] = None,
) -> tuple[torch.Tensor, LayerStats]:
    """Kwargs shim over :func:`run_conv_layer_batched_planned`
    (``event_block=None`` autotunes the event block)."""
    lp = _shim_plan(spikes_in.shape, kernels, capacity=capacity, pool=pool,
                    channel_block=channel_block, sat_bits=sat_bits,
                    block_e=event_block)
    return run_conv_layer_batched_planned(spikes_in, kernels, bias, v_t, lp)


def _pool_all(spikes: torch.Tensor, window: int) -> torch.Tensor:
    """OR-max-pool (..., H, W, C) binary maps over non-overlapping
    windows (ragged edges pad with False)."""
    return or_pool(spikes.movedim(-1, -3), window).movedim(-3, -1)


def run_conv_layer_dense(
    spikes_in: torch.Tensor,
    kernels: torch.Tensor,
    bias: torch.Tensor,
    v_t,
    *,
    pool: Optional[int] = None,
) -> torch.Tensor:
    """Frame-based oracle of :func:`run_conv_layer` (sliding-window conv,
    SIES-style), float32: every step vm += conv(x_t) + bias, spikes =
    (vm > v_t) | fired.  spikes_in (T, H, W, C_in) -> (T, H', W', C_out)
    bool.  The T convolutions run as one batched call."""
    u = conv2d_same(spikes_in.to(torch.float32), kernels.to(torch.float32))
    b = bias.to(torch.float32)
    thr = as_vm_scalar(v_t, torch.float32)
    vm = torch.zeros_like(u[0])
    fired = torch.zeros(u.shape[1:], dtype=torch.bool, device=u.device)
    spikes = []
    for t in range(u.shape[0]):
        vm = vm + u[t] + b
        fired = (vm > thr) | fired
        spikes.append(fired)
    out = torch.stack(spikes)
    return _pool_all(out, pool) if pool is not None else out


def fc_readout(drive: torch.Tensor, weights: torch.Tensor,
               bias: torch.Tensor, t_steps: int,
               capacity: Optional[int] = None) -> torch.Tensor:
    """Classification unit on the accumulated (..., D) spike drive:
    drive @ W + T * b (:func:`head_product`), never thresholded.
    ``capacity`` routes the drive through the event-driven sparse head
    (``sparse_ffn.event_readout``): top-``capacity`` compaction scattered
    back into the same product, equal to the dense head whenever the queue
    covers every nonzero drive entry."""
    if capacity is None:
        return head_product(drive, weights) + t_steps * bias
    from .sparse_ffn import event_readout  # it imports head_product from here
    return event_readout(drive, weights, capacity=capacity) + t_steps * bias


def run_fc_head(spikes_in: torch.Tensor, weights: torch.Tensor,
                bias: torch.Tensor,
                capacity: Optional[int] = None) -> torch.Tensor:
    """Classification unit (paper Sec. V-A) for one sample: (T, ...) ->
    (n_classes,) (:func:`fc_readout` of the summed spikes)."""
    t_steps = spikes_in.shape[0]
    drive = spikes_in.reshape(t_steps, -1).to(weights.dtype).sum(0)
    return fc_readout(drive, weights, bias, t_steps, capacity)


def run_fc_head_batched(spikes_in: torch.Tensor, weights: torch.Tensor,
                        bias: torch.Tensor,
                        capacity: Optional[int] = None) -> torch.Tensor:
    """Classification unit over a batch: (B, T, ...) -> (B, n_classes)
    (:func:`fc_readout` of each sample's summed spikes)."""
    b_sz, t_steps = spikes_in.shape[:2]
    drive = spikes_in.reshape(b_sz, t_steps, -1).to(weights.dtype).sum(1)
    return fc_readout(drive, weights, bias, t_steps, capacity)


def head_product(drive: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``drive @ weights`` for the exact-integer spike-count drive, summed
    in float64 and rounded once to the weights' dtype.  No float32 (and so
    no TF32) product is involved, whatever the caller's
    ``torch.backends.cuda.matmul.allow_tf32``."""
    return (drive.double() @ weights.double()).to(weights.dtype)
