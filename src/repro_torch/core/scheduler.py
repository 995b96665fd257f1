"""Channel-multiplexed layer scheduling over a sample batch (paper
Sec. V-D, Algorithm 1; main-path port of ``repro.core.scheduler``).

Per conv layer and time chunk: ONE batched compaction builds every
(t, b, c_in) queue (``aeq.build_aeq_batched``, segment-padded when
``event_par`` > 1); then for each output-channel block, each time step
and each input channel, ONE conv-unit launch applies the B queues of that
(t, c_in) to the block's B membrane tiles, and one threshold-unit launch
per (block, t) adds the bias, fires against the m-TTFS latch and
OR-pools (the JAX package's per-step ``threshold_unit`` plus its
``_pool_all`` over the whole output, fused).  The membrane tiles are updated in place (the port's choice:
the Pallas kernels aliased their input the same way).

Variants (``LayerPlan.resolve_variant``):

* ``"sequential"`` — ``event_conv_cuda_batched``;
* ``"interlaced-cuda"`` — ``event_conv_cuda_interlaced_batched`` over
  segment-padded queues;
* ``"banked-jax"`` / ``"fused-handoff"`` — not ported yet; they raise.

The kernels' wrappers run their plain versions for CPU tensors, so the
same code is the CPU reference path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.event_conv.kernel import (
    event_conv_cuda_batched, event_conv_cuda_interlaced_batched)
from repro_torch.kernels.threshold_pool.kernel import \
    threshold_pool_cuda_batched

from .aeq import BatchedEventQueue, build_aeq_batched, segment_pad
from .plan import NOT_PORTED, LayerPlan


class LayerStats(NamedTuple):
    """Per-layer observability (Table III, capacity calibration)."""

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
    spikes_in: torch.Tensor,
    kernels: torch.Tensor,
    bias: torch.Tensor,
    v_t,
    lp: LayerPlan,
    carry: ConvCarry,
) -> tuple[torch.Tensor, ConvCarry, LayerStats]:
    """Step one conv layer through a chunk of time steps from ``carry``.

    spikes_in: (B, t_chunk, H, W, C_in) bool dense frames.  Returns
    (spikes_out (B, t_chunk, H', W', C_out) bool, new carry, chunk
    LayerStats).  Chaining chunks equals one whole-T call.
    """
    variant = lp.resolve_variant()
    if variant in ("banked-jax", "fused-handoff"):
        raise NotImplementedError(f"variant {variant!r} is {NOT_PORTED}")
    if not isinstance(spikes_in, torch.Tensor):
        raise NotImplementedError(
            "only dense spike frames are ported; fused-handoff carriers and "
            "streamed input are ROADMAP.md Queue 1 items")
    b_sz, t_steps, h, w, c_in = spikes_in.shape
    fmaps = spikes_in.permute(1, 0, 4, 2, 3)  # (t, B, C_in, H, W)
    queues = build_aeq_batched(fmaps, lp.capacity, geometry=lp.geometry)
    if lp.event_par > 1:
        queues = segment_pad(queues, lp.event_par, lp.geometry)
    sparsity = 1.0 - spikes_in.to(torch.float32).mean(dim=(1, 2, 3, 4))
    return _run_chunk_from_events(
        queues, queues.count, sparsity, (b_sz, t_steps, h, w, c_in),
        kernels, bias, v_t, lp, carry, variant=variant)


def _run_chunk_from_events(
    queues: BatchedEventQueue,
    counts: torch.Tensor,
    sparsity: torch.Tensor,
    shape: tuple[int, int, int, int, int],
    kernels: torch.Tensor,
    bias: torch.Tensor,
    v_t,
    lp: LayerPlan,
    carry: ConvCarry,
    *,
    variant: str,
) -> tuple[torch.Tensor, ConvCarry, LayerStats]:
    """Shared chunk body: consume the pre-built (t, B, C_in) queues."""
    b_sz, t_steps, h, w, c_in = shape
    c_out = kernels.shape[-1]
    cb = lp.channel_block
    n_blocks = c_out // cb
    vm_dtype = lp.vm_dtype
    hh, hw = lp.geometry.halo
    kh, kw = kernels.shape[:2]
    dev = carry.vm.device

    # one contiguous (B, cap[, 2]) slab per (t, c_in) launch
    coords = queues.coords.permute(0, 2, 1, 3, 4).contiguous()
    valid = queues.valid.permute(0, 2, 1, 3).contiguous()
    # weights cast like JAX's astype(vm.dtype) (truncation toward zero)
    kb = (kernels.reshape(kh, kw, c_in, n_blocks, cb).permute(3, 2, 0, 1, 4)
          .to(vm_dtype).contiguous())         # (n_blocks, C_in, kh, kw, Cb)
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

    for blk in range(n_blocks):
        vm = vm_b[blk]
        fired = fired0[blk]
        for t in range(t_steps):
            for ci in range(c_in):
                k_ci = kb[blk, ci]
                if variant == "interlaced-cuda":
                    event_conv_cuda_interlaced_batched(
                        vm, coords[t, ci], valid[t, ci], k_ci,
                        event_par=lp.event_par, out=vm)
                else:
                    event_conv_cuda_batched(vm, coords[t, ci], valid[t, ci],
                                            k_ci, out=vm)
            threshold_pool_cuda_batched(
                vm, bb[blk].contiguous(), fired, v_t=v_t, pool=lp.pool,
                halo=(hh, hw), fired_out=spikes[blk, t],
                pooled_out=None if pooled is None else pooled[blk, t])
            fired = spikes[blk, t]

    new_carry = ConvCarry(vm=_merge_blocks(vm_b),
                          fired=_merge_blocks(spikes[:, -1]))

    def merge(x):  # (n_blocks, t, B, H, W, Cb) -> (B, t, H, W, C_out)
        return x.permute(2, 1, 3, 4, 0, 5).reshape(
            x.shape[2], t_steps, x.shape[3], x.shape[4], c_out)

    spikes_out = merge(spikes)
    stats = LayerStats(
        in_spike_counts=counts.transpose(0, 1),  # (B, t, C_in)
        out_spike_counts=spikes_out.sum(dim=(2, 3), dtype=torch.int32),
        in_sparsity=sparsity,
        event_block=lp.block_e,
        event_par=lp.event_par,
    )
    if pooled is not None:
        return merge(pooled), new_carry, stats
    return spikes_out, new_carry, stats


def run_fc_head_batched(spikes_in: torch.Tensor, weights: torch.Tensor,
                        bias: torch.Tensor,
                        capacity: Optional[int] = None) -> torch.Tensor:
    """Classification unit over a batch: (B, T, ...) -> (B, n_classes).
    Integrate-only: drive @ W + T * b (:func:`head_product`)."""
    if capacity is not None:
        raise NotImplementedError(
            "fc_capacity (the event-driven sparse head) is not ported yet: "
            "see ROADMAP.md Queue 1, 'fc_capacity sparse head'")
    b_sz, t_steps = spikes_in.shape[:2]
    drive = spikes_in.reshape(b_sz, t_steps, -1).to(weights.dtype).sum(1)
    return head_product(drive, weights) + t_steps * bias


def head_product(drive: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``drive @ weights`` for the exact-integer spike-count drive, summed
    in float64 and rounded once to the weights' dtype.  No float32 (and so
    no TF32) product is involved, whatever the caller's
    ``torch.backends.cuda.matmul.allow_tf32``."""
    return (drive.double() @ weights.double()).to(weights.dtype)
