"""Gradient event-compression with error feedback, its local half (port
of ``repro.sharding.compression``).

This is the paper's core idea applied to the collective layer: just as
the accelerator compresses sparse binary activations into fixed-capacity
Address-Event Queues so that work scales with the active set, gradients
are compressed into fixed-capacity (index, value) queues — top-k
magnitude selection — before the data-parallel reduction, cutting
all-reduce bytes from O(N) to O(2k).

Error feedback (Stich et al.) accumulates what compression dropped and
re-injects it next step, which keeps SGD/Adam convergence.

``sparse_psum`` runs the compressed reduction over a mesh axis: each
data shard contributes its queue; queues are all-gathered (2k * n_shards
entries, still << dense when k << N/n) and scatter-added locally.
``quantized_pmean`` is the int8 counterpart: stochastically rounded
payloads, all-gathered and averaged.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.xla_arith import reciprocal_f32
from repro_torch.train.optimizer import tree_leaves, tree_map, tree_unflatten
from .collectives import all_gather, axis_size, shard_map
from .specs import PartitionSpec as P


class CompressedGrad(NamedTuple):
    indices: torch.Tensor  # (k,) int32 into the flattened tensor
    values: torch.Tensor   # (k,)
    size: int              # original flat size


def compress_topk(flat: torch.Tensor, k: int) -> CompressedGrad:
    """AEQ for gradients: keep the k largest-magnitude entries, the lower
    index first among equal magnitudes (``lax.top_k``'s order: a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return CompressedGrad(indices=idx.to(torch.int32), values=flat[idx],
                          size=flat.shape[0])


def decompress(c: CompressedGrad) -> torch.Tensor:
    return torch.zeros((c.size,), dtype=c.values.dtype,
                       device=c.values.device).index_add_(
        0, c.indices.long(), c.values)


class EFState(NamedTuple):
    """Per-leaf error-feedback residual (what compression dropped so far)."""
    residual: Any

    @staticmethod
    def init(grads: Any) -> "EFState":
        return EFState(tree_map(torch.zeros_like, grads))


def compress_with_error_feedback(grads: Any, ef: EFState, density: float):
    """tree of grads -> (tree of CompressedGrad, new EFState).

    compensated = grad + residual; transmitted = topk(compensated);
    new residual = compensated - decompress(transmitted).
    """
    def one(g, r):
        flat = (g.reshape(-1).to(torch.float32)
                + r.reshape(-1).to(torch.float32))
        k = max(1, int(flat.shape[0] * density))
        c = compress_topk(flat, k)
        new_r = (flat - decompress(c)).reshape(g.shape).to(r.dtype)
        return c, new_r

    pairs = [one(g, r) for g, r in zip(tree_leaves(grads),
                                       tree_leaves(ef.residual))]
    comp = tree_unflatten(grads, [p[0] for p in pairs])
    return comp, EFState(tree_unflatten(grads, [p[1] for p in pairs]))


def sparse_psum(c: CompressedGrad, mesh, axis: str):
    """Compressed data-parallel reduction of ONE tensor's queue.

    Each rank passes its own queue; the (index, value) queues of every
    rank of ``axis`` are all-gathered (wire = 2k * n vs N for a dense
    all-reduce) and scatter-added locally.  Returns the dense averaged
    gradient, a DTensor replicated over the mesh.
    """
    n = axis_size(mesh, axis)

    def body(idx, val):
        all_idx = all_gather(idx, mesh, axis)   # (n, k)
        all_val = all_gather(val, mesh, axis)   # (n, k)
        dense = torch.zeros((c.size,), dtype=val.dtype, device=val.device)
        dense.index_add_(0, all_idx.reshape(-1).long(), all_val.reshape(-1))
        return dense / n

    return shard_map(body, mesh=mesh, in_specs=(P(), P()), out_specs=P())(
        c.indices, c.values)


def compression_ratio(tree_sizes: Any, density: float) -> float:
    """Wire-byte ratio dense-allreduce : sparse queues (8 bytes/entry)."""
    sizes = tree_leaves(tree_sizes)
    total = sum(sizes)
    k = sum(max(1, int(s * density)) for s in sizes)
    return (4.0 * total) / (8.0 * k)


# ---------------------------------------------------------------------------
# int8 quantized all-reduce
# ---------------------------------------------------------------------------


class QuantizedTensor(NamedTuple):
    q: torch.Tensor       # int8 payload
    scale: torch.Tensor   # () per-tensor scale


def _quantize(g: torch.Tensor, uniform: torch.Tensor) -> QuantizedTensor:
    """:func:`quantize_grad` given its uniform [0, 1) draw.  The scale is
    ``amax`` times the float32 reciprocal of 127, as XLA compiles JAX's
    division by the constant."""
    amax = torch.clamp(g.abs().max(), min=1e-12)
    scale = amax * float(reciprocal_f32(127.0))
    scaled = g.to(torch.float32) / scale
    q = torch.clamp(torch.round(scaled + (uniform - 0.5)), -127, 127)
    return QuantizedTensor(q=q.to(torch.int8), scale=scale)


def quantize_grad(g: torch.Tensor, generator: torch.Generator) -> QuantizedTensor:
    """Symmetric int8 quantization with stochastic rounding (unbiased:
    E[dequant(quant(g))] = g, which is what keeps SGD convergent when the
    all-reduce payload is quantized 4x).  The noise is drawn from
    ``generator`` (on its own device)."""
    u = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                   device=generator.device).to(g.device)
    return _quantize(g, u)


def dequantize_grad(t: QuantizedTensor) -> torch.Tensor:
    return t.q.to(torch.float32) * t.scale


def quantized_pmean(g: torch.Tensor, generator: torch.Generator, mesh,
                    axis: str) -> torch.Tensor:
    """Data-parallel mean with an int8 wire payload, inside a per-rank body
    (:func:`repro_torch.sharding.collectives.shard_map`): each rank
    quantizes its ``g`` locally; the int8 payloads are all-gathered (wire =
    N/4 of float32) and dequantized and averaged locally.  Scales ride
    along (4 bytes per rank per tensor)."""
    t = quantize_grad(g, generator)
    all_q = all_gather(t.q, mesh, axis)             # (n, ...)
    all_s = all_gather(t.scale, mesh, axis)         # (n,)
    deq = all_q.to(torch.float32) * all_s.reshape(-1, *([1] * g.dim()))
    return deq.mean(dim=0)
