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

The collectives (JAX's ``sparse_psum``, ``quantize_grad`` and
``quantized_pmean``) wait for the port's mesh layer; this module holds
what one device computes.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.train.optimizer import tree_leaves, tree_map, tree_unflatten


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


def compression_ratio(tree_sizes: Any, density: float) -> float:
    """Wire-byte ratio dense-allreduce : sparse queues (8 bytes/entry)."""
    sizes = tree_leaves(tree_sizes)
    total = sum(sizes)
    k = sum(max(1, int(s * density)) for s in sizes)
    return (4.0 * total) / (8.0 * k)
