"""Manual compute/communication overlap: collective matmuls over a mesh
axis (port of ``repro.sharding.overlap``).

A sharding propagator inserts all-gathers *before* the matmuls that
consume them; on a big mesh that serializes wire time behind compute.
The classic fix ("collective matmul") decomposes the gather into a ring
of ``ppermute`` steps, multiplying each arriving shard immediately.

Two schedules:
* :func:`psum_matmul` — Megatron row-parallel contraction with the
  reduction explicit;
* :func:`ring_weight_gather_matmul` — FSDP-style: weights sharded over
  the data axis are streamed around a ring and consumed block by block,
  so the parameter all-gather of ZeRO-3 overlaps with the matmul itself.

Both take global tensors (plain, the same on every rank, or DTensors) and
return DTensors; here the ring's sends are issued after each step's
product, as JAX's loop orders them.
"""
from __future__ import annotations

import torch

from .collectives import axis_index, axis_size, ppermute, psum, shard_map
from .specs import PartitionSpec as P


def psum_matmul(x: torch.Tensor, w: torch.Tensor, mesh, axis: str):
    """Row-parallel TP matmul: y = psum(x_shard @ w_shard).

    x: (B, D) sharded (None, axis); w: (D, F) sharded (axis, None);
    returns y: (B, F) replicated over ``axis``.
    """
    def body(xs, ws):
        return psum(xs @ ws, mesh, axis)

    return shard_map(body, mesh=mesh, in_specs=(P(None, axis), P(axis, None)),
                     out_specs=P())(x, w)


def ring_weight_gather_matmul(x: torch.Tensor, w: torch.Tensor, mesh,
                              axis: str):
    """FSDP overlap: y = x @ w with w row-sharded over the *batch* axis.

    x: (B, D) sharded (axis, None) — batch shards (ZeRO data parallelism);
    w: (D, F) sharded (axis, None) — parameter shards (ZeRO-3);
    returns y: (B, F) sharded (axis, None).

    Step i multiplies the D/n column slice of the local x block that
    matches the rows that just arrived, ``(idx - i) % n``, then passes the
    weight block on around the ring.
    """
    n = axis_size(mesh, axis)

    def body(x_blk, w_blk):
        idx = axis_index(mesh, axis)
        d_blk = w_blk.shape[0]
        perm = [(j, (j + 1) % n) for j in range(n)]
        acc = torch.zeros((x_blk.shape[0], w_blk.shape[1]),
                          dtype=torch.promote_types(x_blk.dtype, w_blk.dtype),
                          device=x_blk.device)
        wb = w_blk
        for i in range(n):
            src = (idx - i) % n  # which parameter rows just arrived
            acc = acc + x_blk[:, src * d_blk:(src + 1) * d_blk] @ wb
            wb = ppermute(wb, mesh, axis, perm)
        return acc.to(x_blk.dtype)

    return shard_map(body, mesh=mesh, in_specs=(P(axis, None), P(axis, None)),
                     out_specs=P(axis, None))(x, w)
