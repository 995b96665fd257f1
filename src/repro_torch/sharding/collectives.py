"""Per-rank bodies over a mesh axis: the port's ``shard_map`` and the
``jax.lax`` collectives its bodies call (``axis_index``, ``psum``,
``all_gather``, ``ppermute``).

:func:`shard_map` takes global values (DTensors, or plain tensors every
rank holds whole), hands ``body`` each rank's local block under
``in_specs``, and wraps what ``body`` returns as DTensors under
``out_specs``: the counterpart of ``jax.shard_map`` (``repro/compat.py``
only papers over JAX versions and has no counterpart).  Inside the body
the collectives run over ``mesh.get_group(axis)`` with
``torch.distributed``: gloo on the CPU, NCCL on the card.

:func:`psum`'s gradient is the identity, as JAX's transpose of a ``psum``
whose result is replicated over the axis; the others are forward-only.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from .specs import NamedSharding, PartitionSpec, local_slice


def _dim(mesh, axis: str) -> int:
    return list(mesh.mesh_dim_names).index(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(_dim(mesh, axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def _all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(x, "sum", (mesh, _dim(mesh, axis))))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``lax.psum``)."""
    return _PSum.apply(x, mesh, axis)


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` stacked in axis order
    (``lax.all_gather``)."""
    from torch.distributed import _functional_collectives as funcol
    n = axis_size(mesh, axis)
    flat = funcol.wait_tensor(funcol.all_gather_tensor(
        x.contiguous().reshape(-1), 0, (mesh, _dim(mesh, axis))))
    return flat.reshape(n, *x.shape)


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: rank ``src`` of ``axis`` sends ``x`` to rank
    ``dst`` for each (src, dst) pair; a rank no pair sends to gets zeros."""
    me = axis_index(mesh, axis)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    send_to = [d for s, d in perm if s == me]
    recv_from = [s for s, d in perm if d == me]
    out = torch.zeros_like(x)
    if send_to == [me] and recv_from == [me]:
        return x.clone()
    ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[d], group)
           for d in send_to]
    ops += [dist.P2POp(dist.irecv, out, ranks[s], group) for s in recv_from]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _map_spec(fn: Callable, tree: Any, spec) -> Any:
    """``fn(leaf, spec)`` over a tree that ``spec`` prefixes."""
    if isinstance(tree, dict):
        return {k: _map_spec(fn, v, spec) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(_map_spec(fn, v, spec) for v in tree)
    return fn(tree, spec)


def _padded(spec: PartitionSpec, ndim: int) -> PartitionSpec:
    return PartitionSpec(*spec, *([None] * (ndim - len(spec))))


def shard_map(body: Callable, *, mesh, in_specs: tuple, out_specs) -> Callable:
    """``jax.shard_map(body, mesh=, in_specs=, out_specs=)``: each spec
    prefixes its argument's tree (a dict of stacked weights under one
    spec); ``out_specs`` is one spec or a tuple, one per output."""
    from torch.distributed.tensor import DTensor

    def to_local(x, spec):
        sh = NamedSharding(mesh, _padded(spec, x.dim()))
        if isinstance(x, DTensor):
            return x.redistribute(mesh, sh.placements).to_local()
        return local_slice(x, sh)

    def from_local(y, spec):
        sh = NamedSharding(mesh, _padded(spec, y.dim()))
        return DTensor.from_local(y, mesh, sh.placements, run_check=False)

    def wrapped(*args):
        local = [_map_spec(to_local, a, s) for a, s in zip(args, in_specs)]
        out = body(*local)
        if isinstance(out_specs, PartitionSpec):
            return _map_spec(from_local, out, out_specs)
        return tuple(_map_spec(from_local, o, s) for o, s in zip(out, out_specs))

    return wrapped
