"""What one rank executes in a step, counted op by op (the port's
counterpart of ``repro.launch.hlo_cost``, which walks XLA's HLO).

:class:`OpCost` is a ``TorchDispatchMode``: the ops that reach it are the
ones a rank runs on its local tensors.  Under DTensor it declines each
DTensor op (DTensor then computes it on local shards and issues its
collectives, which reach this mode as ops on plain tensors) and skips the
ops DTensor's sharding propagation runs on fake tensors.  So "per device"
means one rank's local shapes: ``torch.utils.flop_counter`` would see a
DTensor op at its global shape.

Cost semantics (documented proxies, as JAX's):

* flops — 2 * prod(output dims) * contracted size per matmul-family op
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution`` as a
  product), split by the product's dtype; elementwise ops are ignored.
* bytes — only *materializing* ops touch HBM: products, reductions,
  sorts, gathers and scatters, copies, concatenations and pads, and
  collectives (``hlo_cost``'s set: a fused elementwise chain is free), as
  operand + output bytes; a gather (index, embedding) moves twice its
  output and a scatter twice its update, as ``hlo_cost`` charges a
  dynamic slice and a dynamic update.  torch's views (slice, select,
  transpose) move nothing.
* collectives — (kind, output bytes, ranks of the group) per op, wire
  bytes by ``roofline.collective_bytes``.

An eager program runs every iteration of its loops, each seen here, so
``hlo_cost``'s trip-count multipliers have no counterpart.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "convolution"}
_GATHER = {"index", "index_select", "gather", "embedding", "take"}
_SCATTER = {"index_put", "index_put_", "_index_put_impl_", "scatter",
            "scatter_", "scatter_add", "scatter_add_", "index_add",
            "index_add_", "index_copy", "index_copy_", "embedding_dense_backward",
            "index_fill", "masked_scatter"}
_MATERIALIZING = {
    "sum", "mean", "amax", "amin", "max", "min", "logsumexp", "prod", "var",
    "std", "norm", "linalg_vector_norm", "cumsum", "cumprod", "argmax",
    "argmin", "any", "all", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data",
    "sort", "topk", "clone", "copy_", "_to_copy", "cat", "stack",
    "constant_pad_nd", "flip", "roll", "repeat"}
# funcol op -> collective kind
_FUNCOL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
           "all_gather_into_tensor": "all-gather",
           "reduce_scatter_tensor": "reduce-scatter",
           "all_to_all_single": "all-to-all"}


def _bytes(x: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _group_ranks(group_name: str) -> list[int]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(group_name))


class OpCost(TorchDispatchMode):
    """Counts the ops of one rank while active.  Totals: ``flops_by_dtype``
    ({torch dtype: flops}), ``bytes``, ``collectives`` ([(kind, output
    bytes, ranks)]) and ``table`` ({op: [count, flops, bytes]})."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: dict = {}
        self.bytes = 0.0
        self.collectives: list = []
        self.table: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not any(isinstance(a, FakeTensor) for a in tree_leaves((args, kwargs))):
            self._count(func, args, out)
        return out

    def _add(self, name: str, flops: float, nbytes: float, dtype=None) -> None:
        row = self.table.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        if flops:
            self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0.0) + flops
        self.bytes += nbytes

    def _count(self, func, args, out) -> None:
        ns = func.namespace
        name = func.overloadpacket.__name__
        if ns == "_c10d_functional":
            if name in _FUNCOL:
                n_out = _bytes(out)
                self.collectives.append((_FUNCOL[name], n_out,
                                         _group_ranks(args[-1])))
                self._add(f"{ns}.{name}", 0.0, n_out)
            return
        if ns == "c10d" and name not in ("barrier", "monitored_barrier_"):
            # DTensor and the port's bodies issue functional collectives; a
            # process-group call here would go uncounted
            raise NotImplementedError(f"op_cost: c10d.{name} is not counted")
        if ns != "aten":
            return
        if name in _MATMUL:
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            contract = (math.prod(args[1].shape[1:]) if name == "convolution"
                        else a.shape[-1])
            flops = 2.0 * out.numel() * contract
            self._add(name, flops, _bytes(args) + _bytes(out), a.dtype)
        elif name in _GATHER:
            self._add(name, 0.0, 2.0 * _bytes(out))
        elif name in _SCATTER:
            upd = args[2] if len(args) > 2 else out
            self._add(name, 0.0, 2.0 * _bytes(upd))
        elif name in _MATERIALIZING:
            self._add(name, 0.0, _bytes(args) + _bytes(out))

    def rows(self) -> list[dict]:
        """The per-op table, largest bytes + flops first."""
        return [{"op": k, "count": v[0], "flops": v[1], "bytes": v[2]}
                for k, v in sorted(self.table.items(),
                                   key=lambda kv: -(kv[1][1] + kv[1][2]))]
