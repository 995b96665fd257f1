"""The context model code runs in on DTensors (``MeshMode``).

Inside it, plain tensors made during a step (masks, iotas, scalars) act as
replicated (DTensor's ``implicit_replication``), and three op families
run under explicit placement rules of their own — the port's counterpart
of JAX's ``with_sharding_constraint`` choke points, at the one place every
call passes (a dispatch mode):

* **views** (``view``, ``_unsafe_view``) that would split or merge a
  sharded dim unevenly (DTensor raises): that dim is first gathered over
  the offending mesh dims.  E.g. a projection whose output DTensor shards
  (heads x head_dim) over 16 ranks, reshaped to 4 heads;
* **constant pads** (``F.pad``): each rank pads its own block, the padded
  dims gathered first where they are sharded (DTensor's pad rule fails to
  plan its redistribution in torch 2.11);
* **flips** (torch 2.11 has no rule): local, the flipped dims gathered
  first where they are sharded;
* **gathers** (``x[indices]``; torch 2.11 fails to propagate the MoE's
  (experts, capacity, d) gather): per mesh dim local where ``x`` is
  sharded outside the indexed dims and the indices replicated, or ``x``
  replicated and the indices sharded alike; gathered otherwise;
* **index writes** (``index_put``, ``index_put_``; torch 2.11 has no rule
  for the in-place one and a broken one for the other): per mesh dim, a
  write stays local where the target is sharded on a dim before the
  indexed ones and the values alike (a batch-sharded cache), becomes a
  partial sum where an accumulating write scatters batch-sharded values
  into a replicated target (the embedding's gradient: reduced later onto
  the parameter's sharding), and is gathered otherwise.

``sites`` counts each (rule, op, shape, placements) that had to gather or
became partial: the explicit redistributions the dry run reports.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch


def _reshape_groups(src: list, dst: list) -> list:
    """[(input dims, output dims)] of a reshape: runs of dims whose
    products match."""
    out, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gi, gj, pi, pj = [], [], 1, 1
        if i < len(src):
            gi.append(i)
            pi *= src[i]
            i += 1
        if j < len(dst):
            gj.append(j)
            pj *= dst[j]
            j += 1
        while pi != pj:
            if (pi < pj and i < len(src)) or j >= len(dst):
                gi.append(i)
                pi *= src[i]
                i += 1
            else:
                gj.append(j)
                pj *= dst[j]
                j += 1
        out.append((gi, gj))
    return out


def uneven_view_dims(shape: tuple, placements: tuple, mesh_sizes: tuple,
                     new_shape: list) -> list[int]:
    """The mesh dims whose ``Shard`` DTensor cannot carry through a view of
    ``shape`` to ``new_shape``: a sharded dim that is not the outer one of
    the dims merged with it, or that is split into dims whose outer one
    does not divide by the shard count."""
    bad = []
    for gi, gj in _reshape_groups(list(shape), new_shape):
        lead_in = [d for d in gi if shape[d] != 1]
        lead_out = [d for d in gj if new_shape[d] != 1]
        n = 1
        for m, p in enumerate(placements):
            if not p.is_shard() or p.dim not in gi:
                continue
            n *= mesh_sizes[m]
            if (not lead_in or p.dim != lead_in[0] or not lead_out
                    or new_shape[lead_out[0]] % n):
                bad.append(m)
                n //= mesh_sizes[m]
    return bad


def _wrap(local: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    """A DTensor of global ``shape`` around this rank's ``local`` block,
    built as DTensor's own dispatch builds its outputs (no autograd
    function: the rules run below autograd)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    spec = DTensorSpec(mesh, tuple(placements),
                       tensor_meta=TensorMeta(shape, stride, local.dtype))
    return DTensor(local, spec, requires_grad=False)


def _to(t, mesh, placements) -> torch.Tensor:
    """DTensor ``t`` redistributed to ``placements`` (DTensor's own local
    redistribution, below autograd)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._redistribute import redistribute_local_tensor
    placements = tuple(placements)
    if placements == tuple(t.placements):
        return t
    target = DTensorSpec(mesh, placements, tensor_meta=t._spec.tensor_meta)
    return DTensor(redistribute_local_tensor(t._local_tensor, t._spec, target),
                   target, requires_grad=False)


def _replicate(t, mesh, dims) -> torch.Tensor:
    """DTensor ``t`` gathered (or reduced) over the mesh dims ``dims``."""
    from torch.distributed.tensor import Replicate
    return _to(t, mesh, [Replicate() if m in dims else p
                         for m, p in enumerate(t.placements)])


class MeshMode:
    """Enter around model code that runs on DTensors; see the module
    docstring.  Re-entrant use nests harmlessly."""

    def __init__(self):
        self.sites: dict = {}
        self._stack: Optional[contextlib.ExitStack] = None

    def __enter__(self):
        from torch.distributed.tensor.experimental import implicit_replication
        from torch.utils._python_dispatch import TorchDispatchMode

        owner = self

        class _Rules(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return owner._dispatch(func, types, args, kwargs or {})

        self._stack = contextlib.ExitStack()
        self._stack.enter_context(implicit_replication())
        self._stack.enter_context(_Rules())
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def _note(self, rule: str, func, x, extra=()) -> None:
        key = (rule, str(func), tuple(x.shape), *extra, str(tuple(x.placements)))
        self.sites[key] = self.sites.get(key, 0) + 1

    def _dispatch(self, func, types, args, kwargs):
        from torch.distributed.tensor import DTensor
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        aten = torch.ops.aten
        if func in (aten.view.default, aten._unsafe_view.default) \
                and isinstance(args[0], DTensor):
            return self._view(func, *args, **kwargs)
        if func is aten.constant_pad_nd.default and isinstance(args[0], DTensor):
            with torch.no_grad():
                return self._pad(func, *args, **kwargs)
        if func in (aten.index_put.default, aten.index_put_.default):
            with torch.no_grad():
                return self._index_put(func, *args, **kwargs)
        if func is aten.index.Tensor and isinstance(args[0], DTensor):
            with torch.no_grad():
                return self._index(func, *args, **kwargs)
        if func is aten.flip.default:
            with torch.no_grad():
                return self._flip(func, *args, **kwargs)
        return NotImplemented

    def _flip(self, func, x, dims):
        mesh = x.device_mesh
        flipped = {d % x.dim() for d in dims}
        gather = [m for m, p in enumerate(x.placements)
                  if (p.is_shard() and p.dim % x.dim() in flipped)]
        if gather:
            self._note("flip", func, x, (tuple(dims),))
        x = _replicate(x, mesh, gather)
        return _wrap(func(x._local_tensor, dims), mesh, x.placements, x.shape)

    def _index(self, func, x, indices):
        """A gather ``x[indices]`` (advanced indices on consecutive dims):
        per mesh dim local where ``x`` is sharded outside the indexed dims
        and the indices are replicated, or ``x`` is replicated and every
        index sharded on one dim alike; gathered otherwise."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh = x.device_mesh
        rep = (Replicate(),) * mesh.ndim
        idx = [i if i is None or isinstance(i, DTensor) else _wrap(i, mesh, rep, i.shape)
               for i in indices]
        pos = [k for k, i in enumerate(idx) if i is not None]
        given = [idx[k] for k in pos]
        idx_nd = max(i.dim() for i in given)
        contiguous = pos == list(range(pos[0], pos[-1] + 1))
        first, last = pos[0], pos[-1]
        out_pl, gather = [], []
        for m in range(mesh.ndim):
            px = x.placements[m]
            pis = [i.placements[m] for i in given]
            if px.is_replicate() and all(p.is_replicate() for p in pis):
                out_pl.append(Replicate())
            elif contiguous and px.is_shard() and all(p.is_replicate() for p in pis) \
                    and (px.dim < first or px.dim > last):
                out_pl.append(Shard(px.dim if px.dim < first
                                    else px.dim - len(pos) + idx_nd))
            elif contiguous and px.is_replicate() and pis[0].is_shard() \
                    and all(p == pis[0] for p in pis) and pis[0].dim < idx_nd:
                out_pl.append(Shard(first + pis[0].dim))
            else:
                out_pl.append(Replicate())
                gather.append(m)
        if gather:
            self._note("index", func, x, (str(tuple(given[0].placements)),))
        x = _replicate(x, mesh, gather)
        idx = [None if i is None else _replicate(i, mesh, gather) for i in idx]
        local = func(x._local_tensor,
                     [None if i is None else i._local_tensor for i in idx])
        shape = func(torch.empty(x.shape, device="meta"),
                     [None if i is None else torch.empty(i.shape, dtype=i.dtype,
                                                         device="meta")
                      for i in idx]).shape
        return _wrap(local, mesh, out_pl, shape)

    def _view(self, func, x, size, *rest, **kwargs):
        new_shape = list(size)
        if -1 in new_shape:
            k = new_shape.index(-1)
            rest_n = 1
            for i, d in enumerate(new_shape):
                rest_n *= d if i != k else 1
            new_shape[k] = x.numel() // max(rest_n, 1)
        mesh = x.device_mesh
        bad = uneven_view_dims(tuple(x.shape), tuple(x.placements),
                               tuple(mesh.shape), new_shape)
        if not bad:
            return NotImplemented
        self._note("view", func, x, (tuple(new_shape),))
        return func(_replicate(x, mesh, bad), size, *rest, **kwargs)

    def _pad(self, func, x, pad, value=0.0):
        mesh = x.device_mesh
        padded = {x.dim() - 1 - i // 2 for i, v in enumerate(pad) if v}
        gather = [m for m, p in enumerate(x.placements)
                  if (p.is_shard() and p.dim % x.dim() in padded) or p.is_partial()]
        if gather:
            self._note("pad", func, x, (tuple(pad),))
        x = _replicate(x, mesh, gather)
        local = func(x._local_tensor, pad, value)
        shape = func(torch.empty(x.shape, device="meta"), pad, value).shape
        return _wrap(local, mesh, x.placements, shape)

    def _index_put(self, func, x, indices, values, accumulate=False):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        inplace = func is torch.ops.aten.index_put_.default
        mesh = next(t.device_mesh for t in (x, values, *indices)
                    if isinstance(t, DTensor))
        rep = (Replicate(),) * mesh.ndim

        def dt(t):
            if t is None or isinstance(t, DTensor):
                return t
            return _wrap(t, mesh, rep, t.shape)

        xd, vd, idx = dt(x), dt(values), [dt(i) for i in indices]
        given = [i for i in idx if i is not None]
        first = next(k for k, i in enumerate(idx) if i is not None)
        idx_nd = max(i.dim() for i in given)
        full_rank = vd.dim() == xd.dim() - len(given) + idx_nd
        out_pl, gather = [], []
        for m in range(mesh.ndim):
            px, pv = xd.placements[m], vd.placements[m]
            pis = [i.placements[m] for i in given]
            if all(p.is_replicate() for p in (px, pv, *pis)):
                out_pl.append(Replicate())
            elif (px.is_shard() and px.dim < first and full_rank
                  and pv == Shard(px.dim) and all(p.is_replicate() for p in pis)):
                out_pl.append(px)                       # batch-local write
            elif (accumulate and first == 0 and px.is_replicate() and full_rank
                  and pv.is_shard() and pv.dim < idx_nd
                  and all(p == Shard(pv.dim) for p in pis)):
                out_pl.append(Partial())                # scattered partial sums
            else:
                out_pl.append(Replicate())
                gather.append(m)
        if gather or any(p.is_partial() for p in out_pl):
            self._note("index_put", func, xd, (tuple(vd.shape), str(tuple(vd.placements))))
        xd, vd = _replicate(xd, mesh, gather), _replicate(vd, mesh, gather)
        idx = [None if i is None else _replicate(i, mesh, gather) for i in idx]
        coord = mesh.get_coordinate()
        owner = all(coord[m] == 0 for m, p in enumerate(out_pl) if p.is_partial())
        xl = xd._local_tensor
        if not owner:   # the target's value counts once in the partial sum
            xl = torch.zeros_like(xl)
        elif not inplace or not isinstance(x, DTensor) or \
                tuple(out_pl) != tuple(x.placements):
            xl = xl.clone()
        local = torch.ops.aten.index_put_.default(
            xl, [None if i is None else i._local_tensor for i in idx],
            vd._local_tensor, accumulate)
        out = _wrap(local, mesh, out_pl, xd.shape)
        if not inplace:
            return out
        if not isinstance(x, DTensor):
            x.copy_(_to(out, mesh, rep)._local_tensor)
        elif tuple(out_pl) != tuple(x.placements):
            x._local_tensor.copy_(_to(out, mesh, x.placements)._local_tensor)
        return x
