"""Logical-axis -> mesh-axis sharding rules (port of
``repro.sharding.specs``).

Every parameter/cache/input leaf carries logical axis names ("embed",
"vocab", "heads", "experts", "batch", "cache_seq", ...).  A rule set maps
logical names to mesh axes; :func:`resolve` turns a logical tuple into a
:class:`PartitionSpec`, dropping assignments that do not divide the
dimension or that would reuse a mesh axis twice — so one rule set serves
every architecture (e.g. "heads -> model" is skipped for gemma3's 4 heads
on a 16-way model axis instead of erroring).

Baseline layout:
  * batch/fsdp over ("pod", "data") — DP + ZeRO-3 parameter sharding
  * vocab/heads/kv_heads/mlp/experts over "model" — tensor/expert parallel
  * long-context decode (batch=1): KV-cache sequence over "data"
    (context parallelism) since the batch axis cannot shard.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims; :func:`resolve` also takes a ``{name: size}`` mapping (what JAX's
tests get from an ``AbstractMesh``).  A :class:`NamedSharding` yields
DTensor placements: a tensor dim over several mesh axes gets
``Shard(dim)`` on each of them, which DTensor splits in mesh order, so
such an entry must list its axes in mesh order (the default rules do); a
mesh dim of size one replicates (the spec keeps its name, as JAX's does).
:func:`shard_tree` is ``jax.tree.map(jax.device_put, tree, shardings)``:
each rank keeps its own slice of a tensor every rank holds whole, with no
communication.

:func:`constrain` is the counterpart of ``with_sharding_constraint`` at
the models' propagation choke points: a no-op without a registered mesh,
a redistribution of the DTensor to the rule-resolved placements with one.
Model code runs on DTensors inside ``sharding.mesh_mode.MeshMode``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

from repro_torch.train.optimizer import TrainState


def default_rules(*, phase: str = "train", long_context: bool = False) -> dict:
    fsdp = ("pod", "data")  # resolve() drops "pod" when the mesh lacks it
    rules = {
        "batch": fsdp,
        "seq": ("seq",),   # sequence parallelism when the mesh has a seq axis
        "vocab": ("model",),
        "embed": fsdp,
        "heads": ("model",),
        "kv_heads": ("model",),
        "heads_flat": ("model",),
        "head_dim": (),
        "mlp": ("model",),
        "embed2": fsdp,          # rwkv channel-mix receptance (d, d) second dim
        "expert_mlp": (),
        "experts": ("model",),
        "q_lora": (),
        "kv_lora": (),
        "layers": (),
        "cache_seq": (),
    }
    if phase == "decode":
        # serving layout: weights replicated over the data axis (they fit
        # once the model axis shards them) — no per-step weight all-gather
        rules["embed"] = ()
        rules["embed2"] = ()
    if long_context:
        # batch=1: shard the KV cache / sequence over "data" instead
        rules["batch"] = ()
        rules["cache_seq"] = ("data",)
        rules["seq"] = ("data",)
    return rules


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per tensor dim, each None
    (replicated), a mesh axis name, or a tuple of them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, or the mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def resolve(axes: Optional[tuple], shape: tuple, rules: dict,
            mesh) -> PartitionSpec:
    """Logical axes tuple -> PartitionSpec valid for ``shape`` on ``mesh``."""
    if axes is None:
        return PartitionSpec()
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    entries = []
    for dim, name in zip(shape, axes):
        cand = rules.get(name, ()) if name is not None else ()
        if isinstance(cand, str):
            cand = (cand,)
        picked = []
        prod = 1
        for ax in cand:
            if ax not in sizes or ax in used:
                continue
            nxt = prod * sizes[ax]
            if dim % nxt == 0:
                picked.append(ax)
                prod = nxt
        used.update(picked)
        if not picked:
            entries.append(None)
        elif len(picked) == 1:
            entries.append(picked[0])
        else:
            entries.append(tuple(picked))
    return PartitionSpec(*entries)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a DeviceMesh; :attr:`placements` are its DTensor form."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            group = (entry,) if isinstance(entry, str) else tuple(entry)
            where = [names.index(ax) for ax in group]
            if where != sorted(where):
                raise ValueError(f"{self.spec}: the axes of dim {dim} are not "
                                 f"in mesh order {tuple(names)}")
            for i in where:
                if self.mesh.size(i) > 1:  # a shard over one rank is the whole
                    out[i] = Shard(dim)
        return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _map2(fn, axes_tree: Any, other: Any) -> Any:
    """``fn(axes, leaf)`` over two trees of one structure: dicts, lists,
    tuples and ``TrainState``s, an axes tuple a leaf."""
    if _is_axes(axes_tree):
        return fn(axes_tree, other)
    if isinstance(axes_tree, TrainState):
        return TrainState(**{f.name: _map2(fn, getattr(axes_tree, f.name),
                                           getattr(other, f.name))
                             for f in dataclasses.fields(TrainState)})
    if isinstance(axes_tree, dict):
        return {k: _map2(fn, axes_tree[k], other[k]) for k in axes_tree}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(_map2(fn, a, o)
                               for a, o in zip(axes_tree, other))
    raise TypeError(f"not a logical-axes leaf: {axes_tree!r}")


def _shape(leaf) -> tuple:
    if isinstance(leaf, (tuple, list)) and all(isinstance(d, int) for d in leaf):
        return tuple(leaf)
    return tuple(getattr(leaf, "shape", ()))


def tree_shardings(mesh, axes_tree: Any, shape_tree: Any, rules: dict) -> Any:
    """A NamedSharding tree from (logical axes tree, tree of tensors or
    shapes); a ``TrainState`` of axes (``optimizer.state_logical_axes``)
    gives a ``TrainState`` of shardings, its step replicated."""
    return _map2(lambda axes, leaf: NamedSharding(
        mesh, resolve(tuple(axes), _shape(leaf), rules, mesh)),
        axes_tree, shape_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def local_slice(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of ``t`` (the whole global tensor) under
    ``sharding``: each mesh dim that shards a tensor dim cuts it evenly, in
    mesh order."""
    mesh = sharding.mesh
    coord = mesh.get_coordinate()
    for i, p in enumerate(sharding.placements):
        if p.is_shard():
            n = mesh.size(i)
            if t.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                                 f"split over {n}")
            t = t.chunk(n, dim=p.dim)[coord[i]]
    return t


def put(t: Any, sharding: NamedSharding):
    """``jax.device_put(t, sharding)`` on this rank: a DTensor of
    ``t``'s (global) value from its local slice (the same tensor on every
    rank, as a seeded init or a restore gives it); a DTensor is
    redistributed.  A Python number (the step) stays as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, torch.Tensor):
        return t
    if isinstance(t, DTensor):
        return t.redistribute(sharding.mesh, sharding.placements)
    return DTensor.from_local(local_slice(t, sharding).contiguous(),
                              sharding.mesh, sharding.placements,
                              run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape, device="meta").stride())


def shard_tree(tree: Any, shardings: Any) -> Any:
    """``jax.tree.map(jax.device_put, tree, shardings)``."""
    if isinstance(shardings, NamedSharding):
        return put(tree, shardings)
    if isinstance(shardings, TrainState):
        return TrainState(**{f.name: shard_tree(getattr(tree, f.name),
                                                getattr(shardings, f.name))
                             for f in dataclasses.fields(TrainState)})
    if isinstance(shardings, dict):
        return {k: shard_tree(tree[k], shardings[k]) for k in shardings}
    if isinstance(shardings, (list, tuple)):
        return type(shardings)(shard_tree(t, s)
                               for t, s in zip(tree, shardings))
    raise TypeError(f"not a sharding: {shardings!r}")


def batch_devices(n_devices: Optional[int] = None) -> list[torch.device]:
    """The first ``n_devices`` visible CUDA devices (all of them when
    None): the devices ``core.csnn.snn_apply_sharded`` splits a batch over
    (JAX's ``batch_mesh``).  A device may appear more than once: its
    shards then run on streams of their own.  Raises when CUDA is absent
    or fewer devices exist than asked for: there is no CPU fallback (pass
    CPU devices explicitly)."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0:
        raise RuntimeError("batch_devices: no CUDA device is visible; pass "
                           "devices= explicitly to run on the CPU")
    n = have if n_devices is None else n_devices
    if not 1 <= n <= have:
        raise ValueError(f"requested {n_devices} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


# ---------------------------------------------------------------------------
# Activation sharding constraints
# ---------------------------------------------------------------------------
# DTensor's propagation may keep an activation sharded in a way that costs
# memory downstream (XLA's analogue: the CE loss scan compiled with fully
# replicated (B, S, V) logits).  Launchers register the mesh + rules here;
# model code calls ``constrain`` at the choke points.  Without a registered
# mesh (unit tests, one device) it is a no-op.

_CONSTRAINT_MESH: list = [None, None]  # [mesh, rules]


def set_constraint_mesh(mesh, rules: Optional[dict] = None):
    _CONSTRAINT_MESH[0] = mesh
    _CONSTRAINT_MESH[1] = rules


def constraint_mesh():
    """The registered mesh, or None."""
    return _CONSTRAINT_MESH[0]


def constrain(x: torch.Tensor, logical_axes: tuple) -> torch.Tensor:
    """Redistribute a DTensor activation to the rule-resolved placements
    (no-op without a registered mesh).  With a mesh registered, a plain
    tensor here means the state or batch was never placed: an error."""
    mesh, rules = _CONSTRAINT_MESH
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain{logical_axes}: a plain tensor of shape "
                        f"{tuple(x.shape)} under a registered mesh (place the "
                        f"state and the batch with shard_tree)")
    spec = resolve(logical_axes, tuple(x.shape), rules or default_rules(), mesh)
    want = NamedSharding(mesh, spec).placements
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
