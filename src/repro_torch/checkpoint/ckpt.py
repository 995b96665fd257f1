"""Checkpoints in the JAX package's on-disk layout (port of
``repro.checkpoint.ckpt``): a checkpoint written by either package
restores bit for bit in the other.

Layout (one directory per step, committed atomically by rename):

    ckpt_000000042.tmp/ -> ckpt_000000042/
        manifest.json            # step, per-leaf shape/dtype
        <leaf-path>__<bounds>.npy

A leaf's path is its keys joined by "/" ("params/groups/0/0/attn/wq",
"mu/embed", "step"): dict keys, list and tuple indices, dataclass field
names, in ``jax.tree`` order.  The file name replaces
"/" by "." and appends the leaf's global index bounds ("lo-hi" per axis,
joined by "x"; a 0-d leaf is "0-1"), so a checkpoint is mesh-agnostic:
restore assembles each leaf from whatever shard files hold it.  numpy
cannot store bfloat16: such a leaf is saved as its uint16 bits with
``"bf16_as_u16": true`` in the manifest.  A Python-int leaf (the
``TrainState``'s step) is saved as a 0-d int32 array, as JAX stores it.

* **Atomic**: a crash mid-save never corrupts the latest checkpoint;
  :func:`latest_step` only sees fully renamed directories.
* **Keep-k GC**: :func:`save` keeps the newest ``keep`` checkpoints.
* **Sharded**: a DTensor leaf is written by the ranks that hold its
  distinct blocks, each block once, under its global bounds (JAX's
  ``addressable_shards`` loop); a plain leaf by rank 0.  Rank 0 makes the
  directory, and writes the manifest and renames the directory after a
  barrier.  ``restore(..., shardings=)`` assembles each leaf and re-slices
  it onto the target mesh (elastic scaling: any other factorization).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


def _walk(tree: Any, prefix: tuple = (), leaf_type=()):
    """(path keys, leaf) in ``jax.tree_util.tree_flatten_with_path``
    order; an instance of ``leaf_type`` is a leaf."""
    if isinstance(tree, leaf_type):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,), leaf_type)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _walk(t, prefix + (i,), leaf_type)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _walk(getattr(tree, f.name), prefix + (f.name,),
                             leaf_type)
    else:
        yield prefix, tree


def _leaf_paths(tree: Any) -> list[tuple[str, Any]]:
    return [("/".join(str(k) for k in path) or "_root", leaf)
            for path, leaf in _walk(tree)]


def _rebuild(tree: Any, it) -> Any:
    """``tree``'s containers around the leaves ``it`` yields in
    :func:`_walk` order."""
    if isinstance(tree, dict):
        got = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: got[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), it)
            for f in dataclasses.fields(tree)})
    return next(it)


def _fname(leaf_name: str, bounds: tuple) -> str:
    b = "x".join(f"{lo}-{hi}" for lo, hi in bounds)
    return f"{leaf_name.replace('/', '.')}__{b}.npy"


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str, bool]:
    """A leaf -> (numpy data, dtype name, saved as bfloat16 bits)."""
    if isinstance(leaf, torch.Tensor):
        # a checkpoint copies the state to the host: every ckpt_every steps
        # and on preemption, as JAX's np.asarray of each shard
        t = leaf.detach().cpu()  # analysis: ignore[lint-host-sync-in-hot-path]
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            # analysis: ignore[lint-host-sync-in-hot-path] (a host tensor)
            return t.view(torch.int16).numpy().view(np.uint16), name, True
        return t.numpy(), name, False  # analysis: ignore[lint-host-sync-in-hot-path]
    arr = np.asarray(leaf)
    if arr.dtype == np.int64 and isinstance(leaf, int):
        arr = arr.astype(np.int32)    # JAX stores a Python int as int32
    return arr, str(arr.dtype), False


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _block(leaf) -> Optional[tuple]:
    """(local tensor, global bounds) of this rank's block of a DTensor, or
    None where a rank with a lower coordinate on a replicating mesh dim
    holds the same block."""
    mesh = leaf.device_mesh
    coord = mesh.get_coordinate()
    bounds = [[0, d] for d in leaf.shape]
    for i, p in enumerate(leaf.placements):
        if p.is_shard():
            lo, hi = bounds[p.dim]
            size = -(-(hi - lo) // mesh.size(i))  # torch.chunk's split
            bounds[p.dim] = [min(hi, lo + coord[i] * size),
                             min(hi, lo + (coord[i] + 1) * size)]
        elif p.is_replicate():
            if coord[i]:
                return None
        else:
            raise ValueError(f"cannot save a {p} DTensor")
    return leaf.to_local(), tuple(map(tuple, bounds)) or ((0, 1),)


def save(tree: Any, directory: str | os.PathLike, step: int, keep: int = 3) -> Path:
    """Save a tree of tensors, DTensors and Python ints on every rank of
    the default process group (or alone); returns the final path."""
    from torch.distributed.tensor import DTensor
    directory = Path(directory)
    tmp = directory / f"ckpt_{step:09d}.tmp"
    final = directory / f"ckpt_{step:09d}"
    rank = _rank()
    if rank == 0:
        directory.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
    _barrier()
    manifest = {"step": step, "leaves": {}}
    for name, leaf in _leaf_paths(tree):
        if isinstance(leaf, torch.Tensor):
            shape = list(leaf.shape)
            dtype = str(leaf.dtype).removeprefix("torch.")
        else:
            data, dtype, _ = _to_numpy(leaf)
            shape = list(data.shape)
        if isinstance(leaf, DTensor):
            block = _block(leaf)
        else:  # a plain leaf is whole on every rank: rank 0 writes it
            block = (leaf, tuple((0, d) for d in shape) or ((0, 1),)) \
                if rank == 0 else None
        if block is not None:
            np.save(tmp / _fname(name, block[1]), _to_numpy(block[0])[0])
        manifest["leaves"][name] = {"shape": shape, "dtype": dtype}
        if dtype == "bfloat16":
            manifest["leaves"][name]["bf16_as_u16"] = True
    _barrier()
    if rank == 0:
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        os.replace(tmp, final)
        _gc(directory, keep)
    _barrier()
    return final


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(m.group(1)) for p in directory.iterdir()
             if (m := re.fullmatch(r"ckpt_(\d+)", p.name))]
    return max(steps) if steps else None


def _gc(directory: Path, keep: int):
    steps = sorted(int(m.group(1)) for p in directory.iterdir()
                   if (m := re.fullmatch(r"ckpt_(\d+)", p.name)))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(directory / f"ckpt_{s:09d}", ignore_errors=True)


def _load_leaf_global(ckpt: Path, name: str, meta: dict) -> np.ndarray:
    """Assemble the full global array from its shard files (a shard that
    covers the whole leaf is returned as loaded)."""
    shape = tuple(meta["shape"])
    dtype = np.uint16 if meta.get("bf16_as_u16") else np.dtype(meta["dtype"])
    out = None
    pattern = re.compile(re.escape(name.replace("/", ".")) + r"__(.+)\.npy$")
    found = False
    for f in ckpt.iterdir():
        m = pattern.fullmatch(f.name)
        if not m:
            continue
        found = True
        data = np.load(f)
        if not shape:
            return data.reshape(())
        bounds = [tuple(map(int, b.split("-"))) for b in m.group(1).split("x")]
        if bounds == [(0, d) for d in shape] and data.dtype == dtype:
            return data.reshape(shape)
        if out is None:
            out = np.zeros(shape, dtype)
        idx = tuple(slice(lo, hi) for lo, hi in bounds)
        out[idx] = data.reshape(out[idx].shape)
    if not found:
        raise FileNotFoundError(f"no shards for leaf {name} in {ckpt}")
    return out


def _from_numpy(arr: np.ndarray, meta: dict, tmpl: Any, device,
                sharding) -> Any:
    if not isinstance(tmpl, torch.Tensor):
        # a numpy scalar, no device involved
        return type(tmpl)(arr.item())  # analysis: ignore[lint-host-sync-in-hot-path]
    if meta.get("bf16_as_u16"):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    t = t.to(tmpl.dtype).reshape(tmpl.shape)
    if sharding is not None:
        from torch.distributed.tensor import DTensor

        from repro_torch.sharding.specs import local_slice
        dev = torch.device(sharding.mesh.device_type if device is None
                           else device)
        local = local_slice(t, sharding).contiguous()
        # analysis: ignore[lint-host-sync-in-hot-path] (once, before a step)
        return DTensor.from_local(local.to(dev), sharding.mesh,
                                  sharding.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    dev = tmpl.device if device is None else torch.device(device)
    if dev.type == "meta":
        raise ValueError("a meta template needs device=")
    # a restore copies the state to the device once, before the first step
    return t.to(dev)  # analysis: ignore[lint-host-sync-in-hot-path]


def restore(template: Any, directory: str | os.PathLike, step: Optional[int] = None,
            device=None, shardings: Optional[Any] = None) -> tuple[Any, int]:
    """Restore into the structure of ``template``: its containers, each
    leaf's shape and dtype (a saved leaf of another dtype is converted, as
    JAX's restore converts).  Leaves land on ``device``, by default each
    template leaf's own; a template on the ``meta`` device (e.g.
    ``optimizer.abstract_state``) needs one.

    ``shardings``: a matching tree of ``sharding.specs.NamedSharding`` for
    the TARGET mesh (``tree_shardings``) — what makes restore elastic: each
    leaf is assembled and re-sliced onto whatever mesh the new job runs, a
    DTensor on ``device`` (by default the mesh's device type).  Returns
    (tree, step)."""
    from repro_torch.sharding.specs import NamedSharding
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    ckpt = directory / f"ckpt_{step:09d}"
    manifest = json.loads((ckpt / "manifest.json").read_text())
    leaves = _leaf_paths(template)
    shards = ([s for _, s in _walk(shardings, leaf_type=NamedSharding)]
              if shardings is not None else [None] * len(leaves))
    if len(shards) != len(leaves):
        raise ValueError(f"{len(shards)} shardings for {len(leaves)} leaves")
    out = []
    for (name, tmpl), sh in zip(leaves, shards):
        meta = manifest["leaves"][name]
        out.append(_from_numpy(_load_leaf_global(ckpt, name, meta), meta, tmpl,
                               device, sh))
    return _rebuild(template, iter(out)), step
