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


def _walk(tree: Any, prefix: tuple = ()):
    """(path keys, leaf) in ``jax.tree_util.tree_flatten_with_path``
    order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _walk(t, prefix + (i,))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _walk(getattr(tree, f.name), prefix + (f.name,))
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


def save(tree: Any, directory: str | os.PathLike, step: int, keep: int = 3) -> Path:
    """Save a tree of tensors (and Python ints); returns the final path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"ckpt_{step:09d}.tmp"
    final = directory / f"ckpt_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": {}}
    for name, leaf in _leaf_paths(tree):
        data, dtype, bf16 = _to_numpy(leaf)
        manifest["leaves"][name] = {"shape": list(data.shape), "dtype": dtype}
        if bf16:
            manifest["leaves"][name]["bf16_as_u16"] = True
        bounds = tuple((0, d) for d in data.shape) or ((0, 1),)
        np.save(tmp / _fname(name, bounds), data)
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    os.replace(tmp, final)
    _gc(directory, keep)
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


def _from_numpy(arr: np.ndarray, meta: dict, tmpl: Any, device) -> Any:
    if not isinstance(tmpl, torch.Tensor):
        # a numpy scalar, no device involved
        return type(tmpl)(arr.item())  # analysis: ignore[lint-host-sync-in-hot-path]
    if meta.get("bf16_as_u16"):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    dev = tmpl.device if device is None else torch.device(device)
    if dev.type == "meta":
        raise ValueError("a meta template needs device=")
    # a restore copies the state to the device once, before the first step
    return t.to(tmpl.dtype).reshape(tmpl.shape).to(dev)  # analysis: ignore[lint-host-sync-in-hot-path]


def restore(template: Any, directory: str | os.PathLike, step: Optional[int] = None,
            device=None) -> tuple[Any, int]:
    """Restore into the structure of ``template``: its containers, each
    leaf's shape and dtype (a saved leaf of another dtype is converted, as
    JAX's restore converts).  Leaves land on ``device``, by default each
    template leaf's own; a template on the ``meta`` device (e.g.
    ``optimizer.abstract_state``) needs one.  Returns (tree, step)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    ckpt = directory / f"ckpt_{step:09d}"
    manifest = json.loads((ckpt / "manifest.json").read_text())
    out = []
    for name, tmpl in _leaf_paths(template):
        meta = manifest["leaves"][name]
        out.append(_from_numpy(_load_leaf_global(ckpt, name, meta), meta, tmpl,
                               device))
    return _rebuild(template, iter(out)), step
