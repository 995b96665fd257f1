"""Production mesh construction (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
over the default process group, on an explicit device type (``cuda`` by
default, ``cpu`` with gloo when asked).  Every function builds a mesh of
exactly the world's size: a mesh that does not match the world raises,
nothing shrinks quietly.

:func:`init_distributed` starts the default process group: from torchrun's
environment when it is set (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``),
otherwise as a world of one in a ``HashStore`` (no network).  A caller
that starts its own group (a test over a ``FileStore``, the dry run's fake
group) skips it.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_distributed(device_type: str = "cuda") -> int:
    """Start the default process group if none is running; returns the
    world size.  Under torchrun each rank takes the GPU of its local rank."""
    if dist.is_initialized():
        return dist.get_world_size()
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: no CUDA device (pass "
                           "device_type='cpu' for gloo)")
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend_for(device_type), init_method="env://")
    else:
        dist.init_process_group(backend_for(device_type),
                                store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


def make_custom_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
                     device_type: str = "cuda"):
    """Any (shape, axes) over the whole world; the elastic-scaling entry
    point (the remesh planner in ``runtime/health.py`` picks the shape)."""
    from torch.distributed.device_mesh import init_device_mesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    size = 1
    for d in shape:
        size *= d
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != size:
        raise ValueError(f"a {shape} mesh needs a world of {size} ranks; the "
                         f"process group has "
                         f"{'none' if world is None else world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 = 256 ranks (data, model); 2x16x16 = 512 ranks (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_custom_mesh(shape, axes, device_type)


def make_smoke_mesh(device_type: str = "cuda"):
    """1x1 mesh with the production axis names: every sharded code path
    runs unchanged on one device."""
    return make_custom_mesh((1, 1), ("data", "model"), device_type)
