"""Versioned on-disk plan cache of the measured tuner (port of
``repro.tune.cache``).

One JSON file holds every tuned network this machine has measured, keyed
by a digest of (layer geometry + planning knobs, vm dtype, torch and CUDA
versions, device name and compute capability): the inputs that can change
which schedule wins.  Location: the ``cache_path`` argument, else the
``REPRO_TORCH_PLAN_CACHE`` environment variable, else
``~/.cache/repro_torch/plan_cache.json`` — never the JAX package's file.

Entries store the winning knobs (block_e / event_par / variant per layer,
per_layer capacity sharing, t_chunk), never a pickled
plan.  On load the plan is rebuilt through ``plan_network`` and must
reproduce the recorded resolved values (fixed-point check), pass
``NetworkPlan.validate`` and pass ``repro_torch.analysis.audit_plan``
(``autotune.plan_from_winners``); a stale, hand-edited or corrupt entry
is a miss.  Writes are atomic (tmp file + ``os.replace``), so a crashed
tune never corrupts cached winners.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Optional

import torch

# Bump whenever the winners schema or the knob-resolution rules change in
# a way that invalidates old entries wholesale.
CACHE_VERSION = 2

ENV_VAR = "REPRO_TORCH_PLAN_CACHE"
_DEFAULT = "~/.cache/repro_torch/plan_cache.json"


def default_cache_path() -> Path:
    """``REPRO_TORCH_PLAN_CACHE`` or the per-user default location."""
    return Path(os.environ.get(ENV_VAR) or _DEFAULT).expanduser()


def geometry_descriptor(cfg, base: dict) -> dict:
    """JSON-serializable description of everything that shapes the plan
    search space: the network geometry plus the caller's planning knobs.

    ``base`` must already have ``stats`` resolved to explicit capacities
    (tensors are not cache keys, and two runs with different calibration
    data must not collide on one key).
    """
    from repro_torch.core.csnn import ConvSpec
    from repro_torch.core.geometry import ConvGeometry
    if base.get("stats") is not None:
        raise ValueError("resolve stats to explicit capacities before "
                         "fingerprinting (tensors are not cache keys)")
    layers = []
    for spec in cfg.layers:
        if isinstance(spec, ConvSpec):
            geom = ConvGeometry(spec.kernel, spec.kernel)
            layers.append({"kind": "conv", "channels": spec.channels,
                           "kernel": spec.kernel, "pool": spec.pool,
                           "kh": geom.kh, "kw": geom.kw,
                           "stride": geom.stride,
                           "n_banks": geom.n_banks})
        else:
            layers.append({"kind": "fc", "features": spec.features})

    def plain(v):
        return list(v) if isinstance(v, (list, tuple)) else v

    return {
        "input_hw": list(cfg.input_hw),
        "input_channels": cfg.input_channels,
        "t_steps": cfg.t_steps,
        "layers": layers,
        "capacity": plain(base.get("capacity")),
        "channel_block": plain(base.get("channel_block")),
        "sat_bits": base.get("sat_bits"),
        "batch_tile": base.get("batch_tile"),
        "per_layer": base.get("per_layer"),
        "fc_capacity": base.get("fc_capacity"),
        "t_chunk": base.get("t_chunk"),
        "smem_budget": base.get("smem_budget"),
        "ingest": bool(base.get("ingest")
                       or base.get("ingest_capacity") is not None),
        "ingest_capacity": base.get("ingest_capacity"),
    }


def env_descriptor(device="cuda", sat_bits: Optional[int] = None) -> dict:
    """The execution-environment half of the cache key: a winner measured
    on one card, toolkit or torch build says nothing about another.  On
    the CPU no CUDA call is made."""
    dev = torch.device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        capability = list(torch.cuda.get_device_capability(dev))
    else:
        name, capability = "cpu", None
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": name,
        "capability": capability,
        "dtype": {None: "float32", 16: "int16", 8: "int8"}[sat_bits],
    }


def cache_key(geometry: dict, env: dict) -> str:
    """sha256 over the canonical JSON of (version, geometry, env)."""
    blob = json.dumps({"version": CACHE_VERSION, "geometry": geometry,
                       "env": env}, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


class PlanCache:
    """Dict-of-entries JSON store with atomic writes and lenient reads.

    A missing, unreadable, non-JSON or wrong-``version`` file reads as
    empty (a cache must never break planning); ``get`` also rejects
    entries missing a required field, so a truncated entry is a miss.
    """

    def __init__(self, path: Optional[os.PathLike | str] = None):
        self.path = Path(path) if path is not None else default_cache_path()

    def _load(self) -> dict:
        try:
            data = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return {}
        if (not isinstance(data, dict)
                or data.get("version") != CACHE_VERSION
                or not isinstance(data.get("entries"), dict)):
            return {}
        return data["entries"]

    def get(self, key: str) -> Optional[dict]:
        entry = self._load().get(key)
        if not isinstance(entry, dict):
            return None
        if not all(k in entry for k in ("geometry", "env", "winners")):
            return None
        return entry

    def put(self, key: str, entry: dict) -> Path:
        entries = self._load()
        entries[key] = entry
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"version": CACHE_VERSION, "entries": entries},
                          f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return self.path
