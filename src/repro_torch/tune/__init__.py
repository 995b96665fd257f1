"""Measured plan tuner with a persistent on-disk plan cache (port of
``repro.tune``).

The analytic sizing rules model a staged tile that the port's gather
kernels do not have, so they can pick a slower schedule on the card.
The tuner instead times candidate (block_e, event_par, kernel variant)
tuples per layer, then the network knobs (capacity sharing, t_chunk),
on seeded synthetic input at the layer's own occupancy, and plans with
the measured winners.
Winners persist in a versioned JSON cache keyed by the layer geometry
and planning knobs, the vm dtype, the torch and CUDA versions and the
device (``REPRO_TORCH_PLAN_CACHE`` overrides the location); a cached
plan is rebuilt and re-audited (fixed point, ``NetworkPlan.validate``,
``repro_torch.analysis.audit_plan``) before it is trusted.

Use through ``plan_network(cfg, tune="measured")`` (always measure, warm
the cache) or ``tune="cached"`` (load; measure only on a miss), with a
``TuneConfig(device=...)``; ``CSNNEngine(tune=...)`` and
``launch/serve.py --tune`` tune at construction, never on the request
path.  Every candidate gives the same results; only the time changes.
"""
from .autotune import TuneConfig, plan_from_winners, tune_network
from .cache import (CACHE_VERSION, PlanCache, cache_key, default_cache_path,
                    env_descriptor, geometry_descriptor)
from .measure import measurement_runs

__all__ = [
    "CACHE_VERSION",
    "PlanCache",
    "TuneConfig",
    "cache_key",
    "default_cache_path",
    "env_descriptor",
    "geometry_descriptor",
    "measurement_runs",
    "plan_from_winners",
    "tune_network",
]
