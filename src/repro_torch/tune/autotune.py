"""Measured plan tuner: the ``plan_network(tune=...)`` engine (port of
``repro.tune.autotune``).

A search seeded by the analytic plan, in two stages:

1. **Per layer** — each conv layer is timed alone on the input spikes the
   seeded synthetic trace produces at its depth
   (``measure.propagate_inputs``), across the (block_e, event_par,
   variant) candidates of ``candidates.layer_candidates``.  Median of
   ``iters`` wall times; ties break on candidate order.
2. **Network** — with the per-layer winners pinned, whole-pipeline
   candidates toggle the knobs that couple layers: shared or per-layer
   capacity sizing and the t_chunk ladder.  A candidate the contract
   auditor rejects is skipped (it could never be loaded back).

Streamed input has one route to its queues (``scheduler._event_sets``),
so an ingesting plan has nothing more to rank.

Every candidate's time is set beside its Hopper roofline
(``crosscheck.model_microseconds``) and deviations are logged.  Winners
persist in the on-disk :class:`~.cache.PlanCache`; ``mode="cached"``
rebuilds the plan from the stored knobs and re-audits it (fixed point,
``NetworkPlan.validate``, ``repro_torch.analysis.audit_plan``) before
trusting it, and measures on any miss or rejection.

Tuning is a choice of schedule only: every candidate is a valid
schedule of the same computation, so the tuned plan's spikes, counts,
state and logits equal the analytic plan's; only the time changes.  All
work runs on ``TuneConfig.device``.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from repro_torch.analysis.contracts import audit_plan
from repro_torch.core.aeq import calibrate_capacities
from repro_torch.core.plan import NetworkPlan, plan_conv_layer, plan_network

from . import candidates as cand
from . import measure
from .cache import PlanCache, cache_key, env_descriptor, geometry_descriptor
from .crosscheck import log_deviation, model_microseconds

log = logging.getLogger("repro_torch.tune")


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """Knobs of the tuning run itself (never of the tuned plan)."""

    seed: int = 0               # synthetic trace + params seed
    density: float = 0.15       # input Bernoulli spike density
    warmup: int = 1             # untimed runs per candidate
    iters: int = 3              # timed runs per candidate (median)
    batch: Optional[int] = None  # measurement batch; None = base batch_tile
    device: str = "cuda"        # where candidates run and are timed
    include_interlaced: Optional[bool] = None  # None = on a CUDA device
    max_block_candidates: int = 4
    deviation_factor: float = 4.0  # measured-vs-roofline log threshold


def plan_from_winners(cfg, base: dict, winners: dict) -> NetworkPlan:
    """Rebuild a plan from stored winner knobs, refusing stale entries.

    The knobs go back through ``plan_network``, so every snapping rule
    applies as for a constructed plan, and the result must reproduce the
    recorded resolved values: an entry written under older snapping
    rules fails here instead of running another schedule.  The rebuilt
    plan is then validated against ``cfg`` and audited by
    ``repro_torch.analysis.audit_plan``.
    """
    kw = dict(base)
    kw.update(stats=None,
              capacity=winners["capacity"],
              per_layer=winners["per_layer"],
              t_chunk=winners["t_chunk"],
              block_e=[la["block_e"] for la in winners["layers"]],
              event_par=[la["event_par"] for la in winners["layers"]],
              variant=[la["variant"] for la in winners["layers"]])
    plan = plan_network(cfg, **kw)
    resolved = winners.get("resolved")
    if not resolved or len(resolved) != len(plan.layers):
        raise ValueError(
            f"cache entry records {len(resolved or [])} resolved layers, "
            f"plan has {len(plan.layers)}")
    for lp, rec in zip(plan.layers, resolved):
        got = dict(capacity=lp.capacity, block_e=lp.block_e,
                   event_par=lp.event_par, queue_depth=lp.queue_depth)
        want = {k: rec.get(k) for k in got}
        if got != want:
            raise ValueError(
                f"stale cache entry: {lp.name} rebuilds to {got}, entry "
                f"recorded {want} (snapping rules changed since it was "
                f"written)")
    plan.validate(cfg)
    rep = audit_plan(plan, cfg, case="plan-cache")
    if not rep.ok:
        raise ValueError("cached plan fails the contract audit: "
                         + "; ".join(str(f) for f in rep.findings))
    return plan


def _candidate_layer_plan(lp, c: cand.Candidate, *, per_layer: bool,
                          smem_budget: Optional[int]):
    """One layer's plan under candidate knobs, built through
    ``plan_conv_layer`` so block_e snaps as in the real planner."""
    return plan_conv_layer(
        lp.index, lp.name, lp.in_hw, lp.c_in, lp.c_out,
        capacity=lp.capacity, pool=lp.pool, channel_block=lp.channel_block,
        block_e=c.block_e, sat_bits=lp.sat_bits, per_layer=per_layer,
        smem_budget=smem_budget, event_par=c.event_par, variant=c.variant,
        geometry=lp.geometry)


def _measure_and_pick(cfg, base: dict, config: TuneConfig,
                      geom: dict, env: dict) -> tuple[NetworkPlan, dict]:
    dev = config.device
    batch = config.batch or max(base.get("batch_tile") or 1, 1)
    include_interlaced = (config.include_interlaced
                          if config.include_interlaced is not None
                          else cand.default_include_interlaced(dev))
    smem_budget = base.get("smem_budget")
    per_layer0 = bool(base.get("per_layer", True))
    timing = dict(device=dev, warmup=config.warmup, iters=config.iters)

    plan0 = plan_network(cfg, **base)
    params = measure.synth_params(cfg, config.seed, device=dev)
    x0 = measure.synth_spikes(cfg, batch, config.seed, config.density,
                              device=dev)
    inputs, counts = measure.propagate_inputs(params, cfg, plan0, x0,
                                              device=dev)
    occupancy = calibrate_capacities(counts)

    conv_keys = [f"conv{lp.index}" for lp in plan0.layers]
    measured: dict[str, float] = {}
    modelled: dict[str, float] = {}

    # -------- stage 1: per-layer (block_e, event_par, variant) ----------
    layer_winners = []
    for ci, lp in enumerate(plan0.layers):
        p = params[conv_keys[ci]]
        ranked = []
        for c in cand.layer_candidates(
                lp, smem_budget=smem_budget,
                include_interlaced=include_interlaced,
                max_block_candidates=config.max_block_candidates):
            lp_c = _candidate_layer_plan(lp, c, per_layer=per_layer0,
                                         smem_budget=smem_budget)
            us = measure.measure_layer(lp_c, inputs[ci], p["w"], p["b"],
                                       cfg.v_t, **timing)
            model_us = model_microseconds([lp_c], [counts[ci]])
            ranked.append((us, model_us, c, lp_c))
            measured[f"{lp.name}/{c.label()}"] = us
            modelled[f"{lp.name}/{c.label()}"] = model_us
        ranked.sort(key=lambda r: r[0])
        log_deviation(lp.name, [(c.label(), us, m) for us, m, c, _ in ranked],
                      deviation_factor=config.deviation_factor)
        us, _, c, lp_c = ranked[0]
        log.info("tune[%s]: winner %s (%.1f us)", lp.name, c.label(), us)
        layer_winners.append((c, lp_c))

    winner_kw = dict(
        block_e=[lp_c.block_e for _, lp_c in layer_winners],
        event_par=[lp_c.event_par for _, lp_c in layer_winners],
        variant=[c.variant for c, _ in layer_winners])

    # -------- stage 2: network-level (capacity sharing, t_chunk) --------
    best_net, best_us = None, None
    for i, nc in enumerate(cand.network_candidates(cfg, base)):
        plan_c = plan_network(cfg, **{**base, **winner_kw, **nc})
        label = f"per_layer={nc['per_layer']}/t_chunk={nc['t_chunk']}"
        # candidate 0 is the caller's own configuration and is never
        # skipped: if it fails the audit, plan_from_winners raises the
        # real error at the end
        if i > 0 and not audit_plan(plan_c, cfg, case="tune-candidate").ok:
            log.info("tune[network]: %s fails the contract audit; skipped",
                     label)
            continue
        us = measure.measure_network(params, x0, cfg, plan_c, **timing)
        measured[f"network/{label}"] = us
        modelled[f"network/{label}"] = model_microseconds(plan_c.layers,
                                                          counts)
        if best_us is None or us < best_us:
            best_net, best_us = nc, us
    log.info("tune[network]: winner per_layer=%s t_chunk=%s (%.1f us)",
             best_net["per_layer"], best_net["t_chunk"], best_us)

    final = plan_network(cfg, **{**base, **winner_kw, **best_net})
    winners = {
        "capacity": (list(base["capacity"])
                     if isinstance(base["capacity"], (list, tuple))
                     else base["capacity"]),
        "per_layer": best_net["per_layer"],
        "t_chunk": best_net["t_chunk"],
        "layers": [{"block_e": lp.block_e, "event_par": lp.event_par,
                    "variant": lp.variant} for lp in final.layers],
        "resolved": [{"capacity": lp.capacity, "block_e": lp.block_e,
                      "event_par": lp.event_par,
                      "queue_depth": lp.queue_depth}
                     for lp in final.layers],
    }
    entry = {"geometry": geom, "env": env, "winners": winners,
             "occupancy_capacities": occupancy,
             "measured_us": {k: round(v, 2) for k, v in measured.items()},
             "model_us": {k: round(v, 4) for k, v in modelled.items()}}
    return final, entry


def tune_network(cfg, *, mode: str, base: dict,
                 config: Optional[TuneConfig] = None,
                 cache_path=None) -> NetworkPlan:
    """Entry point behind ``plan_network(tune="measured"|"cached")``.

    ``base`` is the caller's full analytic-planning kwargs.  ``"cached"``
    tries the on-disk cache first (a miss, a stale entry or an audit
    failure falls back to measuring); ``"measured"`` always measures.
    Both persist the winners, so a measured run warms the cache for every
    later ``tune="cached"`` call with the same geometry and environment.
    """
    if mode not in ("measured", "cached"):
        raise ValueError(f"mode={mode!r} must be 'measured' or 'cached'")
    config = config if config is not None else TuneConfig()
    base = dict(base)
    if base.get("stats") is not None:
        # resolve calibration counts to explicit capacities first: the
        # cache key fingerprints the resolved request
        base["capacity"] = calibrate_capacities(
            base["stats"], percentile=base.get("percentile", 99.9),
            margin=base.get("margin", 1.25))
        base["stats"] = None
    geom = geometry_descriptor(cfg, base)
    env = env_descriptor(config.device, base.get("sat_bits"))
    key = cache_key(geom, env)
    cache = PlanCache(cache_path)
    if mode == "cached":
        entry = cache.get(key)
        if entry is not None:
            try:
                return plan_from_winners(cfg, base, entry["winners"])
            except (KeyError, TypeError, ValueError) as e:
                log.warning("plan cache entry %s rejected (%s); "
                            "re-measuring", key[:12], e)
        else:
            log.info("plan cache miss for %s (%s); measuring", key[:12],
                     cache.path)
    plan, entry = _measure_and_pick(cfg, base, config, geom, env)
    cache.put(key, entry)
    # round-trip through the winners record: proves at write time that
    # the entry rebuilds to this exact plan (the cached path's contract)
    return plan_from_winners(cfg, base, entry["winners"])

