"""Candidate generation of the measured tuner (port of
``repro.tune.candidates``).

The search space is seeded from the analytic priors: per layer a few
``block_e`` values around the sizing model's pick drive the sequential
variant; ``banked-cuda`` and ``fused-handoff`` contribute one candidate
each (they ignore ``block_e`` and ``event_par``); ``interlaced-cuda``
one at the autotuned width, where it is measured (``include_interlaced``:
by default on a CUDA device, not on the CPU, as JAX measures its Pallas
kernels only where they compile).  Network-level knobs (shared or
per-layer capacity, t_chunk) change every layer at once and are
generated apart.

The port sizes against one CTA's tile whatever the batch, so the layer
candidates do not depend on the measurement batch; with ``batch_tile=1``
JAX's candidates are the same.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.plan import LayerPlan, snap_t_chunk
from repro_torch.kernels.event_conv.ops import (SMEM_PER_BLOCK,
                                                autotune_event_par,
                                                candidate_block_es)


class Candidate(NamedTuple):
    """One per-layer knob tuple the tuner measures."""
    block_e: Optional[int]   # None = analytic autotune inside plan_conv_layer
    event_par: int
    variant: str             # one of plan.KERNEL_VARIANTS

    def label(self) -> str:
        be = "auto" if self.block_e is None else str(self.block_e)
        return f"{self.variant}/be={be}/ep={self.event_par}"


def default_include_interlaced(device) -> bool:
    """The interlaced candidate is measured on the card; on the CPU its
    plain version walks every group in Python and always loses."""
    return torch.device(device).type == "cuda"


def layer_candidates(lp: LayerPlan, *, smem_budget: Optional[int] = None,
                     include_interlaced: bool = False,
                     max_block_candidates: int = 4) -> list[Candidate]:
    """Candidate (block_e, event_par, variant) tuples for one layer."""
    vm_bytes = {None: 4, 8: 1, 16: 2}[lp.sat_bits]
    budget = smem_budget if smem_budget else SMEM_PER_BLOCK
    bes = candidate_block_es(lp.capacity, lp.vm_tile, vm_bytes=vm_bytes,
                             smem_budget=budget)
    cands = [Candidate(be, 1, "sequential")
             for be in bes[:max(max_block_candidates, 1)]]
    cands.append(Candidate(None, max(lp.event_par, 1), "banked-cuda"))
    cands.append(Candidate(None, 1, "fused-handoff"))
    if include_interlaced:
        ep = (lp.event_par if lp.event_par > 1
              else autotune_event_par(lp.capacity, lp.vm_tile,
                                      vm_bytes=vm_bytes,
                                      geometry=lp.geometry,
                                      smem_budget=budget))
        if ep > 1:
            cands.append(Candidate(None, ep, "interlaced-cuda"))
    return cands


def network_candidates(cfg, base: dict) -> list[dict]:
    """Network-level override dicts measured with the per-layer winners
    fixed: both capacity-sharing modes x a small t_chunk ladder (the
    caller's choice, whole T, and half T).  The base configuration is
    candidate 0, so with flat timings the tuner keeps it."""
    t = cfg.t_steps
    chunks = []
    for tc in (base.get("t_chunk"), None,
               snap_t_chunk(t, max(1, t // 2)) if t > 1 else None):
        if tc not in chunks:
            chunks.append(tc)
    base_pl = bool(base.get("per_layer", True))
    return [{"per_layer": per_layer, "t_chunk": tc}
            for per_layer in (base_pl, not base_pl) for tc in chunks]
