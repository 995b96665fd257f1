"""What stands in the program's place for the readings that set the
limits of ``correct``: the reference in a lower precision, the program's
own integer datapath, and the faults a broken timed path can have.

``patched(side, net)`` swaps the program's entry for the run's duration:
``snn_apply_batched`` where the offline loop and the engine call it, or
``snn_step_chunk`` below them.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from yardstick import reference

SIDES = ("program", "bf16", "int16", "unchanged", "half", "altered")


def _bf16(net):
    def entry(params, spikes, cfg, plan, collect_stats=False):
        return reference.forward(params, spikes, net, torch.bfloat16).logits
    return entry


def _int16(real):
    """The program on its int16 datapath: the conv weights quantized by
    the program's shared-scale quantizer, the threshold with them."""
    from repro_torch.core.conversion import (quantize_params,
                                             quantized_threshold)
    cache = {}

    def entry(params, spikes, cfg, plan, collect_stats=False):
        key = id(params)
        if key not in cache:
            conv = {k: v for k, v in params.items() if k.startswith("conv")}
            q, spec = quantize_params(conv, 16, v_t=cfg.v_t)
            qcfg = dataclasses.replace(cfg, v_t=quantized_threshold(cfg.v_t,
                                                                    spec))
            qplan = dataclasses.replace(plan, layers=tuple(
                dataclasses.replace(lp, sat_bits=16) for lp in plan.layers))
            cache[key] = ({**params, **q}, qcfg, qplan)
        qp, qcfg, qplan = cache[key]
        return real(qp, spikes, qcfg, qplan, collect_stats=collect_stats)
    return entry


def _half(real):
    """Half the batch left out: its rows get the mean of the others'."""
    def entry(params, spikes, cfg, plan, collect_stats=False):
        out = real(params, spikes, cfg, plan, collect_stats=collect_stats)
        n = out.shape[0] // 2
        if n:
            out = out.clone()
            out[n:] = out[:n].mean(dim=0)
        return out
    return entry


def _altered(real):
    """One answer of each batch altered where it is produced: row 0 gets
    row 1's logits."""
    def entry(params, spikes, cfg, plan, collect_stats=False):
        out = real(params, spikes, cfg, plan, collect_stats=collect_stats)
        if out.shape[0] > 1:
            out = out.clone()
            out[0] = out[1]
        return out
    return entry


def _unchanged(state, spikes_chunk, *args, collect_stats=False, **kw):
    """A step that returns its state unchanged."""
    return (state, []) if collect_stats else state


@contextlib.contextmanager
def patched(side: str, net: dict):
    from repro_torch.core import csnn
    from repro_torch.serve import csnn_engine
    if side not in SIDES:
        raise ValueError(f"side {side!r} is not one of {SIDES}")
    real = csnn.snn_apply_batched
    saved = (csnn.snn_apply_batched, csnn_engine.snn_apply_batched,
             csnn.snn_step_chunk)
    wrap = {"bf16": lambda: _bf16(net), "int16": lambda: _int16(real),
            "half": lambda: _half(real), "altered": lambda: _altered(real)}
    try:
        if side == "unchanged":
            csnn.snn_step_chunk = lambda params, state, *a, **k: \
                _unchanged(state, *a, **k)
        elif side != "program":
            csnn.snn_apply_batched = csnn_engine.snn_apply_batched = \
                wrap[side]()
        yield
    finally:
        (csnn.snn_apply_batched, csnn_engine.snn_apply_batched,
         csnn.snn_step_chunk) = saved
