"""The port's plan against the JAX package's (analytic mode).

The rules that change results are JAX's; the speed rules keep JAX's
formulas under one resident tile per CTA, so with the same budget and a
batch tile of 1 (one resident tile in JAX's model too) the two plans
agree field by field.
"""
import dataclasses

import pytest
import torch

from repro.configs import csnn_paper as jpaper
from repro.configs import csnn_wide as jwide
from repro.core import plan as jplan
from repro.kernels.event_conv import ops as jops
from repro_torch.configs import csnn_paper as tpaper
from repro_torch.configs import csnn_wide as twide
from repro_torch.core import plan as tplan
from repro_torch.kernels.event_conv import ops as tops

FIELDS = [f.name for f in dataclasses.fields(tplan.LayerPlan)]
# JAX variant name -> the port's (the kernels run in CUDA, not Pallas/jnp)
JAX_VARIANT_NAMES = {"interlaced-pallas": "interlaced-cuda",
                     "banked-jax": "banked-cuda"}
CONFIGS = [(jpaper.FULL, tpaper.FULL), (jpaper.SMOKE, tpaper.SMOKE),
           (jwide.FULL, twide.FULL), (jwide.SMOKE, twide.SMOKE)]


def _same_plan(jp, tp):
    assert len(jp.layers) == len(tp.layers)
    for jl, tl in zip(jp.layers, tp.layers):
        for f in FIELDS:
            jv, tv = getattr(jl, f), getattr(tl, f)
            if f == "geometry":
                jv, tv = (jv.kh, jv.kw, jv.stride), (tv.kh, tv.kw, tv.stride)
            if f == "variant":
                jv = JAX_VARIANT_NAMES.get(jv, jv)
            assert jv == tv, (jl.name, f, jv, tv)
    for f in ("t_steps", "t_chunk", "fc_capacity", "batch_tile"):
        assert getattr(jp, f) == getattr(tp, f), f
    assert jp.total_event_slots == tp.total_event_slots


@pytest.mark.parametrize("cfgs", CONFIGS, ids=["paper-full", "paper-smoke",
                                                "wide-full", "wide-smoke"])
@pytest.mark.parametrize("knobs", [
    dict(capacity=256, channel_block=8, event_par=None),  # the serve plan
    dict(capacity=64, channel_block=4, event_par=1, sat_bits=16),
    dict(capacity=100, channel_block=3, event_par=4,
         sat_bits=8, t_chunk=2),
    dict(capacity=500, channel_block=32, event_par=None, budget=40_000),
    dict(capacity=256, channel_block=8, event_par=None, budget=3_000),
    # streaming ingestion sizing (the stream serve plan) and its pins
    dict(capacity=256, channel_block=8, event_par=None, ingest=True),
    dict(capacity=64, channel_block=4, event_par=1, ingest=True, t_chunk=2,
         stream_finalize="sort"),
    dict(capacity=100, channel_block=8, event_par=1, ingest_capacity=512,
         stream_finalize="ranks"),
])
def test_plan_equals_jax_field_by_field(cfgs, knobs):
    jcfg, tcfg = cfgs
    knobs = dict(knobs)
    budget = knobs.pop("budget", None)
    jp = jplan.plan_network(jcfg, batch_tile=1, vmem_budget=budget, **knobs)
    knobs.pop("stream_finalize", None)  # the port has one streamed route
    tp = tplan.plan_network(tcfg, batch_tile=1, smem_budget=budget, **knobs)
    _same_plan(jp, tp)


def test_serve_plan_of_full_matches_jax_at_serve_batch_tile():
    """At the serve defaults the budgets are far from binding, so even
    JAX's batch_tile=8 residency model gives the same plan:
    conv0/conv1 event_par 8, conv2 capacity 100, cb 5, event_par 4."""
    kw = dict(capacity=256, channel_block=8, batch_tile=8, event_par=None)
    tp = tplan.plan_network(tpaper.FULL, **kw)
    _same_plan(jplan.plan_network(jpaper.FULL, **kw), tp)
    assert [lp.event_par for lp in tp.layers] == [8, 8, 4]
    assert [lp.queue_depth for lp in tp.layers] == [320, 320, 128]
    assert (tp.layers[2].capacity, tp.layers[2].channel_block) == (100, 5)


def test_result_changing_rules_equal_jax():
    for n in range(1, 70):
        for r in (1, 3, 8, 64, 100):
            assert tops.snap_divisor(n, r) == jops.snap_divisor(n, r)
    for cap in (1, 5, 64, 65, 200, 256, 900):
        assert tplan.pad_capacity(cap) == jplan.pad_capacity(cap)
        for hw in (16, 144, 784):
            assert (tplan.effective_capacity(cap, hw)
                    == jplan.effective_capacity(cap, hw))
    for t in range(1, 9):
        for r in range(1, 10):
            assert tplan.snap_t_chunk(t, r) == jplan.snap_t_chunk(t, r)


@pytest.mark.parametrize("budget", [2_000, 60_000, 232_448])
def test_speed_rules_equal_jax_formulas_at_same_budget(budget):
    for cap in (0, 1, 7, 64, 144, 256, 320, 784):
        for tile in ((30, 30, 8), (32, 32, 32), (14, 14, 1)):
            for vb in (1, 2, 4):
                assert (tops.autotune_block_e(cap, tile, vm_bytes=vb,
                                              smem_budget=budget)
                        == jops.autotune_block_e(cap, tile, vm_bytes=vb,
                                                 vmem_budget=budget))
                assert (tops.autotune_event_par(cap, tile, vm_bytes=vb,
                                                smem_budget=budget)
                        == jops.autotune_event_par(cap, tile, vm_bytes=vb,
                                                   vmem_budget=budget))
        for par in (2, 4, 8):
            for be in (1, 16, 100):
                depth = par * 40
                assert (tops.snap_block_e_for_par(depth, be, par)
                        == jops.snap_block_e_for_par(depth, be, par))


def test_resolve_variant_and_unported_paths(tmp_path):
    tp = tplan.plan_network(tpaper.SMOKE, event_par=[1, 4])
    assert [lp.resolve_variant() for lp in tp.layers] == [
        "sequential", "interlaced-cuda"]
    for jv, tv in (("banked-jax", "banked-cuda"),
                   ("fused-handoff", "fused-handoff")):
        pinned = tplan.plan_network(tpaper.SMOKE, event_par=[1, 4],
                                    variant=tv)
        assert [lp.resolve_variant() for lp in pinned.layers] == [tv, tv]
        _same_plan(jplan.plan_network(jpaper.SMOKE, event_par=[1, 4],
                                      variant=jv), pinned)
    # never reached without a pin
    for ep in (1, 4, None):
        for lp in tplan.plan_network(tpaper.FULL, event_par=ep).layers:
            assert lp.resolve_variant() not in ("banked-cuda",
                                                "fused-handoff")
    with pytest.raises(ValueError, match="must be one of"):
        tplan.plan_network(tpaper.SMOKE, variant="banked-jax")
    fused = tplan.plan_network(tpaper.SMOKE, variant="fused-handoff")
    assert fused.validate(tpaper.SMOKE) is fused
    bad = dataclasses.replace(fused.layers[1], vm_tile=(5, 5, 8))
    with pytest.raises(ValueError, match="halo-padded vm_tile"):
        dataclasses.replace(fused, layers=(fused.layers[0], bad)).validate(
            tpaper.SMOKE)
    # the measured tuner (tests/test_torch_tune.py) plans the same layers
    from repro_torch.tune import TuneConfig
    tuned = tplan.plan_network(
        tpaper.SMOKE, capacity=32, channel_block=4, batch_tile=2,
        tune="measured", tune_config=TuneConfig(device="cpu", warmup=0,
                                                iters=1),
        cache_path=tmp_path / "plan_cache.json")
    assert tuned.validate(tpaper.SMOKE) is tuned
    with pytest.raises(ValueError, match="must be one of"):
        tplan.plan_network(tpaper.SMOKE, tune="psychic")
    with pytest.raises(ValueError, match="requires event_par > 1"):
        tplan.plan_network(tpaper.SMOKE, variant="interlaced-cuda")
    with pytest.raises(ValueError, match="must be one of"):
        tplan.plan_network(tpaper.SMOKE, variant="interlaced-pallas")
    assert tp.layers[1].vm_dtype == torch.float32
    assert tplan.plan_network(tpaper.SMOKE, sat_bits=8).layers[0].vm_dtype \
        == torch.int8


def test_validate_rejects_mismatched_plans():
    tp = tplan.plan_network(tpaper.SMOKE)
    assert tp.validate(tpaper.SMOKE) is tp
    with pytest.raises(ValueError, match="conv layers"):
        tp.validate(tpaper.FULL)
    with pytest.raises(ValueError, match="t_chunk"):
        dataclasses.replace(tp, t_chunk=3).validate(tpaper.SMOKE)
    with pytest.raises(ValueError, match="fc_capacity"):
        dataclasses.replace(tp, fc_capacity=10**6).validate(tpaper.SMOKE)
    with pytest.raises(ValueError, match="geometry"):
        tplan.plan_network(twide.SMOKE).validate(tpaper.SMOKE)
    with pytest.raises(ValueError, match="one capacity"):
        tplan.plan_network(tpaper.SMOKE, capacity=[64, 64, 64])
    assert (tp.total_event_slots
            == jplan.plan_network(jpaper.SMOKE).total_event_slots)
