"""The port's measured tuner and plan cache (``repro_torch.tune``) against
the JAX package's (``repro.tune``), on the CPU.

* candidates: ``layer_candidates``/``network_candidates`` and
  ``candidate_block_es`` equal JAX's (names mapped) at a batch tile of 1
  and the same budget, where the two sizing models coincide;
* cache: ``geometry_descriptor`` is JAX's with ``vmem_budget`` renamed
  ``smem_budget``; keys, corrupt files and the environment variable;
* ``plan_from_winners`` rebuilds JAX's plan from the same winners, and a
  tampered entry is rejected and re-measured;
* injected timings: with one deterministic cost per candidate in both
  packages, both tuners pick the same plan (JAX also ranks its streamed
  finalizations; the port has one streamed route, so nothing to rank);
* a real CPU tune of SMOKE: the entry persists, a cache hit measures
  nothing, and the tuned plan's results equal the analytic plan's.

Parameters and input spikes come from the JAX side through numpy.

    PYTHONPATH=src python -m pytest -q tests/test_torch_tune.py
"""
import dataclasses
import json
import zlib

import jax
import numpy as np
import pytest
import torch

import repro.tune.autotune as jauto
import repro.tune.measure as jmeasure
import repro_torch.tune.autotune as tauto
import repro_torch.tune.measure as tmeasure
from repro.configs import csnn_paper as jpaper
from repro.core import csnn as jc
from repro.core import plan as jplan
from repro.kernels.event_conv import ops as jops
from repro.tune import cache as jcache
from repro.tune import candidates as jcand
from repro_torch.configs import csnn_paper as tpaper
from repro_torch.convert import params_from_numpy
from repro_torch.core import csnn as tc
from repro_torch.core import plan as tplan
from repro_torch.kernels.event_conv import ops as tops
from repro_torch.tune import (CACHE_VERSION, PlanCache, TuneConfig,
                              cache_key, default_cache_path, env_descriptor,
                              geometry_descriptor, measurement_runs,
                              plan_from_winners)
from repro_torch.tune import candidates as tcand

JAX_VARIANT_NAMES = {"interlaced-pallas": "interlaced-cuda",
                     "banked-jax": "banked-cuda"}
FIELDS = [f.name for f in dataclasses.fields(tplan.LayerPlan)]
BUDGET = 232_448
CPU_TUNE = TuneConfig(device="cpu", warmup=0, iters=1)
SMOKE_KNOBS = dict(capacity=64, channel_block=4, batch_tile=2)


def _name(v):
    return JAX_VARIANT_NAMES.get(v, v)


def _same_plan(jp, tp):
    assert len(jp.layers) == len(tp.layers)
    for jl, tl in zip(jp.layers, tp.layers):
        for f in FIELDS:
            jv, tv = getattr(jl, f), getattr(tl, f)
            if f == "geometry":
                jv, tv = (jv.kh, jv.kw, jv.stride), (tv.kh, tv.kw, tv.stride)
            if f == "variant":
                jv = _name(jv)
            assert jv == tv, (jl.name, f, jv, tv)
    for f in ("t_steps", "t_chunk", "fc_capacity", "batch_tile"):
        assert getattr(jp, f) == getattr(tp, f), f


# ------------------------------------------------------------- candidates
@pytest.mark.parametrize("cfgs", [(jpaper.FULL, tpaper.FULL),
                                  (jpaper.SMOKE, tpaper.SMOKE)],
                         ids=["full", "smoke"])
@pytest.mark.parametrize("knobs", [
    dict(capacity=256, channel_block=8, event_par=None),
    dict(capacity=64, channel_block=4, event_par=1, sat_bits=16),
    dict(capacity=100, channel_block=2, event_par=4, sat_bits=8,
         t_chunk=2, per_layer=False),
])
@pytest.mark.parametrize("budget", [BUDGET, 40_000])
def test_candidates_equal_jax(cfgs, knobs, budget):
    jcfg, tcfg = cfgs
    jp = jplan.plan_network(jcfg, batch_tile=1, vmem_budget=budget, **knobs)
    tp = tplan.plan_network(tcfg, batch_tile=1, smem_budget=budget, **knobs)
    for jl, tl in zip(jp.layers, tp.layers):
        for inc in (False, True):
            want = [(c.block_e, c.event_par, _name(c.variant))
                    for c in jcand.layer_candidates(
                        jl, batch_tile=1, vmem_budget=budget,
                        include_pallas=inc, max_block_candidates=3)]
            got = [tuple(c) for c in tcand.layer_candidates(
                tl, smem_budget=budget, include_interlaced=inc,
                max_block_candidates=3)]
            assert got == want, (jl.name, inc)
    base = dict(knobs, batch_tile=1)
    assert (tcand.network_candidates(tcfg, base)
            == jcand.network_candidates(jcfg, base))


def test_candidate_labels_and_default_include():
    c = tcand.Candidate(None, 8, "interlaced-cuda")
    assert c.label() == jcand.Candidate(None, 8, "interlaced-pallas").label(
        ).replace("pallas", "cuda")
    assert tcand.default_include_interlaced("cuda")
    assert not tcand.default_include_interlaced("cpu")


@pytest.mark.parametrize("budget", [3_000, 60_000, BUDGET])
def test_candidate_block_es_equal_jax(budget):
    for cap in (0, 1, 7, 64, 100, 144, 256, 320, 784):
        for tile in ((), (14, 14, 4), (30, 30, 8), (32, 32, 32)):
            for vb in (1, 2, 4):
                assert (tops.candidate_block_es(cap, tile, vm_bytes=vb,
                                                smem_budget=budget)
                        == jops.candidate_block_es(cap, tile, vm_bytes=vb,
                                                   vmem_budget=budget))


# ------------------------------------------------------------------ cache
BASE = dict(capacity=32, channel_block=4, batch_tile=2)


def test_geometry_descriptor_is_jax_with_the_budget_renamed():
    for knobs in (BASE, dict(BASE, ingest=True, t_chunk=2, sat_bits=8),
                  dict(capacity=[64, 32], channel_block=(4, 8),
                       per_layer=False, fc_capacity=5)):
        want = jcache.geometry_descriptor(jpaper.SMOKE,
                                          dict(knobs, vmem_budget=9000))
        want["smem_budget"] = want.pop("vmem_budget")
        assert geometry_descriptor(tpaper.SMOKE,
                                   dict(knobs, smem_budget=9000)) == want
    with pytest.raises(ValueError, match="stats"):
        geometry_descriptor(tpaper.SMOKE, dict(BASE, stats=[np.ones(2)]))


def test_cache_key_follows_geometry_dtype_and_device():
    env = env_descriptor("cpu", None)
    assert env["device"] == "cpu" and env["capability"] is None
    assert env["torch"] == torch.__version__ and env["dtype"] == "float32"
    geom = geometry_descriptor(tpaper.SMOKE, BASE)
    key = cache_key(geom, env)
    assert key == cache_key(geometry_descriptor(tpaper.SMOKE, dict(BASE)),
                            env_descriptor("cpu", None))
    assert cache_key(geometry_descriptor(tpaper.SMOKE,
                                         dict(BASE, capacity=64)), env) != key
    assert cache_key(geom, env_descriptor("cpu", 8)) != key
    assert cache_key(geom, dict(env, device="NVIDIA H100 80GB HBM3")) != key


def test_unreadable_entries_are_misses(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text("{ not json !!")
    assert PlanCache(path).get("k") is None
    path.write_text(json.dumps({"version": CACHE_VERSION + 1,
                                "entries": {"k": {}}}))
    assert PlanCache(path).get("k") is None
    path.write_text(json.dumps({"version": CACHE_VERSION,
                                "entries": {"k": {"geometry": {}}}}))
    assert PlanCache(path).get("k") is None
    entry = {"geometry": {}, "env": {}, "winners": {}}
    assert PlanCache(path).put("k2", entry) == path
    assert PlanCache(path).get("k2") == entry
    assert list(tmp_path.iterdir()) == [path]  # no temp file left


def test_env_var_overrides_the_default_path(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE", raising=False)
    default = default_cache_path()
    assert default.parts[-2:] == ("repro_torch", "plan_cache.json")
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "jax.json"))
    assert default_cache_path() == default  # never JAX's variable
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "pc.json"))
    assert default_cache_path() == tmp_path / "pc.json"
    assert PlanCache().path == tmp_path / "pc.json"


# ------------------------------------------------------ plan_from_winners
def _winners(jp, **net):
    return {"capacity": net.get("capacity", 256),
            "per_layer": net.get("per_layer", True),
            "t_chunk": jp.t_chunk,
            # JAX's winners record its finalize pin; the port's plan has none
            "stream_finalize": getattr(jp.layers[0], "stream_finalize", None),
            "layers": [{"block_e": lp.block_e, "event_par": lp.event_par,
                        "variant": lp.variant} for lp in jp.layers],
            "resolved": [{"capacity": lp.capacity, "block_e": lp.block_e,
                          "event_par": lp.event_par,
                          "queue_depth": lp.queue_depth}
                         for lp in jp.layers]}


@pytest.mark.parametrize("pins", [
    dict(event_par=[1, 4, 4], block_e=[64, None, None],
         variant=["sequential", "banked-jax", "interlaced-pallas"]),
    dict(event_par=1, variant="fused-handoff", t_chunk=1),
    # shared capacity within conv2's padded 10x10 map (pad64(100) = 128)
    dict(event_par=None, per_layer=False, capacity=128, ingest=True,
         stream_finalize="sort"),
])
def test_plan_from_winners_rebuilds_jax_plan(pins):
    pins = dict(pins)
    net = {k: pins.pop(k) for k in ("per_layer", "capacity") if k in pins}
    base = dict(capacity=net.get("capacity", 256), channel_block=8,
                batch_tile=1, ingest=pins.pop("ingest", False))
    jp = jplan.plan_network(jpaper.FULL, **{**base, **pins, **net})
    w = _winners(jp, **net)
    jrebuilt = jauto.plan_from_winners(jpaper.FULL, base, w)
    tw = json.loads(json.dumps(w))
    for la in tw["layers"]:
        la["variant"] = _name(la["variant"])
    trebuilt = plan_from_winners(tpaper.FULL, base, tw)
    _same_plan(jrebuilt, trebuilt)
    _same_plan(jp, trebuilt)
    tw["resolved"][1]["queue_depth"] += 1
    with pytest.raises(ValueError, match="stale cache entry"):
        plan_from_winners(tpaper.FULL, base, tw)


def test_plan_from_winners_refuses_a_plan_the_auditor_rejects():
    base = dict(capacity=256, channel_block=32, batch_tile=1)
    tp = tplan.plan_network(tpaper.FULL, **base)
    with pytest.raises(ValueError, match="plan-smem-budget"):
        plan_from_winners(tpaper.FULL, base, _winners(tp))


# -------------------------------------------------------- injected timings
def _cost(*parts) -> float:
    return float(zlib.crc32(repr(parts).encode()) % 997 + 1)


def _layer_cost(lp):
    return _cost(lp.name, _name(lp.resolve_variant()), lp.block_e,
                 lp.event_par)


def _net_cost(plan):
    return _cost(tuple(lp.capacity for lp in plan.layers), plan.t_chunk)


@pytest.mark.parametrize("ingest,inc", [(False, True), (True, False)],
                         ids=["binned-interlaced", "ingest"])
def test_injected_timings_pick_jax_winners(monkeypatch, tmp_path, ingest,
                                           inc):
    monkeypatch.setattr(jmeasure, "measure_layer",
                        lambda lp, *a, **k: (_layer_cost(lp), ""))
    monkeypatch.setattr(jmeasure, "measure_network",
                        lambda p, x, cfg, plan, **k: (_net_cost(plan), ""))
    monkeypatch.setattr(jmeasure, "measure_streamed",
                        lambda lp, *a, **k: (_cost(lp.stream_finalize), ""))
    monkeypatch.setattr(jauto, "model_microseconds", lambda hlo: 1.0)
    monkeypatch.setattr(tmeasure, "measure_layer",
                        lambda lp, *a, **k: _layer_cost(lp))
    monkeypatch.setattr(tmeasure, "measure_network",
                        lambda p, x, cfg, plan, **k: _net_cost(plan))
    monkeypatch.setattr(tauto, "model_microseconds", lambda *a: 1.0)
    jcfg, tcfg = jpaper.SMOKE, tpaper.SMOKE
    if ingest:
        jcfg = dataclasses.replace(jcfg, input_channels=2)
        tcfg = dataclasses.replace(tcfg, input_channels=2)
    knobs = dict(capacity=64, channel_block=4, batch_tile=1, event_par=None,
                 ingest=ingest)
    jp = jplan.plan_network(
        jcfg, **knobs, vmem_budget=BUDGET, tune="measured",
        tune_config=jauto.TuneConfig(include_pallas=inc),
        cache_path=tmp_path / "jax.json")
    tp = tplan.plan_network(
        tcfg, **knobs, smem_budget=BUDGET, tune="measured",
        tune_config=TuneConfig(device="cpu", include_interlaced=inc),
        cache_path=tmp_path / "torch.json")
    _same_plan(jp, tp)
    (entry,) = json.loads((tmp_path / "torch.json").read_text())[
        "entries"].values()
    if ingest:
        assert jp.layers[0].stream_finalize in ("ranks", "sort")
    assert "stream_finalize" not in entry["winners"]
    assert not any(k.startswith("stream_finalize/")
                   for k in entry["measured_us"])
    assert any("interlaced-cuda" in k for k in entry["measured_us"]) == inc
    assert set(entry["model_us"]) <= set(entry["measured_us"])


# ------------------------------------------------------ a real CPU tune
def _forward(params, spikes, cfg, plan):
    """``snn_apply_batched``'s steps, keeping the state."""
    state = tc.init_state(params, cfg, plan, spikes.shape[0])
    stats = []
    for k in range(0, cfg.t_steps, plan.chunk_steps):
        state, st = tc.snn_step_chunk(params, state,
                                      spikes[:, k:k + plan.chunk_steps],
                                      cfg, plan, collect_stats=True)
        stats.append(st)
    return tc.snn_readout(params, state, cfg, plan), stats, state


@pytest.fixture(scope="module")
def cpu_tune(tmp_path_factory):
    path = tmp_path_factory.mktemp("cache") / "plan_cache.json"
    n0 = measurement_runs()
    plan = tplan.plan_network(tpaper.SMOKE, **SMOKE_KNOBS, tune="measured",
                              tune_config=CPU_TUNE, cache_path=path)
    return path, plan, measurement_runs() - n0


def test_cpu_tune_persists_and_cached_measures_nothing(cpu_tune):
    path, plan, runs = cpu_tune
    assert runs > 0
    data = json.loads(path.read_text())
    assert data["version"] == CACHE_VERSION
    (entry,) = data["entries"].values()
    assert set(entry) >= {"geometry", "env", "winners", "measured_us",
                          "model_us", "occupancy_capacities"}
    assert entry["env"]["device"] == "cpu"
    assert len(entry["winners"]["layers"]) == len(plan.layers)
    assert all(v > 0 for v in entry["model_us"].values())
    n0 = measurement_runs()
    again = tplan.plan_network(tpaper.SMOKE, **SMOKE_KNOBS, tune="cached",
                               tune_config=CPU_TUNE, cache_path=path)
    assert measurement_runs() == n0
    assert again == plan
    # another geometry misses the cache and measures
    other = tplan.plan_network(tpaper.SMOKE, capacity=32, channel_block=4,
                               batch_tile=2, tune="cached",
                               tune_config=CPU_TUNE, cache_path=path)
    assert measurement_runs() > n0
    assert all(lp.capacity <= 32 for lp in other.layers)
    assert len(json.loads(path.read_text())["entries"]) == 2


def test_tampered_entry_is_rejected_and_remeasured(cpu_tune, tmp_path):
    path, _, _ = cpu_tune
    data = json.loads(path.read_text())
    key = min(data["entries"])
    data["entries"] = {key: data["entries"][key]}
    data["entries"][key]["winners"]["resolved"][0]["queue_depth"] += 1
    bad = tmp_path / "tampered.json"
    bad.write_text(json.dumps(data))
    knobs = dict(data["entries"][key]["geometry"])
    n0 = measurement_runs()
    plan = tplan.plan_network(
        tpaper.SMOKE, capacity=knobs["capacity"],
        channel_block=knobs["channel_block"],
        batch_tile=knobs["batch_tile"], tune="cached", tune_config=CPU_TUNE,
        cache_path=bad)
    assert measurement_runs() > n0
    n1 = measurement_runs()
    assert tplan.plan_network(
        tpaper.SMOKE, capacity=knobs["capacity"],
        channel_block=knobs["channel_block"],
        batch_tile=knobs["batch_tile"], tune="cached", tune_config=CPU_TUNE,
        cache_path=bad) == plan
    assert measurement_runs() == n1


def test_tuned_plan_gives_the_analytic_plans_results(cpu_tune):
    _, tuned, _ = cpu_tune
    np_params = jax.tree.map(
        np.asarray, jc.init_params(jax.random.PRNGKey(4), jpaper.SMOKE))
    params = params_from_numpy(np_params, "cpu")
    rng = np.random.default_rng(5)
    h, w = tpaper.SMOKE.input_hw
    spikes = torch.from_numpy(
        rng.random((2, tpaper.SMOKE.t_steps, h, w, 1)) < 0.3)
    analytic = tplan.plan_network(tpaper.SMOKE, **SMOKE_KNOBS)
    (la, sa, sta), (lt, st, stt) = (
        _forward(params, spikes, tpaper.SMOKE, p) for p in (analytic, tuned))
    assert torch.equal(la, lt)
    assert torch.equal(sta.fc_drive, stt.fc_drive)
    for a, b in zip(sta.convs, stt.convs):
        assert torch.equal(a.vm, b.vm) and torch.equal(a.fired, b.fired)
    cat = tc._merge_chunk_stats
    for a, b in zip(cat(sa), cat(st)):
        assert torch.equal(a.in_spike_counts, b.in_spike_counts)
        assert torch.equal(a.out_spike_counts, b.out_spike_counts)
    lj = jc.snn_apply_batched(
        jax.tree.map(jax.numpy.asarray, np_params),
        jax.numpy.asarray(spikes.numpy()), jpaper.SMOKE,
        jplan.plan_network(jpaper.SMOKE, **SMOKE_KNOBS), collect_stats=False)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-4)
