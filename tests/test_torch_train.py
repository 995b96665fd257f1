"""The port's training substrate against the JAX package's, on the CPU:
JAX's ``tests/test_substrate.py`` (``TestOptimizer``, ``TestRuntime``,
``TestGradCompression``, ``TestData``, ``test_loss_decreases_and_resumes``)
on the port, and against the live JAX functions: ``TokenStream`` batches
equal; AdamW on an LM tree through ``make_train_step`` for 3 steps
(float32 and bfloat16 moments, ``compute_dtype=bfloat16``) within
tolerance of JAX's jitted step; top-k indices equal, ties included;
fault-policy decisions equal over random heartbeat and step-time
schedules; ``run`` resuming, yielding to a preemption and to a remesh,
and 20 steps plus a 10-step resume ``torch.equal`` to 30 uninterrupted
steps.  Checkpoints: ``test_torch_checkpoint.py``; the launchers:
``test_torch_launch_train.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.data.synthetic import TokenStream as JTokenStream
from repro.runtime import health as jhealth
from repro.sharding import compression as jcomp
from repro.train import optimizer as jopt
from repro.train.loop import make_compressed_train_step as jcompressed_step
from repro.train.loop import make_train_step as jtrain_step
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS
from repro_torch.data.synthetic import ShardedBatcher, TokenStream
from repro_torch.models.registry import build_model
from repro_torch.runtime.health import (ElasticPlanner, FaultPolicy,
                                        HeartbeatTracker, StragglerDetector)
from repro_torch.sharding.compression import (EFState, compress_topk,
                                              compress_with_error_feedback,
                                              compression_ratio, decompress)
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import (LoopConfig, make_compressed_train_step,
                                    make_train_step, run, value_and_grad)
from torch_lm_ref import ModelCase, to_np


# ------------------------------------------------------------------ optimizer
def _toy():
    params = {"w": torch.tensor([1.0, -2.0, 3.0]), "b": torch.zeros((2, 2))}
    cfg = opt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                          weight_decay=0.0, clip_norm=None)
    return params, cfg


def test_adamw_descends_quadratic():
    params, cfg = _toy()
    state = opt.init_state(params, cfg)
    loss = lambda p: (p["w"] ** 2).sum() + ((p["b"] - 1.0) ** 2).sum()  # noqa: E731
    l0 = float(loss(params))
    for _ in range(50):
        p = opt.tree_map(lambda t: t.detach().requires_grad_(), state.params)
        grads = torch.autograd.grad(loss(p), opt.tree_leaves(p))
        state = opt.adamw_update(state, opt.tree_unflatten(p, list(grads)), cfg)
    assert float(loss(state.params)) < 0.05 * l0


def test_clip_by_global_norm():
    clipped, norm = opt.clip_by_global_norm({"a": torch.full((4,), 100.0)}, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(opt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_lr_schedule():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert opt.lr_at(cfg, 5) == pytest.approx(0.5)
    assert opt.lr_at(cfg, 10) == pytest.approx(1.0, rel=1e-3)
    assert opt.lr_at(cfg, 100) == pytest.approx(0.1, rel=1e-3)


def test_bf16_moments():
    params, _ = _toy()
    cfg = opt.AdamWConfig(moment_dtype=torch.bfloat16)
    state = opt.init_state(params, cfg)
    assert state.mu["w"].dtype == torch.bfloat16
    state = opt.adamw_update(state, opt.tree_map(torch.ones_like, params), cfg)
    assert state.mu["w"].dtype == torch.bfloat16
    assert state.params["w"].dtype == torch.float32



def test_tree_order_is_jax_order():
    """``tree_leaves`` visits an LM tree (dicts of lists of tuples) in
    ``jax.tree.leaves`` order; ``tree_unflatten`` inverts it."""
    from repro.configs import ARCHS as JARCHS
    from repro.models.registry import build_model as jbuild
    from torch_lm_ref import np_params
    npp = np_params(jbuild(JARCHS["deepseek-v2-236b"].SMOKE).specs, seed=0)
    tp = jax.tree.map(torch.from_numpy, npp)
    for a, b in zip(opt.tree_leaves(tp), jax.tree.leaves(npp)):
        np.testing.assert_array_equal(a.numpy(), b)
    back = opt.tree_unflatten(tp, opt.tree_leaves(tp))
    assert jax.tree.structure(back, is_leaf=torch.is_tensor) == jax.tree.structure(npp)


def test_abstract_state_is_meta():
    model = build_model(ARCHS["gemma3-1b"].SMOKE)
    cfg = opt.AdamWConfig(moment_dtype=torch.bfloat16)
    st_ = opt.abstract_state(model.abstract_params(torch.float32), cfg)
    leaves = opt.tree_leaves([st_.params, st_.mu, st_.nu])
    assert all(t.device.type == "meta" for t in leaves)
    assert {t.dtype for t in opt.tree_leaves(st_.params)} == {torch.float32}
    assert {t.dtype for t in opt.tree_leaves(st_.mu)} == {torch.bfloat16}
    assert st_.step == 0


_CASE = {}


def _gemma() -> ModelCase:
    if "c" not in _CASE:
        _CASE["c"] = ModelCase("gemma3-1b")
    return _CASE["c"]


# float32 sums in another order, through 3 updates: each leaf within
# 1e-3 of its largest JAX entry (measured 2.2e-4); bfloat16 moments also
# round to neighbouring bfloat16 values (2**-8 apart): 2**-7 of the leaf
# (measured 4.1e-3 for the moments, 1.1e-3 for the parameters)
ADAM_TOL = {"float32": {"params": 1e-3, "mu": 1e-3, "nu": 1e-3},
            "bfloat16": {"params": 5e-3, "mu": 2 ** -7, "nu": 2 ** -7}}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_on_an_lm_tree_matches_jax(moments):
    """Three ``make_train_step`` steps of gemma3 SMOKE on ``TokenStream``
    batches from the same numpy parameters: the losses at rtol 1e-5, then
    every leaf of the parameters and both moments, and the step."""
    c = _gemma()
    jc = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                          moment_dtype=getattr(jnp, moments))
    tc = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                         moment_dtype=getattr(torch, moments))
    js, ts = jopt.init_state(c.jp, jc), opt.init_state(c.tp, tc)
    jstep = jax.jit(jtrain_step(c.jm, jc))
    tstep = make_train_step(c.tm, tc)
    stream = TokenStream(c.cfg.vocab, 0)
    for i in range(3):
        b = stream.batch(i, 2, 24)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert ts.step == int(js.step) == 3
    for part, tol in ADAM_TOL[moments].items():
        for a, b in zip(opt.tree_leaves(getattr(ts, part)),
                        jax.tree.leaves(getattr(js, part))):
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
            b = to_np(b)
            assert np.abs(to_np(a) - b).max() <= tol * np.abs(b).max(), part


def test_compute_dtype_bf16_lands_on_float32_masters():
    """``compute_dtype=bfloat16`` casts the float32 matrices inside the
    loss: the gradients are float32, on the masters, within bfloat16
    rounding (4e-2 of each leaf's largest entry; measured 1.9e-2) of
    JAX's, and a step keeps the parameters float32."""
    c = _gemma()

    def jloss(p, b):
        p = jax.tree.map(lambda t: t.astype(jnp.bfloat16)
                         if t.dtype == jnp.float32 and t.ndim > 1 else t, p)
        return c.jm.loss(p, b)

    (jv, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        c.jp, c.jbatch(c.train))
    (tv, _), tg = value_and_grad(c.tm, c.tp, c.tbatch(c.train), torch.bfloat16)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-3)
    for a, b in zip(opt.tree_leaves(tg), jax.tree.leaves(jg)):
        assert a.dtype == torch.float32
        b = to_np(b)
        assert np.abs(to_np(a) - b).max() <= 4e-2 * np.abs(b).max()
    tc = opt.AdamWConfig()
    st_, m = make_train_step(c.tm, tc, torch.bfloat16)(
        opt.init_state(c.tp, tc), c.tbatch(c.train))
    assert {t.dtype for t in opt.tree_leaves(st_.params)} == {torch.float32}
    assert m["loss"].dtype == torch.float32


# ------------------------------------------------------------------ runtime FT
def test_heartbeat_death():
    clock = [0.0]
    hb = HeartbeatTracker(["h0", "h1"], timeout=10.0, clock=lambda: clock[0])
    clock[0] = 5.0
    hb.beat("h0")
    clock[0] = 12.0
    assert hb.dead_hosts() == ["h1"]
    assert hb.alive_hosts() == ["h0"]


def test_straggler_detection():
    det = StragglerDetector(factor=1.5, patience=2)
    for _step in range(4):
        for h in ["h0", "h1", "h2", "h3"]:
            det.record(h, 1.0 if h != "h3" else 3.0)
        slow = det.stragglers()
    assert slow == ["h3"]


def test_elastic_planner_shrinks():
    pl = ElasticPlanner(model_parallel=16, pod_size=256)
    plan = pl.plan(512)
    assert plan.shape == (2, 16, 16) and plan.dropped == 0
    plan = pl.plan(500)
    assert plan.devices_used == 496 and plan.shape[-1] == 16
    with pytest.raises(RuntimeError):
        pl.plan(8)


def test_fault_policy_remesh_on_death():
    clock = [0.0]
    hb = HeartbeatTracker(["h0", "h1"], timeout=1.0, clock=lambda: clock[0])
    pol = FaultPolicy(hb, StragglerDetector(), ElasticPlanner(model_parallel=2),
                      devices_per_host=4)
    assert pol.decide(0) == "continue"
    clock[0] = 5.0
    hb.beat("h0")
    clock[0] = 5.5
    assert pol.decide(1) == "remesh"
    assert pol.replan().devices_used == 4


def test_preemption_checkpoints():
    pol = FaultPolicy(HeartbeatTracker(["h0"], timeout=1e9), StragglerDetector(),
                      ElasticPlanner(model_parallel=1))
    assert pol.decide(3, preempted=True) == "checkpoint_now"


def _policies(rng, n_hosts, mp, pod):
    """The same policy in both packages over one injectable clock."""
    clock = [0.0]
    timeout = float(rng.uniform(1.0, 4.0))
    hosts = [f"h{i}" for i in range(n_hosts)]
    factor, patience = float(rng.uniform(1.2, 2.0)), int(rng.integers(1, 4))
    mk = lambda m: m.FaultPolicy(  # noqa: E731
        m.HeartbeatTracker(hosts, timeout=timeout, clock=lambda: clock[0]),
        m.StragglerDetector(factor=factor, patience=patience, window=5),
        m.ElasticPlanner(model_parallel=mp, pod_size=pod), devices_per_host=4)
    import repro_torch.runtime.health as thealth
    return clock, hosts, mk(jhealth), mk(thealth)


@given(st.integers(0, 100_000))
@settings(max_examples=40, deadline=None)
def test_fault_policy_matches_jax(seed):
    """Random schedules: each step the clock moves, a random subset of
    hosts beats, every live host reports a step time (some hosts slow for
    a while), a preemption now and then; both policies decide the same at
    every step, log the same events, and replan to the same mesh (or both
    refuse)."""
    rng = np.random.default_rng(seed)
    clock, hosts, jp, tp = _policies(rng, int(rng.integers(1, 7)),
                                     int(rng.choice([1, 2, 4])),
                                     int(rng.choice([4, 8, 256])))
    slow = {h: rng.random() < 0.3 for h in hosts}
    for step in range(25):
        clock[0] += float(rng.uniform(0.1, 1.5))
        for h in hosts:
            if rng.random() < 0.8:
                jp.tracker.beat(h)
                tp.tracker.beat(h)
            t = float(rng.uniform(0.9, 1.1) * (3.0 if slow[h] else 1.0))
            jp.detector.record(h, t)
            tp.detector.record(h, t)
        pre = bool(rng.random() < 0.05)
        d = jp.decide(step, preempted=pre)
        assert tp.decide(step, preempted=pre) == d
        if d == "remesh":
            try:
                want = jp.replan()
            except RuntimeError:
                with pytest.raises(RuntimeError):
                    tp.replan()
            else:
                assert dataclasses.astuple(tp.replan()) == dataclasses.astuple(want)
    assert [(e.step, e.kind, e.hosts) for e in tp.events] == [
        (e.step, e.kind, e.hosts) for e in jp.events]


# ------------------------------------------------------------------ compression
def test_topk_roundtrip():
    flat = torch.tensor([0.0, 5.0, -3.0, 0.1, 0.0, -7.0])
    dense = decompress(compress_topk(flat, k=2))
    assert float(dense[5]) == -7.0 and float(dense[1]) == 5.0
    assert int(torch.count_nonzero(dense)) == 2


@given(st.integers(1, 60), st.integers(0, 1000))
@settings(max_examples=25, deadline=None)
def test_topk_indices_match_jax_with_ties(k, seed):
    """Magnitudes from a small set (many ties, of both signs): the kept
    indices, their order and values equal ``lax.top_k``'s, which puts the
    lower index first among equals."""
    rng = np.random.default_rng(seed)
    flat = (rng.integers(-4, 5, size=64) * 0.5).astype(np.float32)
    want = jcomp.compress_topk(jnp.asarray(flat), k)
    got = compress_topk(torch.from_numpy(flat), k)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert got.size == want.size == 64
    np.testing.assert_array_equal(decompress(got).numpy(),
                                  np.asarray(jcomp.decompress(want)))


def test_error_feedback_conserves_mass():
    """transmitted + residual == grad + old residual (nothing lost), over
    two rounds, and the same queues and residuals as JAX's."""
    rng = np.random.default_rng(0)
    g = {"w": rng.normal(size=(64,)).astype(np.float32),
         "b": [rng.normal(size=(8, 4)).astype(np.float32)]}
    tg = opt.tree_map(torch.from_numpy, g)
    jg = jax.tree.map(jnp.asarray, g)
    ef, jef = EFState.init(tg), jcomp.EFState.init(jg)
    for _ in range(2):
        old = opt.tree_map(torch.clone, ef.residual)
        comp, ef = compress_with_error_feedback(tg, ef, density=0.1)
        jq, jef = jcomp.compress_with_error_feedback(jg, jef, density=0.1)
        sent = decompress(comp["w"]) + ef.residual["w"]
        np.testing.assert_allclose(sent.numpy(), (tg["w"] + old["w"]).numpy(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(comp["b"][0].indices.numpy(),
                                      np.asarray(jq["b"][0].indices))
        for a, b in zip(opt.tree_leaves(ef.residual), jax.tree.leaves(jef.residual)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_error_feedback_converges():
    rng = np.random.default_rng(1)
    target = torch.from_numpy(rng.normal(size=(200,)).astype(np.float32))
    x = torch.zeros(200)
    ef = EFState.init({"x": x})
    for _ in range(600):
        comp, ef = compress_with_error_feedback({"x": x - target}, ef, density=0.1)
        x = x - 0.05 * decompress(comp["x"])
    assert float((x - target).norm()) < 0.1 * float(target.norm())


def test_compression_ratio_matches_jax():
    sizes = {"a": 1000, "b": [37, 5]}
    assert compression_ratio(sizes, 0.01) == jcomp.compression_ratio(sizes, 0.01)


# ------------------------------------------------------------------ data
@given(st.integers(0, 1000), st.integers(0, 50))
@settings(max_examples=10, deadline=None)
def test_token_stream_equals_jax(seed, step):
    want = JTokenStream(vocab=300, seed=seed).batch(step, 3, 80)
    got = TokenStream(vocab=300, seed=seed).batch(step, 3, 80)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_token_stream_motifs():
    b = TokenStream(vocab=1000, seed=0, motif_len=8, motif_every=32).batch(
        0, 1, 128)["tokens"][0]
    np.testing.assert_array_equal(b[32:40], b[0:8])  # planted copy


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_batcher_splits_contiguously(n):
    stream = TokenStream(vocab=100, seed=2)
    whole = ShardedBatcher(stream, 8, 16, device="cpu")(3)
    shards = ShardedBatcher(stream, 8, 16, devices=["cpu"] * n)(3)
    assert len(shards) == n
    for k in ("tokens", "labels"):
        assert whole[k].dtype == torch.int32
        np.testing.assert_array_equal(whole[k].numpy(), stream.batch(3, 8, 16)[k])
        assert torch.equal(torch.cat([s[k] for s in shards]), whole[k])
    with pytest.raises(ValueError):
        ShardedBatcher(stream, 6, 16, devices=["cpu"] * 4)


# ------------------------------------------------------------------ loop
def _tiny():
    cfg = dataclasses.replace(ARCHS["stablelm-3b"].SMOKE, n_layers=1,
                              d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                              vocab=128)
    data = ShardedBatcher(TokenStream(vocab=128, seed=0), 4, 32, device="cpu")
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                           weight_decay=0.0)
    return build_model(cfg), data, ocfg


def _gen():
    return torch.Generator().manual_seed(0)


def test_loss_decreases_and_resumes(tmp_path):
    model, data, ocfg = _tiny()
    state, hist = run(model, data, LoopConfig(30, 10, str(tmp_path), 5), ocfg,
                      _gen(), device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert [h["step"] for h in hist] == [1, 5, 10, 15, 20, 25, 30]
    assert state.step == 30 and ckpt.latest_step(tmp_path) == 30
    state2, hist2 = run(model, data, LoopConfig(35, 10, str(tmp_path), 5), ocfg,
                        _gen(), device="cpu")
    assert state2.step == 35 and [h["step"] for h in hist2] == [31, 35]


def test_resume_equals_uninterrupted(tmp_path):
    """20 steps with checkpoints, then a run to 30 that resumes from the
    step-20 checkpoint: its state ``torch.equal`` to 30 uninterrupted
    steps (parameters, both moments, the step)."""
    model, data, ocfg = _tiny()
    run(model, data, LoopConfig(20, 10, str(tmp_path), 10), ocfg, _gen(), device="cpu")
    resumed, _ = run(model, data, LoopConfig(30, 10, str(tmp_path), 10), ocfg,
                     _gen(), device="cpu")
    whole, _ = run(model, data, LoopConfig(30, 10, None, 10), ocfg, _gen(),
                   device="cpu")
    assert resumed.step == whole.step == 30
    for a, b in zip(opt.tree_leaves([resumed.params, resumed.mu, resumed.nu]),
                    opt.tree_leaves([whole.params, whole.mu, whole.nu])):
        assert torch.equal(a, b)


def test_preemption_checkpoints_and_yields(tmp_path):
    """A preemption signalled during step 4 checkpoints at step 4 and ends
    the run; the restart resumes there."""
    model, data, ocfg = _tiny()
    calls = []
    pol = FaultPolicy(HeartbeatTracker(["h0"], timeout=1e9), StragglerDetector(),
                      ElasticPlanner(model_parallel=1))

    def preempted():
        calls.append(1)
        return len(calls) == 4

    state, _ = run(model, data, LoopConfig(10, 100, str(tmp_path), 1), ocfg, _gen(),
                   policy=pol, preempted=preempted, device="cpu")
    assert state.step == 4 and ckpt.latest_step(tmp_path) == 4
    assert [e.kind for e in pol.events] == ["preemption"]
    state2, hist = run(model, data, LoopConfig(6, 100, str(tmp_path), 1), ocfg,
                       _gen(), device="cpu")
    assert state2.step == 6 and [h["step"] for h in hist] == [5, 6]


def test_remesh_checkpoints_and_replans(tmp_path):
    """A host that stops beating is dead after its timeout: the loop
    checkpoints, asks the planner for the smaller mesh and hands it to
    ``on_remesh``."""
    model, data, ocfg = _tiny()
    clock = [0.0]
    hb = HeartbeatTracker(["h0", "h1"], timeout=2.5, clock=lambda: clock[0])
    pol = FaultPolicy(hb, StragglerDetector(), ElasticPlanner(model_parallel=2),
                      devices_per_host=4)
    plans = []

    def data_iter(step):
        clock[0] = float(step)
        hb.beat("h0")   # h1 never beats again
        return data(step)

    state, _ = run(model, data_iter, LoopConfig(10, 100, str(tmp_path), 1), ocfg,
                   _gen(), policy=pol, on_remesh=plans.append, device="cpu")
    # h1 last beat at 0: dead once the clock passes 2.5, in step index 3
    assert state.step == 4 and ckpt.latest_step(tmp_path) == 4
    assert [(e.step, e.kind, e.hosts) for e in pol.events] == [(3, "dead_host", ["h1"])]
    assert len(plans) == 1 and plans[0].devices_used == 4


def test_compressed_step_matches_jax():
    """One ``make_compressed_train_step`` step (top 1 % per leaf with
    error feedback) from the same parameters and batch: the same kept
    indices per leaf, the loss at rtol 1e-5, and the state and residuals
    within 1e-3 of each leaf's largest JAX entry."""
    from torch_lm_ref import np_params
    model, data, ocfg = _tiny()
    from repro.models.registry import build_model as jbuild
    jmodel = jbuild(model.cfg)
    npp = np_params(jmodel.specs, seed=0)
    jp = jax.tree.map(jnp.asarray, npp)
    tp = opt.tree_map(torch.from_numpy, npp)
    jcfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                            weight_decay=0.0)
    batch = data(0)
    (js, jef), jm = jax.jit(jcompressed_step(jmodel, jcfg))(
        (jopt.init_state(jp, jcfg), jcomp.EFState.init(jp)),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    (ts, tef), tm = make_compressed_train_step(model, ocfg)(
        (opt.init_state(tp, ocfg), EFState.init(tp)), batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    for part_t, part_j in ((ts.params, js.params), (ts.mu, js.mu),
                           (tef.residual, jef.residual)):
        for a, b in zip(opt.tree_leaves(part_t), jax.tree.leaves(part_j)):
            b = to_np(b)
            assert np.abs(to_np(a) - b).max() <= 1e-3 * np.abs(b).max()
    for a, b in zip(opt.tree_leaves(ts.mu), jax.tree.leaves(js.mu)):
        np.testing.assert_array_equal(to_np(a) != 0, to_np(b) != 0)
