"""The port's spans and engine counters (``repro_torch.runtime.spans``),
and ``LayerStats`` computed only when asked, on the CPU.

With no profiler running no span is entered; under ``torch.profiler``
each micro-batch is one ``csnn.engine.launch`` and one
``csnn.engine.resolve`` with the same sequence number, and each conv
layer's runner call one ``csnn.conv<i>`` per chunk inside the launch.
``collect_stats=False`` leaves the logits bit for bit as they are and
computes no statistic; with ``collect_stats=True`` the statistics equal
the JAX package's.

    PYTHONPATH=src python -m pytest -q tests/test_torch_spans.py
"""
import asyncio
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.configs import csnn_paper as jpaper
from repro.core import csnn as jc
from repro.core.plan import plan_network as jplan
from repro_torch.configs import csnn_paper as tpaper
from repro_torch.convert import params_from_numpy
from repro_torch.core import csnn as tc
from repro_torch.core import scheduler
from repro_torch.core.plan import plan_network as tplan
from repro_torch.runtime import spans
from repro_torch.serve.csnn_engine import CSNNEngine, CSNNServeConfig

TIMEOUT_S = 60.0
CFG = tpaper.SMOKE          # 12x12x1-8C3-8C3-P3-F10, T=4
N_CONV = 2
KNOBS = dict(capacity=144, channel_block=4, batch_tile=4)
LAYER = re.compile(r"csnn\.conv\d+")  # a layer's span, not one inside it


@pytest.fixture(scope="module")
def net():
    """(numpy params, port params, images (6, 12, 12, 1))."""
    np_params = jax.tree.map(
        np.asarray, jc.init_params(jax.random.PRNGKey(5), jpaper.SMOKE))
    imgs = torch.from_numpy(np.random.default_rng(5)
                            .random((6, 12, 12, 1)).astype(np.float32))
    return np_params, params_from_numpy(np_params, "cpu"), imgs


@pytest.fixture
def entered(monkeypatch):
    """A list that grows by the name of every span entered."""
    names = []
    real = spans._record

    def counting(name, *args):
        names.append(name)
        return real(name, *args)

    monkeypatch.setattr(spans, "_record", counting)
    return names


def _serve(engine, imgs):
    """Submit every image inside the engine's context and gather the
    logits, bounded by ``TIMEOUT_S``."""
    async def drive():
        async with engine:
            futs = [engine.submit_nowait(img) for img in imgs]
            return await asyncio.gather(*futs)
    return torch.stack(asyncio.run(asyncio.wait_for(drive(), TIMEOUT_S)))


def _chunks(plan) -> int:
    return CFG.t_steps // plan.chunk_steps


def _profiled(fn):
    """Run ``fn`` under a CPU profiler that records span args; returns
    its result and the ``csnn.*`` events as (name, start, end, args)."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        out = fn()
    events = sorted(((e.name, e.time_range.start, e.time_range.end,
                      dict(e.kwinputs or {}))
                     for e in p.events() if e.name.startswith(spans.PREFIX)),
                    key=lambda e: e[1])
    return out, events


def test_no_profiler_no_span(net, entered):
    _, params, imgs = net
    plan = tplan(CFG, t_chunk=2, **KNOBS)
    tc.snn_apply_batched(params, tc.encode_input(imgs, CFG), CFG, plan,
                         collect_stats=False)
    _serve(CSNNEngine(params, CFG, plan, CSNNServeConfig(max_batch=4)), imgs)
    _serve(CSNNEngine(params, CFG, plan, CSNNServeConfig(
        max_batch=4, continuous=True, t_chunk=2)), imgs)
    assert entered == []
    # the same calls under a profiler pass through the patched entry
    _profiled(lambda: tc.snn_apply_batched(
        params, tc.encode_input(imgs, CFG), CFG, plan, collect_stats=False))
    layer = [f"csnn.conv{i}{inner}" for i in range(N_CONV)
             for inner in ("", ".queues", ".queues", ".launches")]
    assert entered == layer * 2 + ["csnn.readout"]


def test_microbatch_spans_per_batch(net):
    _, params, imgs = net
    plan = tplan(CFG, t_chunk=2, **KNOBS)
    engine = CSNNEngine(params, CFG, plan, CSNNServeConfig(max_batch=4))
    # one size flush of 4, then a deadline flush of 2 padded to 4
    logits, events = _profiled(lambda: _serve(engine, imgs))
    assert torch.equal(logits, tc.snn_apply_batched(
        params, tc.encode_input(imgs, CFG), CFG, plan, collect_stats=False))
    launches = [e for e in events if e[0] == "csnn.engine.launch"]
    resolves = [e for e in events if e[0] == "csnn.engine.resolve"]
    assert engine.stats["batches"] == 2
    assert [a["seq"] for *_, a in launches] == [0, 1]
    assert [a["seq"] for *_, a in resolves] == [0, 1]
    assert [(a["requests"], a["padded"]) for *_, a in launches] == \
        [(4, 4), (2, 4)]
    assert [a for *_, a in launches] == [a for *_, a in resolves]
    for (_, l0, l1, _), (_, r0, _, _) in zip(launches, resolves):
        assert l1 <= r0   # the device wait lies between them
        inside = [n for n, s, e, _ in events if l0 <= s and e <= l1
                  and LAYER.fullmatch(n)]
        # one span per conv layer and chunk of the batch's forward
        assert sorted(inside) == sorted(
            [f"csnn.conv{i}" for i in range(N_CONV)] * _chunks(plan))
    assert sum(bool(LAYER.fullmatch(n)) for n, *_ in events) == \
        2 * N_CONV * _chunks(plan)
    assert sum(n == "csnn.readout" for n, *_ in events) == 2


def test_continuous_spans_per_chunk(net):
    _, params, imgs = net
    plan = tplan(CFG, **KNOBS)
    engine = CSNNEngine(params, CFG, plan, CSNNServeConfig(
        max_batch=4, continuous=True, t_chunk=2))
    _, events = _profiled(lambda: _serve(engine, imgs[:3]))
    chunks = engine.stats["chunks"]
    launches = [a["seq"] for n, *_, a in events if n == "csnn.engine.launch"]
    resolves = [a["seq"] for n, *_, a in events if n == "csnn.engine.resolve"]
    assert launches == resolves == list(range(chunks))
    assert sum(n == "csnn.engine.encode" for n, *_ in events) == 3


@pytest.mark.parametrize("variant,event_par", [
    ("interlaced-cuda", 8), ("fused-handoff", 1)])
def test_queue_and_launch_spans_inside_each_layer(net, variant, event_par):
    """Each layer's span holds, per chunk, the build and layout of its
    event sets (``.queues``) and then its launch loop (``.launches``,
    with the block and step counts), in that order and inside it."""
    _, params, imgs = net
    plan = tplan(CFG, t_chunk=2, event_par=event_par,
                 variant=[variant, variant], **KNOBS)
    _, events = _profiled(lambda: tc.snn_apply_batched(
        params, tc.encode_input(imgs, CFG), CFG, plan, collect_stats=False))
    outer = [e for e in events if LAYER.fullmatch(e[0])]
    assert len(outer) == N_CONV * _chunks(plan)
    for name, l0, l1, _ in outer:
        inner = [(n, a) for n, s, e, a in events
                 if n.startswith(name + ".") and l0 <= s and e <= l1]
        kinds = [n[len(name) + 1:] for n, _ in inner]
        # every layer builds (or, given an emitted carrier, checks) its
        # event sets, then lays the slabs out
        assert kinds == ["queues", "queues", "launches"], kinds
        lp = plan.layers[int(name[len("csnn.conv"):])]
        assert inner[-1][1] == {"n_blocks": lp.c_out // lp.channel_block,
                                "t_steps": plan.chunk_steps}


def test_counters_grow_with_every_batch(net):
    _, params, imgs = net
    plan = tplan(CFG, **KNOBS)
    for serve_cfg in (CSNNServeConfig(max_batch=4),
                      CSNNServeConfig(max_batch=4, continuous=True)):
        engine = CSNNEngine(params, CFG, plan, serve_cfg)
        seen = []
        for k in range(3):  # two requests: one more batch, or chunk
            _serve(engine, imgs[2 * k:2 * k + 2])
            seen.append((engine.stats["queue_wait_ms_sum"],
                         engine.stats["launch_ms_sum"]))
        for before, after in zip([(0.0, 0.0)] + seen, seen):
            assert after[0] > before[0] and after[1] > before[1], seen


def _assert_stats(jstats, tstats):
    for a, b in zip(jstats, tstats):
        for f in ("in_spike_counts", "out_spike_counts"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f).numpy())
        np.testing.assert_allclose(np.asarray(a.in_sparsity),
                                   b.in_sparsity.numpy(), rtol=1e-6)


@pytest.mark.parametrize("t_chunk", [1, 4])
@pytest.mark.parametrize("variant,event_par", [
    ("sequential", 1), ("interlaced-cuda", 8), ("banked-cuda", 1),
    ("fused-handoff", 1)])
def test_stats_only_when_asked(net, monkeypatch, variant, event_par,
                               t_chunk):
    np_params, params, imgs = net
    spikes = tc.encode_input(imgs, CFG)
    plan = tplan(CFG, t_chunk=t_chunk, event_par=event_par,
                 variant=[None, variant], **KNOBS)
    logits, stats = tc.snn_apply_batched(params, spikes, CFG, plan)
    jlogits, jstats = jc.snn_apply_batched(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(spikes.numpy()),
        jpaper.SMOKE, jplan(jpaper.SMOKE, capacity=144, channel_block=4))
    _assert_stats(jstats, stats)
    np.testing.assert_array_equal(np.asarray(jlogits).argmax(-1),
                                  logits.numpy().argmax(-1))

    def no_stats(*a, **k):
        raise AssertionError("statistics computed without collect_stats")

    monkeypatch.setattr(tc, "_merge_chunk_stats", no_stats)
    monkeypatch.setattr(scheduler, "LayerStats", no_stats)
    assert torch.equal(tc.snn_apply_batched(params, spikes, CFG, plan,
                                            collect_stats=False), logits)
    state = tc.init_state(params, CFG, plan, imgs.shape[0])
    state = tc.snn_step_chunk(params, state, spikes[:, :t_chunk], CFG, plan)
    assert isinstance(state, tc.CSNNState)
