"""Streaming DVS ingestion of the port against the JAX package.

The same numpy events go through both packages: the synthetic traces,
the appends into the interlace banks, the queues finalized from the banks
(JAX's sort-free ``stream_queues`` against the port's one route, the
builder over the banks viewed as frames), the fused carrier built from
the banks, the chunk iterator, and the streamed chunk step of the
network.  Everything is exact except logits
against JAX (``LOGIT_TOL``: the FC product sums in another order); the
port's streamed step also equals its own binned step exactly, logits
included, and so does the streaming engine.  On the CPU the port's kernel
wrappers run their plain versions.

    PYTHONPATH=src python -m pytest -q tests/test_torch_streaming.py
"""
import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aeq as jaeq
from repro.core import csnn as jc
from repro.core.geometry import ConvGeometry as JGeom
from repro.core.plan import plan_network as jplan
from repro.data import dvs as jdvs
from repro_torch.convert import params_from_numpy
from repro_torch.core import aeq as taeq
from repro_torch.core import csnn as tc
from repro_torch.core.geometry import ConvGeometry as TGeom
from repro_torch.core.plan import plan_network as tplan
from repro_torch.data import dvs as tdvs
from repro_torch.serve.csnn_engine import CSNNEngine, CSNNServeConfig

LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)
TIMEOUT_S = 60.0


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _random_events(rng, t_bins, hw, channels, n):
    """n in-window rows (duplicates likely) plus one out-of-window row per
    coordinate bound, shuffled."""
    h, w = hw
    ev = np.stack([rng.integers(0, t_bins, n), rng.integers(0, h, n),
                   rng.integers(0, w, n), rng.integers(0, channels, n)],
                  axis=-1)
    bad = [[-1, 0, 0, 0], [t_bins, 0, 0, 0], [0, -2, 0, 0], [0, h, 0, 0],
           [0, 0, -1, 0], [0, 0, w, 0], [0, 0, 0, -1], [0, 0, 0, channels]]
    ev = np.concatenate([ev, bad]).astype(np.int32)
    rng.shuffle(ev, axis=0)
    return ev


def _ingest_port(ev, t_bins, hw, channels, geom, pieces, rng):
    """Append ``ev`` permuted, in ``pieces`` chunks with 3 padding rows
    each (which ``num`` must hide)."""
    ev = ev[rng.permutation(ev.shape[0])]
    state = taeq.init_stream_state(hw, t_bins, channels, geometry=geom,
                                   device="cpu")
    cuts = sorted(rng.integers(0, ev.shape[0] + 1, pieces - 1).tolist())
    for part in np.split(ev, cuts):
        chunk = taeq.make_stream_chunk(part, buffer=part.shape[0] + 3,
                                       device="cpu")
        state = taeq.append_events(state, chunk, hw, geom)
    return state


# ------------------------------------------------- traces and appends
@pytest.mark.parametrize("seed,hw,classes", [(0, (28, 28), 4),
                                             (7, (12, 9), 8)])
def test_dvs_traces_frames_and_banks_equal_jax(seed, hw, classes):
    jt, jl = jdvs.dvs_moving_edges(5, 5, hw, classes=classes, seed=seed)
    tt, tl = tdvs.dvs_moving_edges(5, 5, hw, classes=classes, seed=seed)
    np.testing.assert_array_equal(jl, tl)
    junk = np.array([[-1, 0, 0, 0], [5, 0, 0, 1], [0, hw[0], 0, 0],
                     [0, 0, -1, 1], [0, 0, 0, 2]], np.int32)
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a, b)
        ev = np.concatenate([b, junk, b[:7]])
        np.testing.assert_array_equal(jdvs.events_to_frames(ev, 5, hw),
                                      tdvs.events_to_frames(ev, 5, hw))
        for k in (1, 3, 5):
            np.testing.assert_array_equal(
                jdvs.events_to_banks(ev, 5, hw, geometry=JGeom(k, k)),
                tdvs.events_to_banks(ev, 5, hw, geometry=TGeom(k, k)))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_appends_equal_jax_and_ignore_order_and_chunking(k):
    hw, t_bins, c = (7, 9), 3, 2
    jg, tg = JGeom(k, k), TGeom(k, k)
    rng = np.random.default_rng(k)
    ev = _random_events(rng, t_bins, hw, c, 60)
    doubled = np.concatenate([ev, ev])
    jstate = jaeq.append_events(
        jaeq.init_stream_state(hw, t_bins, c, geometry=jg),
        jaeq.make_stream_chunk(ev, buffer=ev.shape[0] + 3), hw, jg)
    for pieces in (1, 4):
        state = _ingest_port(doubled, t_bins, hw, c, tg, pieces, rng)
        _eq(jstate.banks, state.banks)
    # the binned frames of the same events, and the numpy admission
    frames = taeq.stream_frames(state, hw, tg).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(
        frames.numpy(), tdvs.events_to_frames(ev, t_bins, hw, c))
    np.testing.assert_array_equal(
        state.banks.numpy(),
        tdvs.events_to_banks(ev, t_bins, hw, c, geometry=tg))
    empty = taeq.append_events(state, taeq.make_stream_chunk(
        np.zeros((0, 4), np.int32), buffer=5, device="cpu"), hw, tg)
    assert torch.equal(empty.banks, state.banks)
    # batched: one row per trace, each equal to its own append
    rows = [_random_events(rng, t_bins, hw, c, 25) for _ in range(3)]
    depth = max(r.shape[0] for r in rows)
    chunks = [taeq.make_stream_chunk(r, buffer=depth, device="cpu")
              for r in rows]
    batched = taeq.append_events_batched(
        taeq.init_stream_state(hw, t_bins, c, lead=(3,), geometry=tg,
                               device="cpu"),
        taeq.StreamChunk(events=torch.stack([ch.events for ch in chunks]),
                         num=torch.stack([ch.num for ch in chunks])), hw, tg)
    jbatched = jaeq.append_events_batched(
        jaeq.init_stream_state(hw, t_bins, c, lead=(3,), geometry=jg),
        jaeq.StreamChunk(events=jnp.stack([np.asarray(ch.events)
                                           for ch in chunks]),
                         num=jnp.asarray([r.shape[0] for r in rows],
                                         jnp.int32)), hw, jg)
    _eq(jbatched.banks, batched.banks)
    for i, ch in enumerate(chunks):
        one = taeq.append_events(taeq.init_stream_state(
            hw, t_bins, c, geometry=tg, device="cpu"), ch, hw, tg)
        assert torch.equal(batched.banks[i], one.banks)


def test_append_and_chunk_errors():
    state = taeq.init_stream_state((7, 9), 2, 2, lead=(3,), device="cpu")
    chunk = taeq.make_stream_chunk(np.zeros((2, 4), np.int32), device="cpu")
    with pytest.raises(ValueError, match="leading dims"):
        taeq.append_events_batched(state, taeq.StreamChunk(
            chunk.events[None], chunk.num[None]), (7, 9))
    with pytest.raises(ValueError, match="exceed"):
        taeq.make_stream_chunk(np.zeros((4, 4), np.int32), buffer=3,
                               device="cpu")
    with pytest.raises(ValueError, match="columns"):
        taeq.fused_handoff_from_banks(
            taeq.init_stream_state((7, 9), 2, 2, lead=(1,),
                                   device="cpu").banks,
            16, (7, 9), geometry=TGeom(5, 5))


def test_iter_stream_chunks_equal_jax_and_backpressure():
    ev = _random_events(np.random.default_rng(8), 6, (7, 9), 2, 60)
    ev = ev[(ev[:, 0] >= 0) & (ev[:, 0] < 6)]
    got = list(tdvs.iter_stream_chunks(ev, 6, 2, 80))
    want = list(jdvs.iter_stream_chunks(ev, 6, 2, 80))
    assert [g[0] for g in got] == [0, 2, 4] == [w[0] for w in want]
    for (t0, padded, num), (_, jpadded, jnum) in zip(got, want):
        np.testing.assert_array_equal(padded, jpadded)
        assert num == jnum and (padded[num:] == -1).all()
        state = taeq.append_events(
            taeq.init_stream_state((7, 9), 2, 2, device="cpu"),
            taeq.make_stream_chunk(padded, buffer=80, device="cpu"), (7, 9))
        np.testing.assert_array_equal(
            taeq.stream_frames(state, (7, 9)).permute(0, 2, 3, 1).numpy(),
            tdvs.events_to_frames(ev, 6, (7, 9))[t0:t0 + 2])
    with pytest.raises(ValueError, match="ingest buffer"):
        list(tdvs.iter_stream_chunks(ev, 6, 2, buffer=4))


# ------------------------------------------------------ queues, carrier
_jax_stream_queues = jax.jit(jaeq.stream_queues,
                             static_argnames=("capacity", "hw", "interlaced",
                                              "geometry"))
_jax_segment_pad = jax.jit(jaeq.segment_pad,
                           static_argnames=("event_par", "geometry"))
_jax_carrier = jax.jit(jaeq.fused_handoff_from_banks,
                       static_argnames=("capacity", "hw", "geometry"))


@pytest.mark.parametrize("k,hw,t_bins,c,n,cap", [
    (1, (7, 9), 3, 2, 120, 16),    # truncating: demand > capacity
    (3, (7, 9), 3, 2, 120, 16),
    (5, (7, 9), 3, 2, 120, 16),
    (3, (6, 6), 2, 1, 200, 36),    # heavy duplicates, capacity == H*W
    (5, (5, 8), 1, 3, 10, 48),     # capacity > H*W
    (3, (9, 9), 1, 1, 300, 2),     # capacity below one interlace column
], ids=["truncating-k1", "truncating-k3", "truncating-k5", "cap-hw",
        "cap-above-hw", "cap-2"])
def test_stream_queues_and_carrier_equal_jax_and_binned(k, hw, t_bins, c, n,
                                                        cap):
    jg, tg = JGeom(k, k), TGeom(k, k)
    rng = np.random.default_rng(n + cap + k)
    ev = _random_events(rng, t_bins, hw, c, n)
    state = _ingest_port(ev, t_bins, hw, c, tg, 3, rng)
    jstate = jaeq.StreamState(banks=jnp.asarray(state.banks.numpy()))
    frames = taeq.stream_frames(state, hw, tg)          # (T, C, H, W)
    want = _jax_stream_queues(jstate, capacity=cap, hw=hw, geometry=jg)
    for event_par in (1, 4):
        # JAX's queues of the banks, segment-padded, in the launch layout
        # (T, C, B=1, ...) of the port's builder over the same banks
        padded = (want if event_par == 1 else
                  _jax_segment_pad(want, event_par=event_par, geometry=jg))
        coords, valid, count = taeq.build_launch_queues(
            frames.permute(0, 2, 3, 1)[None], cap, event_par, tg)
        _eq(np.asarray(padded.coords)[:, :, None], coords)
        _eq(np.asarray(padded.valid)[:, :, None], valid)
        _eq(np.asarray(padded.count)[:, None], count)
    # the fused carrier from the banks of a batch of two windows
    other = _ingest_port(_random_events(rng, t_bins, hw, c, n // 2), t_bins,
                         hw, c, tg, 1, rng)
    banks = torch.stack([state.banks, other.banks])
    ho = taeq.fused_handoff_from_banks(banks, cap, hw, tg)
    spikes = taeq.stream_frames(taeq.StreamState(banks), hw, tg)
    want = taeq.build_fused_handoff(spikes.permute(0, 1, 3, 4, 2), cap, tg)
    assert torch.equal(ho.masks, want.masks)
    assert torch.equal(ho.count, want.count)
    jho = _jax_carrier(jnp.asarray(banks.numpy()), capacity=cap, hw=hw,
                       geometry=jg)
    _eq(jho.masks, ho.masks)
    _eq(jho.count, ho.count)


# -------------------------------------------------- the streamed chunk step
def _cfgs(k):
    def cfg(mod):
        return mod.CSNNConfig(input_hw=(12, 12), input_channels=2,
                              layers=(mod.ConvSpec(8, kernel=k),
                                      mod.ConvSpec(8, pool=3),
                                      mod.FCSpec(10)),
                              t_steps=4)
    return cfg(jc), cfg(tc)


def _traces(cfg, n, seed=13):
    traces, _ = tdvs.dvs_moving_edges(n, cfg.t_steps, cfg.input_hw,
                                      seed=seed)
    geom = TGeom(cfg.layers[0].kernel, cfg.layers[0].kernel)
    banks = np.stack([tdvs.events_to_banks(tr, cfg.t_steps, cfg.input_hw,
                                           geometry=geom) for tr in traces])
    frames = np.stack([tdvs.events_to_frames(tr, cfg.t_steps, cfg.input_hw)
                       for tr in traces])
    return traces, banks, frames


def _port_chunked(params, cfg, plan, inputs, streamed):
    """Chunked forward over banks (B, T, C, nb, HB, WB) or frames
    (B, T, H, W, C): (logits, state, per-chunk stats)."""
    state = tc.init_state(params, cfg, plan, inputs.shape[0])
    chunks = []
    for t0 in range(0, cfg.t_steps, plan.chunk_steps):
        x = inputs[:, t0:t0 + plan.chunk_steps]
        state, stats = tc.snn_step_chunk(
            params, state, taeq.StreamState(x) if streamed else x, cfg,
            plan, collect_stats=True)
        chunks.append(stats)
    return tc.snn_readout(params, state, cfg, plan), state, chunks


def _params(k, sat_bits):
    jcfg, _ = _cfgs(k)
    np_params = jax.tree.map(np.asarray,
                             jc.init_params(jax.random.PRNGKey(k), jcfg))
    if sat_bits:
        np_params = jax.tree.map(
            lambda x: np.clip(np.round(x * 16), -100, 100).astype(np.float32),
            np_params)
    return np_params


# capacity 40 < 144 cells: the input queues truncate
KNOBS = dict(capacity=40, channel_block=4, batch_tile=3, ingest=True)


@functools.cache
def _jax_streamed(k, sat_bits):
    """JAX's streamed step over the whole window (jitted; sequential
    variant, ranks finalization).  JAX's variants and finalizations agree
    exactly with each other, and chaining chunks is exact, so one run per
    network is the reference of every port case."""
    jcfg, tcfg = _cfgs(k)
    plan = jplan(jcfg, event_par=1, sat_bits=sat_bits,
                 stream_finalize="ranks", **KNOBS)
    _, banks, _ = _traces(tcfg, 3)

    def run(p, b):
        state = jc.init_state(p, jcfg, plan, b.shape[0])
        state, stats = jc.snn_step_chunk(p, state, jaeq.StreamState(b), jcfg,
                                         plan, collect_stats=True)
        return jc.snn_readout(p, state, jcfg, plan), state, stats
    return jax.tree.map(np.asarray, jax.jit(run)(
        jax.tree.map(jnp.asarray, _params(k, sat_bits)), jnp.asarray(banks)))


@pytest.mark.parametrize("k,event_par,sat_bits,variant", [
    (3, 1, None, None),
    (5, 4, None, None),
    (3, 4, None, None),
    (3, None, 16, None),
    (5, 1, None, None),
    (3, 1, None, "banked-cuda"),
    (3, 1, None, "fused-handoff"),
], ids=["seq-ranks", "k5-interlaced", "interlaced-ranks", "auto-i16",
        "k5-seq", "banked", "fused"])
def test_streamed_step_equals_binned_and_jax(k, event_par, sat_bits, variant):
    _, tcfg = _cfgs(k)
    _, banks, frames = _traces(tcfg, 3)
    kw = dict(KNOBS, t_chunk=2, event_par=event_par, sat_bits=sat_bits)
    tp = tplan(tcfg, variant=variant, **kw)
    params = params_from_numpy(_params(k, sat_bits), "cpu")
    tb, tf = torch.from_numpy(banks), torch.from_numpy(frames)
    ls, ss, cs = _port_chunked(params, tcfg, tp, tb, streamed=True)
    lb, sb, cb = _port_chunked(params, tcfg, tp, tf, streamed=False)
    assert torch.equal(ls, lb)
    for a, b in zip(ss.convs, sb.convs):
        assert torch.equal(a.vm, b.vm) and torch.equal(a.fired, b.fired)
    assert torch.equal(ss.fc_drive, sb.fc_drive)
    for chunk_s, chunk_b in zip(cs, cb):
        for a, b in zip(chunk_s, chunk_b):
            assert torch.equal(a.in_spike_counts, b.in_spike_counts)
            assert torch.equal(a.out_spike_counts, b.out_spike_counts)
            assert torch.equal(a.in_sparsity, b.in_sparsity)
    jl, js, jstats = _jax_streamed(k, sat_bits)
    np.testing.assert_allclose(np.asarray(jl), ls.numpy(), **LOGIT_TOL)
    np.testing.assert_array_equal(np.asarray(jl).argmax(-1),
                                  ls.numpy().argmax(-1))
    for a, b in zip(js.convs, ss.convs):
        _eq(a.vm, b.vm)
        _eq(a.fired, b.fired)
    _eq(js.fc_drive, ss.fc_drive)
    for i, a in enumerate(jstats):
        for f in ("in_spike_counts", "out_spike_counts"):
            _eq(getattr(a, f), torch.cat([getattr(chunk[i], f)
                                          for chunk in cs], dim=1))


def test_ingest_plan_fields_and_finalize_resolution():
    """The ingestion sizing; the port's plan has no streamed-finalize
    field or option (one streamed route)."""
    _, tcfg = _cfgs(3)
    plan = tplan(tcfg, capacity=64, ingest=True)
    lp0, lp1 = plan.layers
    assert lp0.ingest_depth == tcfg.t_steps and lp0.ingest_capacity % 64 == 0
    assert lp1.ingest_capacity is None and lp1.ingest_depth is None
    assert "ingest=" in repr(lp0) and "ingest=" not in repr(lp1)
    assert tplan(tcfg, ingest=True, t_chunk=2).layers[0].ingest_depth == 2
    assert tplan(tcfg, ingest_capacity=512).layers[0].ingest_capacity == 512
    assert not hasattr(lp0, "stream_finalize") and "finalize" not in repr(lp0)
    with pytest.raises(TypeError, match="stream_finalize"):
        tplan(tcfg, ingest=True, stream_finalize="ranks")
    from repro_torch.core.plan import plan_conv_layer
    with pytest.raises(ValueError, match="ingest"):
        plan_conv_layer(0, "conv0", (12, 12), 2, 8, capacity=64,
                        ingest_capacity=128)
    import dataclasses
    bad = dataclasses.replace(lp0, ingest_depth=9)
    with pytest.raises(ValueError, match="ingest_depth"):
        dataclasses.replace(plan, layers=(bad, lp1)).validate(tcfg)


# ------------------------------------------------------------- the engine
def test_stream_engine_equals_streamed_run_and_binned_batch():
    _, tcfg = _cfgs(3)
    params = tc.init_params(tcfg, seed=2, device="cpu")
    traces, banks, frames = _traces(tcfg, 5, seed=3)
    plan = tplan(tcfg, capacity=64, channel_block=4, t_chunk=2, ingest=True,
                 batch_tile=4)
    with pytest.raises(ValueError, match="continuous"):
        CSNNEngine(params, tcfg, plan, CSNNServeConfig(stream=True))
    engine = CSNNEngine(params, tcfg, plan, CSNNServeConfig(
        max_batch=4, continuous=True, stream=True, t_chunk=2))
    assert engine.warmup() > 0.0
    got = engine.run_requests(traces, timeout=TIMEOUT_S)
    want, _, _ = _port_chunked(params, tcfg, plan, torch.from_numpy(banks),
                               streamed=True)
    assert torch.equal(got, want)
    binned = tc.snn_apply_batched(params, torch.from_numpy(frames), tcfg,
                                  plan, collect_stats=False)
    assert torch.equal(got, binned)
    # 4 slots: the fifth trace waits for the first four to retire
    assert engine.stats["admitted"] == engine.stats["retired"] == 5
    assert engine.stats["chunks"] == 4

    # a malformed trace fails its own future, the engine serves on
    async def drive():
        async with engine:
            bad = engine.submit_nowait(np.zeros((3, 5), np.int32))
            good = engine.submit_nowait(traces[0])
            with pytest.raises(ValueError, match=r"\(N, 4\)"):
                await bad
            return await good

    one = asyncio.run(asyncio.wait_for(drive(), TIMEOUT_S))
    assert torch.equal(one, want[0])
