"""The port's batch sharding (``csnn.snn_apply_sharded`` over a list of
devices, ``sharding.specs.batch_devices``) against the port's own
``snn_apply_batched`` and the JAX package's, with the same numpy
parameters and inputs.

Shards here are ``torch.device("cpu")`` repeated (1, 2, 4 and 8 of
them): each runs the conv stack on its slice, the FC drives are
gathered and the FC head runs once on the whole batch.
Tolerances, with their reasons:

* against the port's ``snn_apply_batched``: logits ``torch.equal`` (the
  same head on the same (B, D) drive) and ``LayerStats`` equal;
* against JAX's ``snn_apply_batched`` (which JAX's sharded path equals
  bit for bit, tests/test_sharded.py): logits within ``LOGIT_TOL``
  (rtol=1e-5, atol=1e-4: JAX sums the head in float32, the port in
  float64), argmax and counts exact.

The CUDA streams of a shard on a card are exercised by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csnn as jc
from repro.core.plan import plan_network as jplan
from repro_torch.convert import params_from_numpy
from repro_torch.core import csnn as tc
from repro_torch.core.plan import plan_network as tplan
from repro_torch.sharding import specs

LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)
B = 8
CPU = torch.device("cpu")


def _cfgs(k):
    layers = dict(input_hw=(10, 10), t_steps=3)
    jcfg = jc.CSNNConfig(layers=(jc.ConvSpec(4, kernel=k),
                                 jc.ConvSpec(4, kernel=k, pool=3),
                                 jc.FCSpec(3)), **layers)
    tcfg = tc.CSNNConfig(layers=(tc.ConvSpec(4, kernel=k),
                                 tc.ConvSpec(4, kernel=k, pool=3),
                                 tc.FCSpec(3)), **layers)
    return jcfg, tcfg


def _case(k, seed=0, b=B):
    jcfg, tcfg = _cfgs(k)
    np_params = jax.tree.map(np.asarray,
                             jc.init_params(jax.random.PRNGKey(seed), jcfg))
    imgs = (np.random.default_rng(seed)
            .random((b,) + tuple(jcfg.input_hw) + (1,)).astype(np.float32))
    spikes = np.array(jc.encode_input(jnp.asarray(imgs), jcfg))
    return jcfg, tcfg, np_params, spikes


def _assert_stats_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("in_spike_counts", "out_spike_counts", "in_sparsity"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert (a.event_block, a.event_par) == (b.event_block, b.event_par)


# the serve plan's knobs (interlaced), the sequential unit, the banked
# pins (the fused one emits its carrier between layers) and one-step chunks
PLANS = {"interlaced": dict(event_par=None),
         "sequential": dict(event_par=1),
         "fused-handoff": dict(variant="fused-handoff"),
         "banked-cuda": dict(variant="banked-cuda"),
         "t_chunk=1": dict(event_par=1, t_chunk=1)}


@pytest.mark.parametrize("plan_name", list(PLANS))
@pytest.mark.parametrize("k", [1, 3, 5])
def test_sharded_equals_batched_and_jax(k, plan_name):
    jcfg, tcfg, np_params, spikes = _case(k, seed=k)
    knobs = dict(capacity=48, channel_block=4)  # 48 < 100 cells: truncation
    params = params_from_numpy(np_params, "cpu")
    tspikes = torch.from_numpy(spikes)
    plan = tplan(tcfg, **knobs, **PLANS[plan_name])
    want, wstats = tc.snn_apply_batched(params, tspikes, tcfg, plan)
    jlogits, jstats = jc.snn_apply_batched(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(spikes), jcfg,
        jplan(jcfg, **knobs, event_par=1), collect_stats=True)
    for n in (1, 2, 4, 8):
        got, stats = tc.snn_apply_sharded(params, tspikes, tcfg, plan,
                                          devices=[CPU] * n,
                                          collect_stats=True)
        assert torch.equal(got, want), n
        _assert_stats_equal(stats, wstats)
        np.testing.assert_allclose(np.asarray(jlogits), got.numpy(),
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(np.asarray(jlogits).argmax(-1),
                                      got.numpy().argmax(-1))
        for a, b in zip(jstats, stats):
            for f in ("in_spike_counts", "out_spike_counts"):
                np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                              getattr(b, f).numpy())
            np.testing.assert_allclose(np.asarray(a.in_sparsity),
                                       b.in_sparsity.numpy(), rtol=1e-6)


@pytest.mark.parametrize("sat_bits", [16, 8])
def test_sharded_int_datapaths(sat_bits):
    """Integer-valued parameters on the int rails: the shards equal the
    unsharded forward exactly."""
    jcfg, tcfg, np_params, spikes = _case(3, seed=5)
    np_params = jax.tree.map(
        lambda x: np.clip(np.round(x * 16), -100, 100).astype(np.float32),
        np_params)
    params = params_from_numpy(np_params, "cpu")
    tspikes = torch.from_numpy(spikes)
    for kw in (dict(event_par=None), dict(variant="fused-handoff")):
        plan = tplan(tcfg, capacity=48, channel_block=2, sat_bits=sat_bits,
                     **kw)
        want = tc.snn_apply_batched(params, tspikes, tcfg, plan,
                                    collect_stats=False)
        got = tc.snn_apply_sharded(params, tspikes, tcfg, plan,
                                   devices=[CPU] * 4)
        assert torch.equal(got, want)


def test_sharded_kwargs_shim_and_string_devices():
    """Without a plan the capacity/channel_block/sat_bits kwargs plan it,
    as in ``snn_apply``; devices may be given as strings."""
    jcfg, tcfg, np_params, spikes = _case(3, seed=2)
    params = params_from_numpy(np_params, "cpu")
    tspikes = torch.from_numpy(spikes)
    want = tc.snn_apply_batched(params, tspikes, tcfg,
                                tplan(tcfg, capacity=64, channel_block=4),
                                collect_stats=False)
    got = tc.snn_apply_sharded(params, tspikes, tcfg, capacity=64,
                               channel_block=4, devices=["cpu", "cpu"])
    assert torch.equal(got, want)


def test_sharded_rejects_bad_device_lists(monkeypatch):
    jcfg, tcfg, np_params, spikes = _case(3, b=6)
    params = params_from_numpy(np_params, "cpu")
    tspikes = torch.from_numpy(spikes)
    plan = tplan(tcfg, capacity=48)
    with pytest.raises(ValueError, match="does not divide over 4 devices"):
        tc.snn_apply_sharded(params, tspikes, tcfg, plan, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="at least one device"):
        tc.snn_apply_sharded(params, tspikes, tcfg, plan, devices=[])
    # no devices given and no CUDA device: no CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.snn_apply_sharded(params, tspikes, tcfg, plan)


def test_batch_devices(monkeypatch):
    """The first n visible CUDA devices; more than exist raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        specs.batch_devices()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert specs.batch_devices() == [torch.device("cuda", 0),
                                     torch.device("cuda", 1)]
    assert specs.batch_devices(1) == [torch.device("cuda", 0)]
    for n in (3, 0):
        with pytest.raises(ValueError, match="requested"):
            specs.batch_devices(n)
