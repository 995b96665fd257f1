"""The port's quantizer, neurons, rate coding, pipeline model and optimizer
against the JAX package, with the same numpy inputs:
``core.quantization`` (``QuantSpec``, ``calibrate_scale``, ``quantize``,
``dequantize``, ``fake_quant``, ``percentile_f32``),
``conversion.quantize_params`` and ``quantized_threshold``,
``core.encoding`` (``rate_encode``, ``spike_sparsity``),
``core.neuron``, ``core.pipeline_sim`` and ``train.optimizer``.

Tolerances, with their reasons:

* quantization, ``quantized_threshold``, ``quantize_params``, the
  neurons, ``spike_sparsity``, ``pipeline_sim``, ``percentile_f32``:
  exact; the quantizer's inputs include values on .5 boundaries of the
  scale;
* ``rate_encode``: exact, given JAX's uniforms;
* ``lr_at``: bit-equal to JAX's jitted ``lr_at`` at every step whose
  cosine XLA rounds correctly; XLA calls the C library's ``cosf``, 1 ulp
  off on about 1 % of arguments, and there the port is within 1 ulp;
* ``adamw_update``: rtol 1e-6 over 10 steps (sums in another order).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conversion as jconv
from repro.core import csnn as jc
from repro.core import encoding as jenc
from repro.core import neuron as jneuron
from repro.core import pipeline_sim as jsim
from repro.core import quantization as jq
from repro.train import optimizer as jopt
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import conversion as tconv
from repro_torch.core import encoding as tenc
from repro_torch.core import neuron as tneuron
from repro_torch.core import pipeline_sim as tsim
from repro_torch.core import quantization as tq
from repro_torch.train import optimizer as topt


def _eq(a, b):
    a, b = np.asarray(a), b.detach().cpu().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- quantize
def test_percentile_matches_jnp():
    rng = np.random.default_rng(0)
    for trial in range(30):
        n = int(rng.integers(1, 5000 if trial % 6 else 200_000))
        x = (rng.normal(size=n) * rng.uniform(0.01, 100)).astype(np.float32)
        if trial % 5 == 0:
            x = np.clip(x, 0, 1)  # clamped activations: ties at 0 and 1
        for q in (99.9, 100.0, 0.0, 50.0, float(rng.uniform(0, 100))):
            want = np.asarray(jnp.percentile(jnp.asarray(x), q))
            got = tq.percentile_f32(torch.from_numpy(x), q)
            assert want.tobytes() == got.numpy().tobytes(), (n, q)
    nan = torch.tensor([1.0, float("nan"), 2.0])
    assert torch.isnan(tq.percentile_f32(nan, 50.0))


@pytest.mark.parametrize("bits", [8, 16])
def test_quantizer_matches_jax_on_rounding_boundaries(bits):
    rng = np.random.default_rng(bits)
    x = (rng.normal(size=4000) * 0.3).astype(np.float32)
    for pct in (100.0, 99.9, 50.0):
        assert (jq.calibrate_scale(jnp.asarray(x), bits, pct)
                == tq.calibrate_scale(torch.from_numpy(x), bits, pct))
    scale = jq.calibrate_scale(jnp.asarray(x), bits)
    jspec, tspec = jq.QuantSpec(bits, scale), tq.QuantSpec(bits, scale)
    assert (tspec.max_int, tspec.min_int) == (jspec.max_int, jspec.min_int)
    assert tspec.dtype == {8: torch.int8, 16: torch.int16}[bits]
    k = rng.integers(-3 * tspec.max_int, 3 * tspec.max_int, size=4000)
    s32 = np.float32(scale)
    # on .5 boundaries of the scale (and one ulp either side), on the grid
    # itself and past saturation
    half = ((k + 0.5) * s32).astype(np.float32)
    vals = np.concatenate([x * 40, half, np.nextafter(half, np.float32(0)),
                           np.nextafter(half, np.float32(np.inf)),
                           (k * s32).astype(np.float32)])
    want = jq.quantize(jnp.asarray(vals), jspec)
    got = tq.quantize(torch.from_numpy(vals), tspec)
    _eq(want, got)
    _eq(jq.dequantize(want, jspec), tq.dequantize(got, tspec))
    assert (jconv.quantized_threshold(1.0, jspec)
            == tconv.quantized_threshold(1.0, tspec))
    # fake_quant: the forward exactly, the straight-through gradient ones
    t = torch.from_numpy(vals).requires_grad_()
    fq = tq.fake_quant(t, tspec)
    _eq(jq.fake_quant(jnp.asarray(vals), jspec), fq)
    fq.sum().backward()
    assert torch.equal(t.grad, torch.ones_like(t))
    _eq(jax.grad(lambda v: jq.fake_quant(v, jspec).sum())(jnp.asarray(vals)),
        t.grad)


@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_params_matches_jax(bits):
    jcfg = jc.CSNNConfig(input_hw=(12, 12), layers=(
        jc.ConvSpec(6), jc.ConvSpec(6, pool=3), jc.FCSpec(10)))
    np_params = jax.tree.map(np.asarray, jc.init_params(
        jax.random.PRNGKey(bits), jcfg))
    conv = {k: v for k, v in np_params.items() if k.startswith("conv")}
    for v_t in (1.0, 0.02):  # the threshold's headroom sets the scale, or not
        jqp, jspec = jconv.quantize_params(jax.tree.map(jnp.asarray, conv),
                                           bits, v_t=v_t)
        tqp, tspec = tconv.quantize_params(params_from_numpy(conv, "cpu"),
                                           bits, v_t=v_t)
        assert tspec.scale == jspec.scale and tspec.bits == bits
        for name in conv:
            for n in ("w", "b"):
                _eq(jqp[name][n], tqp[name][n])
        assert (jconv.quantized_threshold(v_t, jspec)
                == tconv.quantized_threshold(v_t, tspec))


# ---------------------------------------------------- encoding and neurons
def test_rate_encode_and_sparsity_match_jax():
    rng = np.random.default_rng(3)
    frames = (rng.random((5, 7)) * 1.4 - 0.2).astype(np.float32)  # clipped
    key = jax.random.PRNGKey(11)
    want = jenc.rate_encode(jnp.asarray(frames), 6, key)
    u = np.array(jax.random.uniform(key, (6, 5, 7), jnp.float32))
    got = tenc.rate_encode_uniform(torch.from_numpy(frames),
                                   torch.from_numpy(u))
    _eq(want, got)
    _eq(jenc.spike_sparsity(want), tenc.spike_sparsity(got))
    drawn = tenc.rate_encode(torch.from_numpy(frames), 6,
                             torch.Generator().manual_seed(0))
    assert drawn.shape == (6, 5, 7) and drawn.dtype == torch.bool
    assert not drawn[:, frames <= 0].any() and drawn[:, frames >= 1].all()
    spikes = rng.random((4, 9, 9)) < 0.3
    _eq(jenc.spike_sparsity(jnp.asarray(spikes)),
        tenc.spike_sparsity(torch.from_numpy(spikes)))


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_neurons_match_jax(dtype):
    rng = np.random.default_rng(4)
    shape = (6, 5)

    def draw():
        if dtype == np.float32:
            return rng.normal(size=shape).astype(dtype)
        return rng.integers(-3, 4, size=shape).astype(dtype)

    v_t = 1.5  # truncates to 1 on the int datapath
    jv, tv = jnp.asarray(draw()), None
    tv = torch.from_numpy(np.asarray(jv).copy())
    jstate = jneuron.IFState.zeros(shape, jv.dtype)
    tstate = tneuron.IFState.zeros(shape, tv.dtype, device="cpu")
    mu_j, vm_j, f_j = jv, jnp.zeros_like(jv), jnp.zeros(shape, bool)
    mu_t, vm_t = tv.clone(), torch.zeros_like(tv)
    f_t = torch.zeros(shape, dtype=torch.bool)
    for _ in range(6):
        cur = draw()
        jc_, tc_ = jnp.asarray(cur), torch.from_numpy(cur)
        jv, js = jneuron.if_reset_step(jv, jc_, v_t)
        tv, ts = tneuron.if_reset_step(tv, tc_, v_t)
        _eq(jv, tv)
        _eq(js, ts)
        jstate, js = jneuron.mttfs_step(jstate, jc_, v_t)
        tstate, ts = tneuron.mttfs_step(tstate, tc_, v_t)
        _eq(jstate.v_m, tstate.v_m)
        _eq(jstate.fired, tstate.fired)
        _eq(js, ts)
        mu_j, vm_j, f_j, js = jneuron.ttfs_slope_step(mu_j, vm_j, f_j, jc_,
                                                      v_t)
        mu_t, vm_t, f_t, ts = tneuron.ttfs_slope_step(mu_t, vm_t, f_t, tc_,
                                                      v_t)
        for a, b in ((mu_j, mu_t), (vm_j, vm_t), (f_j, f_t), (js, ts)):
            _eq(a, b)


@pytest.mark.parametrize("parallelism", [1, 2, 4])
def test_pipeline_sim_matches_jax(parallelism):
    rng = np.random.default_rng(parallelism)
    layer = [[rng.integers(0, 14, size=(int(rng.integers(0, 40)), 2))
              for _ in range(3)] for _ in range(4)]
    for q in layer[0]:
        assert (jsim.simulate_conv_queue(q, parallelism)
                == tsim.simulate_conv_queue(q, parallelism))
    want = jsim.simulate_layer(layer, 8, (14, 14), parallelism)
    got = tsim.simulate_layer(layer, 8, (14, 14), parallelism)
    assert dataclasses.asdict(want) == dataclasses.asdict(got)
    assert want.pe_utilization == got.pe_utilization
    assert (jsim.throughput_fps(want, parallelism=parallelism)
            == tsim.throughput_fps(got, parallelism=parallelism))


# --------------------------------------------------------------- optimizer
@pytest.mark.parametrize("total,warmup", [(150, 10), (20, 10), (7, 10),
                                          (400, 10)])
def test_lr_at_matches_jitted_jax(total, warmup):
    jcfg = jopt.AdamWConfig(lr=2e-3, warmup_steps=warmup, total_steps=total)
    tcfg = topt.AdamWConfig(lr=2e-3, warmup_steps=warmup, total_steps=total)
    jlr = jax.jit(lambda s: jopt.lr_at(jcfg, s))
    jcos = jax.jit(jnp.cos)
    off = 0
    for step in range(total + 3):
        want = np.asarray(jlr(jnp.int32(step)))
        got = np.float32(topt.lr_at(tcfg, step))
        if want.tobytes() == got.tobytes():
            continue
        # only where XLA's cosine of this step's argument is not the
        # correctly rounded one
        off += 1
        span = np.float32(1) / np.float32(max(total - warmup, 1))
        prog = min(max((np.float32(step) - np.float32(warmup)) * span,
                       np.float32(0)), np.float32(1))
        arg = prog * np.float32(math.pi)
        assert (np.asarray(jcos(jnp.float32(arg)))
                != np.float32(math.cos(float(arg)))), step
        assert abs(int(want.view(np.int32)) - int(got.view(np.int32))) == 1
    assert off <= max(2, (total + 3) // 50)


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(5)
    shapes = {"conv0": {"w": (3, 3, 1, 4), "b": (4,)},
              "fc2": {"w": (12, 3), "b": (3,)}}
    params = {k: {n: rng.normal(size=s).astype(np.float32)
                  for n, s in v.items()} for k, v in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=10, weight_decay=0.05,
              clip_norm=1.0)
    jstate = jopt.init_state(jax.tree.map(jnp.asarray, params),
                             jopt.AdamWConfig(**kw))
    tstate = topt.init_state(params_from_numpy(params, "cpu"),
                             topt.AdamWConfig(**kw))
    for step in range(10):
        scale = 3.0 if step % 2 else 0.1  # clipped, then not
        grads = {k: {n: (rng.normal(size=s) * scale).astype(np.float32)
                     for n, s in v.items()} for k, v in shapes.items()}
        jstate = jopt.adamw_update(jstate, jax.tree.map(jnp.asarray, grads),
                                   jopt.AdamWConfig(**kw))
        tstate = topt.adamw_update(tstate, params_from_numpy(grads, "cpu"),
                                   topt.AdamWConfig(**kw))
        assert tstate.step == int(jstate.step)
        got = params_to_numpy(tstate.params)
        for k in shapes:
            for n in shapes[k]:
                np.testing.assert_allclose(got[k][n],
                                           np.asarray(jstate.params[k][n]),
                                           rtol=1e-6, atol=1e-7)
    norm = topt.global_norm(params_from_numpy(params, "cpu"))
    np.testing.assert_allclose(
        norm.numpy(), np.asarray(jopt.global_norm(params)), rtol=1e-6)
