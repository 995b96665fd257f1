"""The port's ANN -> SNN conversion path (``core.conversion``: training,
threshold balancing, quantization, the two networks' accuracies, and
``launch/train_csnn.py``) against the JAX package, with the same numpy
inputs and parameters.

Tolerances, with their reasons:

* ``layer_activations``: rtol 1e-5 (float32 convolutions in another
  order), exact on dyadic weights and images, where the
  ``normalize_params`` lambdas are then equal and the parameters within
  rtol 1e-5;
* gradients of one training step: within 1e-5 of each gradient's largest
  entry (float32 sums in another order); a ``Tensor.clamp`` gradient is
  2 % off on a zero-bias layer over black background;
* ``fit_ann``, 20 steps: every printed loss within 1e-4, final
  parameters rtol 1e-4;
* ``snn_accuracy``: the same prediction for every sample, at float32,
  int16 and int8 (``quantize_params`` exact, held in
  tests/test_torch_quantization.py).
"""
import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import csnn_paper as jpaper
from repro.core import conversion as jconv
from repro.core import csnn as jc
from repro.data.synthetic import synth_digits
from repro_torch.configs import csnn_paper as tpaper
from repro_torch.convert import params_from_numpy
from repro_torch.core import conversion as tconv
from repro_torch.core import csnn as tc
from repro_torch.launch import train_csnn


def _eq(a, b):
    a, b = np.asarray(a), b.detach().cpu().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jc.init_params(jax.random.PRNGKey(seed),
                                                   cfg))


def _cfgs(k):
    kw = dict(input_hw=(12, 12), t_steps=4)
    return (jc.CSNNConfig(layers=(jc.ConvSpec(6, kernel=k),
                                  jc.ConvSpec(6, kernel=k, pool=3),
                                  jc.FCSpec(10)), **kw),
            tc.CSNNConfig(layers=(tc.ConvSpec(6, kernel=k),
                                  tc.ConvSpec(6, kernel=k, pool=3),
                                  tc.FCSpec(10)), **kw))


# -------------------------------------------------------------- conversion
def _dyadic(np_params):
    """Weights on a 1/8 grid: with inputs on a grid too, every float32
    convolution sum is exact."""
    return jax.tree.map(lambda x: (np.round(x * 8) / 8).astype(np.float32),
                        np_params)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_activations_and_normalize_match_jax(k):
    jcfg, tcfg = _cfgs(k)
    raw, _ = synth_digits(16, seed=k, hw=jcfg.input_hw)
    for dyadic in (True, False):
        np_params, images = _jax_params(jcfg, seed=k), raw
        if dyadic:  # and images on a 1/16 grid
            np_params = _dyadic(np_params)
            images = (np.round(raw * 16) / 16).astype(np.float32)
        jp = jax.tree.map(jnp.asarray, np_params)
        tp = params_from_numpy(np_params, "cpu")
        jacts = jconv.layer_activations(jp, jnp.asarray(images), jcfg)
        tacts = tconv.layer_activations(tp, torch.from_numpy(images), tcfg)
        for a, b in zip(jacts, tacts):
            if dyadic:
                _eq(a, b)
            else:
                np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                           rtol=1e-5, atol=1e-6)
        for pct in (99.9, 50.0):
            want = jconv.normalize_params(jp, jnp.asarray(images), jcfg, pct)
            got = tconv.normalize_params(tp, torch.from_numpy(images), tcfg,
                                         pct)
            lambdas = tconv.layer_lambdas(tp, torch.from_numpy(images), tcfg,
                                          pct)
            jl = [max(float(jnp.percentile(a, pct)), 1e-6) for a in jacts]
            if dyadic:
                assert lambdas == jl
            else:
                np.testing.assert_allclose(lambdas, jl, rtol=1e-5)
            for name in want:
                for n in ("w", "b"):
                    np.testing.assert_allclose(np.asarray(want[name][n]),
                                               got[name][n].numpy(),
                                               rtol=1e-5, atol=1e-7)
            assert got["fc2"]["w"] is tp["fc2"]["w"]  # the head is kept


def _jax_loss(cfg):
    def loss(p, x, y):
        logits = jc.ann_apply(p, x, cfg)
        gold = jnp.take_along_axis(logits, y[:, None], axis=-1)[:, 0]
        return jnp.mean(jax.nn.logsumexp(logits, axis=-1) - gold)
    return loss


def test_training_gradients_match_jax_on_black_background():
    """One step's gradients on synth_digits (a quarter of the pixels are
    exactly 0) from zero biases: the clamped ReLU's input is exactly 0 on
    black patches, where JAX's clip gradient splits the tie."""
    jcfg, tcfg = jpaper.SMOKE, tpaper.SMOKE
    images, labels = synth_digits(64, seed=0, hw=jcfg.input_hw)
    assert (images == 0).mean() > 0.2
    np_params = _jax_params(jcfg)
    want = jax.grad(_jax_loss(jcfg))(jax.tree.map(jnp.asarray, np_params),
                                     jnp.asarray(images), jnp.asarray(labels))
    _, got = tconv._loss_and_grads(
        {k: {n: torch.from_numpy(v.copy()) for n, v in p.items()}
         for k, p in np_params.items()}, torch.from_numpy(images),
        torch.from_numpy(labels).long(), tcfg)
    for k in got:
        for n in got[k]:
            w = np.asarray(want[k][n])
            np.testing.assert_allclose(got[k][n].numpy(), w,
                                       rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())


def _fit(module, params, cfg, images, labels):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fitted = module.fit_ann(params, cfg, images, labels, steps=20,
                                log_every=1)
    return fitted, [float(v) for v in re.findall(r"loss (\S+)",
                                                 out.getvalue())]


def _jax_predictions(params, cfg, images, **kw):
    """The body of JAX's ``snn_accuracy``: jit(vmap(snn_apply))."""
    run = jax.jit(jax.vmap(lambda s: jc.snn_apply(
        params, s, cfg, collect_stats=False, **kw)))
    out = []
    for i in range(0, images.shape[0], 32):
        spikes = jc.encode_input(jnp.asarray(images[i:i + 32]), cfg)
        out.append(np.asarray(jnp.argmax(run(spikes), -1)))
    return np.concatenate(out)


def test_conversion_path_matches_jax():
    """The paper's Sec. VII workflow on SMOKE in both packages from the
    same parameters: ``fit_ann`` for 20 steps, ``ann_accuracy``,
    ``normalize_params``, then ``snn_accuracy`` at float32, int16 and
    int8 (``quantize_params``, ``quantized_threshold``), with the same
    prediction for every sample; the sharded evaluation agrees."""
    jcfg, tcfg = jpaper.SMOKE, tpaper.SMOKE
    xtr, ytr = synth_digits(300, seed=0, hw=jcfg.input_hw)
    xte, yte = synth_digits(64, seed=1, hw=jcfg.input_hw)
    np_params = _jax_params(jcfg)
    jp, jloss = _fit(jconv, jax.tree.map(jnp.asarray, np_params), jcfg, xtr,
                     ytr)
    tp, tloss = _fit(tconv, params_from_numpy(np_params, "cpu"), tcfg, xtr,
                     ytr)
    assert len(jloss) == len(tloss) == 20
    np.testing.assert_allclose(tloss, jloss, rtol=0, atol=1e-4 + 1e-9)
    for k in jp:
        for n in ("w", "b"):
            np.testing.assert_allclose(tp[k][n].numpy(), np.asarray(jp[k][n]),
                                       rtol=1e-4, atol=1e-6)
    # from here on both packages convert the same (the JAX) parameters
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert (tconv.ann_accuracy(tp, tcfg, xte, yte)
            == jconv.ann_accuracy(jp, jcfg, xte, yte))
    calib = xtr[:128]
    jn = jconv.normalize_params(jp, jnp.asarray(calib), jcfg)
    tn = params_from_numpy(jax.tree.map(np.asarray, jn), "cpu")
    for bits in (None, 16, 8):
        jparams, tparams, jc_cfg, tc_cfg = jn, tn, jcfg, tcfg
        if bits:
            conv = [k for k in jn if k.startswith("conv")]
            jq_, jspec = jconv.quantize_params({k: jn[k] for k in conv}, bits)
            tq_, tspec = tconv.quantize_params({k: tn[k] for k in conv}, bits)
            jparams = {**jn, **jq_}
            tparams = {**tn, **tq_}
            jc_cfg = dataclasses.replace(
                jcfg, v_t=jconv.quantized_threshold(jcfg.v_t, jspec))
            tc_cfg = dataclasses.replace(
                tcfg, v_t=tconv.quantized_threshold(tcfg.v_t, tspec))
            assert jc_cfg.v_t == tc_cfg.v_t
        kw = dict(capacity=100, sat_bits=bits)
        want = _jax_predictions(jparams, jc_cfg, xte, channel_block=1, **kw)
        got = tconv.snn_predictions(tparams, tc_cfg, xte, channel_block=4,
                                    **kw)
        np.testing.assert_array_equal(want, got.numpy())
        acc = tconv.snn_accuracy(tparams, tc_cfg, xte, yte, channel_block=4,
                                 **kw)
        assert acc == jconv.snn_accuracy(jparams, jc_cfg, xte, yte, **kw)
        if bits is None:
            sharded = tconv.snn_predictions(tparams, tc_cfg, xte,
                                            channel_block=4,
                                            devices=["cpu"] * 4, **kw)
            assert torch.equal(sharded, got)


def test_train_csnn_cli_on_cpu(capsys):
    assert train_csnn.main(["--device", "cpu", "--smoke", "--steps", "20",
                            "--n-train", "200", "--n-eval", "32"]) == 0
    out = capsys.readouterr().out
    for line in ("device: cpu", "ANN accuracy:", "m-TTFS SNN accuracy",
                 "int16 saturating datapath", "int8 saturating datapath"):
        assert line in out
