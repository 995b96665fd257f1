"""LM serving of the port (``repro_torch.serve.engine``,
``repro_torch.launch.serve``) against the JAX package's, on the CPU, and
the LM functions of ``repro_torch.core.sparse_ffn``.

* ``Engine.generate`` greedy tokens equal JAX's ``Engine`` on gemma3
  (dense, sliding window), deepseek-v2 (MoE, MLA) and whisper
  (encoder-decoder), SMOKE, the same numpy parameters and prompts.  Where
  a token differs the test fails unless JAX's top-2 logit gap at that step
  is below the float32 tolerance (rtol 1e-4 of the logits' scale): a tie
  within float32 noise may break either way.
* EOS masking: the tokens after a request's EOS are 0, as JAX's.
* Temperature sampling (Gumbel-max from a ``torch.Generator``; JAX draws
  from ``jax.random``, which torch cannot reproduce) is held to its own
  rules: the same generator seed gives the same tokens, another seed
  other tokens, and a vanishing temperature the greedy ones.
* The CLI: ``--arch gemma3-1b --smoke --device cpu`` prints the same
  ``req N: [...]`` lines as ``python -m repro.launch.serve`` given the
  same parameters and prompts (passed through numpy); ``rwkv6-1.6b`` runs
  as a subprocess.
* ``sparse_ffn``: float32 ``rtol=1e-4``, ``atol=1e-5`` x the output's
  scale; ``active_counts`` and the top-k's tie order exact.
"""
import functools
import io
import os
import subprocess
import sys
from argparse import Namespace
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core import sparse_ffn as jsf
from repro.models.registry import build_model as jbuild
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.core import sparse_ffn as tsf
from repro_torch.launch import serve as tserve
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serve.engine import Engine, ServeConfig
from torch_lm_ref import F32, assert_close, both, np_params

ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _setup(arch, b=2, s=20, seed=0):
    cfg = JARCHS[arch].SMOKE
    jm, tm = jbuild(cfg), tbuild(TARCHS[arch].SMOKE)
    jp, tp = both(np_params(jm.specs, seed))
    rng = np.random.default_rng(seed + 1)
    prompts = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = (0.02 * rng.normal(size=(b, cfg.enc_frames, cfg.d_model))
                           ).astype(np.float32)
    if cfg.family == "vlm":
        extra["vision_embeds"] = (0.02 * rng.normal(
            size=(b, cfg.n_vision_tokens, cfg.d_model))).astype(np.float32)
    return cfg, jm, tm, jp, tp, prompts, extra


def _jax_step_logits(jm, jp, cfg, seq, s, extra, max_seq, step):
    """JAX's logits that chose token ``s + step`` of ``seq`` (teacher
    forced along JAX's own tokens)."""
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(seq[:, :s]),
                                    **{k: jnp.asarray(v) for k, v in extra.items()}},
                               max_seq=max_seq)
    off = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    for i in range(step):
        logits, cache = jm.decode(jp, cache, {"tokens": jnp.asarray(seq[:, s + i:s + i + 1]),
                                              "pos": jnp.asarray(s + i + off, jnp.int32)})
    return np.asarray(logits, np.float64)


@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-v2-236b", "whisper-medium"])
def test_greedy_tokens_equal_jax(arch):
    cfg, jm, tm, jp, tp, prompts, extra = _setup(arch)
    n_new, max_seq = 8, 32
    want = np.asarray(JEngine(jm, jp, max_seq, JServeConfig(max_new_tokens=n_new)).generate(
        jnp.asarray(prompts), jax.random.PRNGKey(3),
        extra={k: jnp.asarray(v) for k, v in extra.items()}))
    got = Engine(tm, tp, max_seq, ServeConfig(max_new_tokens=n_new)).generate(
        torch.from_numpy(prompts), extra={k: torch.from_numpy(v) for k, v in extra.items()})
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got[:, :20], prompts)
    diff = np.nonzero((got != want).any(axis=0))[0]
    if diff.size:   # a near-tie in JAX's logits may break the other way
        step = int(diff[0]) - 20
        logits = _jax_step_logits(jm, jp, cfg, want, 20, extra, max_seq, step)
        top2 = np.sort(logits, axis=-1)[:, -2:]
        gap = (top2[:, 1] - top2[:, 0]).min()
        assert gap < F32["rtol"] * np.abs(logits).max(), (step, gap, got, want)


def test_eos_masking_matches_jax():
    """gemma3 at the greedy test's shapes (JAX reuses its compilations)."""
    cfg, jm, tm, jp, tp, prompts, extra = _setup("gemma3-1b")
    n_new, max_seq = 8, 32
    free = Engine(tm, tp, max_seq, ServeConfig(max_new_tokens=n_new)).generate(
        torch.from_numpy(prompts)).numpy()
    eos = int(free[0, 20 + 2])          # request 0 emits it at step 2
    got = Engine(tm, tp, max_seq, ServeConfig(max_new_tokens=n_new, eos_id=eos)).generate(
        torch.from_numpy(prompts)).numpy()
    want = np.asarray(JEngine(jm, jp, max_seq, JServeConfig(
        max_new_tokens=n_new, eos_id=eos)).generate(jnp.asarray(prompts),
                                                     jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(got, want)
    for row in got[:, 20:]:
        hits = np.nonzero(row == eos)[0]
        if hits.size:
            assert (row[hits[0] + 1:] == 0).all()
    assert (got[0, 23:] == 0).all()


def test_temperature_sampling_rules():
    _, _, tm, _, tp, prompts, _ = _setup("gemma3-1b")

    def run(temp, seed):
        eng = Engine(tm, tp, 32, ServeConfig(max_new_tokens=10, temperature=temp))
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return eng.generate(torch.from_numpy(prompts), g).numpy()
    a, b, c = run(1.0, 7), run(1.0, 7), run(1.0, 8)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    assert ((a[:, 20:] >= 0) & (a[:, 20:] < 512)).all()
    np.testing.assert_array_equal(run(1e-6, 7), run(0.0, None))
    with pytest.raises(ValueError, match="torch.Generator"):
        run(1.0, None)


def test_vlm_generate_offsets_positions_by_the_vision_prefix():
    """qwen2-vl: ``Engine.generate`` decodes at ``n_vision_tokens + s + i``
    (the cache holds the vision prefix); the port's engine equals a manual
    prefill + argmax decode loop at those positions."""
    cfg, _, tm, _, tp, prompts, extra = _setup("qwen2-vl-7b")
    n_new, s = 6, prompts.shape[1]
    max_seq = cfg.n_vision_tokens + s + n_new
    tx = {k: torch.from_numpy(v) for k, v in extra.items()}
    got = Engine(tm, tp, max_seq, ServeConfig(max_new_tokens=n_new)).generate(
        torch.from_numpy(prompts), extra=tx)
    logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(prompts), **tx}, max_seq)
    toks = [logits.argmax(-1)]
    for i in range(n_new - 1):
        logits, cache = tm.decode(tp, cache, {
            "tokens": toks[-1][:, None].to(torch.int32),
            "pos": cfg.n_vision_tokens + s + i})
        toks.append(logits.argmax(-1))
    np.testing.assert_array_equal(got[:, s:].numpy(), torch.stack(toks, 1).numpy())


def _cli_args(**kw):
    args = dict(arch="gemma3-1b", smoke=True, device="cpu", requests=2,
                prompt_len=16, new_tokens=4, temperature=0.0)
    args.update(kw)
    return Namespace(**args)


def test_cli_gemma_matches_jax_cli(monkeypatch):
    """``repro.launch.serve.main`` and the port's, given JAX's own
    parameters (``init_params(PRNGKey(0))``) and prompts through numpy:
    the same ``req N`` lines."""
    from repro.launch import serve as jserve
    from repro.models import registry as jregistry
    seen = {}
    init = jregistry.Model.init_params

    def record(self, rng, dtype=jnp.float32):
        seen["params"] = init(self, rng, dtype)
        return seen["params"]

    monkeypatch.setattr(jregistry.Model, "init_params", record)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert jserve.main(["--arch", "gemma3-1b", "--smoke", "--requests", "2",
                            "--new-tokens", "4"]) == 0
    want = [ln for ln in buf.getvalue().splitlines() if ln.startswith("req ")]
    cfg = JARCHS["gemma3-1b"].SMOKE
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                            cfg.vocab, jnp.int32))
    tp = params_from_numpy(jax.tree.map(np.asarray, seen["params"]), "cpu")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tserve.serve_lm(_cli_args(), params=tp,
                               prompts=torch.from_numpy(prompts), extra={}) == 0
    got = [ln for ln in buf.getvalue().splitlines() if ln.startswith("req ")]
    assert len(want) == 2 and got == want


def test_cli_rwkv_subprocess():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "rwkv6-1.6b",
         "--smoke", "--device", "cpu", "--requests", "2", "--new-tokens", "4"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("req ")]
    assert [ln.split(":")[0] for ln in lines] == ["req 0", "req 1"]
    for ln in lines:
        toks = eval(ln.split(":", 1)[1])    # noqa: S307 — our own output
        assert len(toks) == 4 and all(0 <= t < 512 for t in toks)
    assert "device=cpu" in out.stdout


def test_cli_rejects_unknown_arch(capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "no-such-arch"])
    assert "invalid choice" in capsys.readouterr().err


# ------------------------------------------------------------- sparse FFN
def test_sparse_ffn_specs():
    t, j = tsf.sparse_ffn_specs(64, 256), jsf.sparse_ffn_specs(64, 256)
    assert {k: (v.shape, v.axes, v.init) for k, v in t.items()} == \
        {k: (v.shape, v.axes, v.init) for k, v in j.items()}
    assert tsf.event_ffn_flops(64, 256, 32) == jsf.event_ffn_flops(64, 256, 32)


@pytest.mark.parametrize("values", ["normal", "integer"])
@pytest.mark.parametrize("capacity", [256, 48, 5])
def test_event_ffn_and_counts(capacity, values):
    """Integer-valued x and W_up make every activation an exact integer:
    ties everywhere, in any summation order, so a truncating queue's rows
    depend on the tie order (the lower index first)."""
    npp = np_params(jsf.sparse_ffn_specs(64, 256), 11)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    if values == "integer":
        npp["w_up"] = rng.integers(-2, 3, npp["w_up"].shape).astype(np.float32)
        x = rng.integers(-2, 3, x.shape).astype(np.float32)
    jp, tp = both(npp)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert_close(tsf.dense_relu_ffn(tp, tx), jsf.dense_relu_ffn(jp, jx), **F32)
    assert_close(tsf.event_ffn(tp, tx, capacity=capacity),
                 jsf.event_ffn(jp, jx, capacity=capacity), **F32)
    np.testing.assert_array_equal(tsf.active_counts(tp, tx).numpy(),
                                  np.asarray(jsf.active_counts(jp, jx)))
