"""Shared helpers of the LM parity tests (``test_torch_lm_*.py``): the
same parameters and inputs on both sides, made with numpy, and the
conversions between the packages.

Parameters are drawn by numpy from the JAX model's own spec tree, leaf
by leaf as ``repro.models.common.init_tree`` draws them ("scaled": a
fan-in scaled normal, "normal": 0.02 x normal), except that the "zeros"
and "ones" leaves (norm gains, biases, RWKV's mix and bonus, Mamba's
decay and skip) get a 0.1 x normal perturbation so that every parameter
reaches the compared outputs.  ``jax.random`` would cost a compile per
leaf shape (10-36 s per model on one core).
"""
from __future__ import annotations

import math
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.models.common import is_spec
from repro_torch.convert import params_from_numpy


def np_params(specs, seed: int = 0):
    """A numpy parameter tree of the spec tree's structure (see above)."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        noise = rng.normal(size=s.shape)
        if s.init == "zeros":
            return (0.1 * noise).astype(np.float32)
        if s.init == "ones":
            return (1.0 + 0.1 * noise).astype(np.float32)
        if s.init == "scaled":
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            return (s.scale / math.sqrt(max(fan_in, 1)) * noise).astype(np.float32)
        return (s.scale * 0.02 * noise).astype(np.float32)

    return jax.tree.map(leaf, specs, is_leaf=is_spec)


def both(np_tree):
    """numpy tree -> (JAX tree, CPU tensor tree)."""
    return jax.tree.map(jnp.asarray, np_tree), params_from_numpy(np_tree, "cpu")


def jax_to_torch(tree):
    """A JAX tree (bfloat16 leaves included) -> the same tree of CPU
    tensors, exactly, containers kept."""
    def leaf(x):
        x = np.asarray(x)
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return jax.tree.map(leaf, tree)


def to_np(x) -> np.ndarray:
    """A tensor or JAX array -> float64 (or integer) numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.double() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float64) if x.dtype.kind == "f" or x.dtype == ml_dtypes.bfloat16 else x


def assert_close(got, want, rtol: float, atol: float, what: str = "") -> None:
    """Within ``rtol`` and ``atol`` x the largest magnitude of ``want`` (at
    least 1): a value near 0 carries the float32 noise of its neighbours'
    scale (a K cache spans +-20, an attention output +-9).  Over the LM
    tests the float32 comparisons needed at most 2.7e-5 of that scale
    (whisper SMOKE's prefill logits, scale 0.61: JAX is 6.9e-6 and the
    port 1.0e-5 from a float64 run of the same model)."""
    want = to_np(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(to_np(got), want, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def _dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def assert_tree_close(got, want, rtol: float, atol: float) -> None:
    """The same containers, shapes and dtypes; leaf by leaf, in JAX's
    flatten order, floats as :func:`assert_close`, integer leaves (the
    ring cache's slot positions) equal."""
    assert (jax.tree.structure(got, is_leaf=torch.is_tensor)
            == jax.tree.structure(want))
    g_leaves = jax.tree.leaves(got, is_leaf=torch.is_tensor)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            g_leaves):
        name = jax.tree_util.keystr(path)
        assert tuple(g.shape) == tuple(w.shape), (name, g.shape, w.shape)
        assert _dtype_name(g) == _dtype_name(w), (name, g.dtype, w.dtype)
        if g.is_floating_point():
            assert_close(g, w, rtol, atol, name)
        else:
            np.testing.assert_array_equal(to_np(g), to_np(w), err_msg=name)


# ---------------------------------------------------------------------------
# One SMOKE model on both sides, and the checks the model test files share
# ---------------------------------------------------------------------------

B, S = 2, 24            # batch, prompt; S > gemma3 SMOKE's window of 16
N_DECODE = 4
# atol is of the compared tensor's largest magnitude (at least 1), see
# assert_close
F32 = dict(rtol=1e-4, atol=1e-4)    # float32 sums in another order
BF16 = dict(rtol=2e-2, atol=2e-3)   # JAX's own (tests/test_models_smoke.py)
# Whole-model float32 outputs of the MQA/GQA models with one or two KV
# heads: the spec's fan-in scaling of wk/wv uses the KV-head axis (fan-in
# 1 or 2), so keys are ~10x larger than queries' scale and the softmax is
# sharp; float32 reordering is amplified through the layers.  JAX's own
# float32 prefill logits of granite SMOKE differ from a float64 run of the
# same model by 1.65e-4 (the port's: 1.10e-4), above F32.
SHARP = {"granite-34b", "llama4-maverick-400b-a17b", "zamba2-1.2b",
         "phi3-medium-14b", "qwen2-vl-7b"}
F32_SHARP = dict(rtol=1e-3, atol=1e-4)

JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def f32_tol(arch: str) -> dict:
    return F32_SHARP if arch in SHARP else F32


class ModelCase:
    """One architecture's SMOKE model on both sides, with the same numpy
    parameters and inputs, and the JAX side's outputs computed once."""

    def __init__(self, arch: str):
        from repro.configs import ARCHS as JARCHS
        from repro.models.registry import build_model as jbuild
        from repro_torch.configs import ARCHS as TARCHS
        from repro_torch.models.registry import build_model as tbuild

        self.arch = arch
        self.cfg = JARCHS[arch].SMOKE
        self.jm = jbuild(self.cfg)
        self.tm = tbuild(TARCHS[arch].SMOKE)
        self.jp, self.tp = both(np_params(self.jm.specs, seed=0))
        rng = np.random.default_rng(1)
        cfg = self.cfg
        self.tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        labels = self.tokens.copy()
        labels[:, -3:] = -1                       # masked positions
        self.extra = {}
        self.max_seq = S + N_DECODE
        if cfg.family == "vlm":
            self.extra["vision_embeds"] = (0.02 * rng.normal(
                size=(B, cfg.n_vision_tokens, cfg.d_model))).astype(np.float32)
            self.max_seq += cfg.n_vision_tokens
        if cfg.family == "encdec":
            self.extra["frames"] = (0.02 * rng.normal(
                size=(B, cfg.enc_frames, cfg.d_model))).astype(np.float32)
        self.pos0 = S + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
        self.step_tokens = rng.integers(0, cfg.vocab, (N_DECODE, B, 1)).astype(np.int32)
        self.train = {"tokens": self.tokens, "labels": labels, **self.extra}
        self._jax = {}

    def jbatch(self, d: dict) -> dict:
        return {k: jnp.asarray(v) for k, v in d.items()}

    def tbatch(self, d: dict) -> dict:
        return {k: torch.from_numpy(v) for k, v in d.items()}

    def prompt(self):
        return {"tokens": self.tokens, **self.extra}

    def jax_loss(self):
        if "loss" not in self._jax:
            self._jax["loss"] = jax.jit(self.jm.loss)(self.jp, self.jbatch(self.train))
        return self._jax["loss"]

    def jax_run(self, dtype: str):
        """JAX's prefill, then N_DECODE steps, each from the previous
        step's cache: (prefill logits, prefill cache, [(logits, cache)])."""
        if dtype not in self._jax:
            cd = JAX_DTYPE[dtype]
            ms = self.max_seq
            logits, cache = jax.jit(
                lambda p, b: self.jm.prefill(p, b, max_seq=ms, cache_dtype=cd))(
                self.jp, self.jbatch(self.prompt()))
            decode = jax.jit(self.jm.decode)
            steps, c = [], cache
            for i in range(N_DECODE):
                out = decode(self.jp, c, {"tokens": jnp.asarray(self.step_tokens[i]),
                                          "pos": jnp.asarray(self.pos0 + i, jnp.int32)})
                steps.append(out)
                c = out[1]
            self._jax[dtype] = (logits, cache, steps)
        return self._jax[dtype]


def check_loss(case: ModelCase) -> None:
    want, wm = case.jax_loss()
    got, gm = case.tm.loss(case.tp, case.tbatch(case.train))
    tol = f32_tol(case.arch)
    assert_close(got, want, **tol)
    assert_close(gm["ce"], wm["ce"], **tol)
    assert_close(gm["aux"], wm["aux"], **tol)


def check_prefill(case: ModelCase, dtype: str) -> None:
    want_logits, want_cache, _ = case.jax_run(dtype)
    logits, cache = case.tm.prefill(case.tp, case.tbatch(case.prompt()),
                                    max_seq=case.max_seq,
                                    cache_dtype=TORCH_DTYPE[dtype])
    assert_close(logits, want_logits, **f32_tol(case.arch))
    assert_tree_close(cache, want_cache, **(f32_tol(case.arch) if dtype == "float32"
                                            else BF16))


def check_decode(case: ModelCase, dtype: str) -> None:
    """Each step starts from JAX's cache of the step before (the port's
    own chain is held by the consistency test), so float32 noise that the
    sharp models amplify does not compound across steps; the step's
    logits and the cache it writes are compared."""
    _, cache, steps = case.jax_run(dtype)
    tol = F32 if dtype == "float32" else BF16
    for i, (want_logits, want_cache) in enumerate(steps):
        logits, new = case.tm.decode(
            case.tp, jax_to_torch(cache),
            {"tokens": torch.from_numpy(case.step_tokens[i]), "pos": case.pos0 + i})
        assert_close(logits, want_logits, **tol, what=f"step {i}")
        assert_tree_close(new, want_cache, **tol)
        cache = want_cache


def check_consistency(case: ModelCase) -> None:
    """JAX's ``TestDecodeConsistency`` on the port: prefill(S-1) then one
    decode step equals prefill(S) at the last position (float32 caches,
    JAX's tolerance)."""
    tm, tp = case.tm, case.tp
    full = case.tbatch(case.prompt())
    short = dict(full, tokens=full["tokens"][:, :-1])
    want, _ = tm.prefill(tp, full, max_seq=case.max_seq, cache_dtype=torch.float32)
    _, cache = tm.prefill(tp, short, max_seq=case.max_seq, cache_dtype=torch.float32)
    got, _ = tm.decode(tp, cache, {"tokens": full["tokens"][:, -1:],
                                   "pos": case.pos0 - 1})
    assert_close(got, want, **BF16)


# ---------------------------------------------------------------------------
# Gradients (test_torch_lm_grads*.py)
# ---------------------------------------------------------------------------

LOSS_RTOL = 1e-5        # the loss, ce and aux: float32 sums in another order
# each gradient leaf within GRAD_ATOL x its largest JAX entry (no rtol: a
# gradient entry near 0 carries its leaf's float32 noise).  Measured on the
# ten SMOKE models: at most 2.4e-4 (whisper's), the others under 6e-5.
GRAD_ATOL = 1e-3


def port_value_and_grad(model, params, batch):
    """The port's ((loss, metrics), grads) through ``train.loop``."""
    from repro_torch.train.loop import value_and_grad
    return value_and_grad(model, params, batch)


def jax_value_and_grad(model, params, batch):
    return jax.jit(jax.value_and_grad(model.loss, has_aux=True))(params, batch)


def grad_ratio(got, want) -> float:
    """max |got - want| / (GRAD_ATOL x max |want|): at most 1 passes."""
    want = to_np(want)
    scale = float(np.abs(want).max(initial=0.0))
    err = float(np.abs(to_np(got) - want).max(initial=0.0))
    if scale == 0.0:
        return 0.0 if err == 0.0 else float("inf")
    return err / (GRAD_ATOL * scale)


def assert_grads_close(got_tree, want_tree) -> float:
    """Every leaf, in JAX's flatten order and with its path in the message;
    returns the worst :func:`grad_ratio`."""
    assert (jax.tree.structure(got_tree, is_leaf=torch.is_tensor)
            == jax.tree.structure(want_tree))
    worst = 0.0
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want_tree)[0],
                            jax.tree.leaves(got_tree, is_leaf=torch.is_tensor)):
        assert tuple(g.shape) == tuple(w.shape), jax.tree_util.keystr(path)
        r = grad_ratio(g, w)
        assert r <= 1.0, (jax.tree_util.keystr(path), r)
        worst = max(worst, r)
    return worst


def check_grads(case: "ModelCase") -> float:
    """``jax.value_and_grad(Model.loss)`` against the port's autograd on
    the same parameters and batch: loss, ce and aux at ``LOSS_RTOL``, every
    gradient leaf at ``GRAD_ATOL`` of its largest entry."""
    (want, wm), wg = jax_value_and_grad(case.jm, case.jp, case.jbatch(case.train))
    (got, gm), gg = port_value_and_grad(case.tm, case.tp, case.tbatch(case.train))
    for name, g, w in (("loss", got, want), ("ce", gm["ce"], wm["ce"]),
                       ("aux", gm["aux"], wm["aux"])):
        np.testing.assert_allclose(to_np(g), to_np(w), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=name)
    return assert_grads_close(gg, wg)


def check_remat_equal(case: "ModelCase") -> None:
    """``cfg.remat`` on and off give ``torch.equal`` gradients (the
    recomputed forward is the forward): the loss, and every leaf."""
    import dataclasses

    from repro_torch.models.registry import build_model
    batch = case.tbatch(case.train)
    runs = {}
    for remat in (True, False):
        model = build_model(dataclasses.replace(case.tm.cfg, remat=remat))
        runs[remat] = port_value_and_grad(model, case.tp, batch)
    (l1, _), g1 = runs[True]
    (l0, _), g0 = runs[False]
    assert torch.equal(l1, l0)
    leaves1 = jax.tree.leaves(g1, is_leaf=torch.is_tensor)
    leaves0 = jax.tree.leaves(g0, is_leaf=torch.is_tensor)
    assert len(leaves1) == len(leaves0)
    for a, b in zip(leaves1, leaves0):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Multi-process runs: the port's ranks over gloo, JAX on forced devices
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent.parent

# each rank joins the group through a FileStore (no TCP port: pytest-xdist
# runs files side by side) and finds RANK, WORLD, OUT and init(store, world)
RANK_PRELUDE = """
import logging, os, sys, warnings
from pathlib import Path
logging.disable(logging.WARNING)
warnings.filterwarnings("ignore")
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK = int(os.environ["RANK"])
WORLD = int(os.environ["WORLD_SIZE"])
OUT = Path(os.environ["OUT_DIR"])

def init(store, world, rank=None):
    dist.init_process_group("gloo", store=dist.FileStore(str(store), world),
                            rank=RANK if rank is None else rank,
                            world_size=world)

init(OUT / "store", WORLD)
"""


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu", **extra)
    return env


def _wait_all(procs: list, logs: list, timeout: float) -> list[str]:
    """Wait for every process (killing all at the deadline or on return);
    their stdouts, or an AssertionError with the failures' stderr."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"processes still running after {timeout} s:\n"
                             + "\n".join(Path(e).read_text()[-2000:]
                                         for _, e in logs)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError("\n".join(
            f"process {i} exited {rc}:\n{Path(logs[i][1]).read_text()[-3000:]}"
            for i, rc in bad))
    return [Path(o).read_text() for o, _ in logs]


def start_ranks(code: str, world: int, out_dir: Path) -> tuple[list, list]:
    """Start ``code`` (after :data:`RANK_PRELUDE`) in ``world`` processes."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = RANK_PRELUDE + textwrap.dedent(code)
    procs, logs = [], []
    for r in range(world):
        o, e = out_dir / f"rank{r}.out", out_dir / f"rank{r}.err"
        with open(o, "w") as fo, open(e, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", src], stdout=fo, stderr=fe, cwd=REPO,
                env=_env(RANK=str(r), WORLD_SIZE=str(world),
                         OUT_DIR=str(out_dir))))
        logs.append((o, e))
    return procs, logs


def start_jax(code: str, devices: int, out_dir: Path) -> tuple[list, list]:
    """Start ``code`` in a JAX process with ``devices`` forced CPU devices;
    it finds its output directory in ``OUT``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = ("import os\nfrom pathlib import Path\nOUT = Path(os.environ['OUT_DIR'])\n"
           + textwrap.dedent(code))
    o, e = out_dir / "jax.out", out_dir / "jax.err"
    env = _env(OUT_DIR=str(out_dir))
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    with open(o, "w") as fo, open(e, "w") as fe:
        proc = subprocess.Popen([sys.executable, "-c", src], stdout=fo,
                                stderr=fe, cwd=REPO, env=env)
    return [proc], [(o, e)]


def finish(started: list[tuple[list, list]], timeout: float = 120.0) -> list[str]:
    """Wait for every group :func:`start_ranks`/:func:`start_jax` started."""
    procs = [p for ps, _ in started for p in ps]
    logs = [lg for _, ls in started for lg in ls]
    return _wait_all(procs, logs, timeout)
