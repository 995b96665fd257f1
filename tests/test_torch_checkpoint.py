"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) against the
JAX package's ``repro.checkpoint.ckpt`` on the CPU: JAX's own
``TestCheckpoint`` on the port, the same file names and manifest for the
same tree, and checkpoints crossing between the packages bit for bit in
both directions (float32 and bfloat16 leaves, a 0-d step, an LM
``TrainState`` of dicts, lists and tuples), restored into live, ``meta``
and other-dtype templates, with keep-k GC on both sides."""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import ARCHS as JARCHS
from repro.models.registry import build_model as jbuild
from repro.train import optimizer as jopt
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS
from repro_torch.models.registry import build_model
from repro_torch.train import optimizer as opt
from torch_lm_ref import jax_to_torch, np_params

# ------------------------------------------------- JAX's TestCheckpoint


def _tree():
    return {"layer": {"w": torch.arange(12.0).reshape(3, 4),
                      "b": torch.ones((5,), dtype=torch.bfloat16)},
            "step_arr": torch.tensor(7, dtype=torch.int32)}


def _leaves(tree):
    return opt.tree_leaves(tree)


def test_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(tree, tmp_path, step=3)
    restored, step = ckpt.restore(tree, tmp_path)
    assert step == 3
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_atomic_and_gc(tmp_path):
    tree = _tree()
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(tree, tmp_path, step=s, keep=2)
    assert ckpt.latest_step(tmp_path) == 5
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir())
    assert steps == [4, 5]  # GC kept last 2
    (tmp_path / "ckpt_000000009.tmp").mkdir()   # an unfinished save
    assert ckpt.latest_step(tmp_path) == 5


def test_restore_into_different_dtype(tmp_path):
    ckpt.save({"w": torch.ones(4)}, tmp_path, step=1)
    restored, _ = ckpt.restore({"w": torch.zeros(4, dtype=torch.bfloat16)},
                               tmp_path)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], torch.ones(4, dtype=torch.bfloat16))


def test_trainstate_roundtrip(tmp_path):
    params = {"w": torch.arange(6.0).reshape(2, 3)}
    state = opt.init_state(params, opt.AdamWConfig())
    ckpt.save(state, tmp_path, step=11)
    restored, step = ckpt.restore(state, tmp_path)
    assert step == 11 and restored.step == 0 and isinstance(restored.step, int)
    assert torch.equal(restored.params["w"], params["w"])


def test_meta_template_needs_a_device(tmp_path):
    ckpt.save({"w": torch.ones(4)}, tmp_path, step=1)
    meta = {"w": torch.empty(4, device="meta")}
    with pytest.raises(ValueError):
        ckpt.restore(meta, tmp_path)
    restored, _ = ckpt.restore(meta, tmp_path, device="cpu")
    assert restored["w"].device.type == "cpu"
    assert torch.equal(restored["w"], torch.ones(4))


# --------------------------------------------- across the two packages


def _lm_states(moments: str, step: int = 5):
    """A gemma3 SMOKE TrainState on both sides: the same numpy parameters,
    moments drawn in ``moments`` (float32 or bfloat16), the same step."""
    cfg = JARCHS["gemma3-1b"].SMOKE
    npp = np_params(jbuild(cfg).specs, seed=0)
    rng = np.random.default_rng(9)
    dt = np.float32 if moments == "float32" else ml_dtypes.bfloat16
    mu = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(dt), npp)
    nu = jax.tree.map(lambda a: rng.random(size=a.shape).astype(dt), npp)
    jstate = jopt.TrainState(step=jnp.asarray(step, jnp.int32),
                             params=jax.tree.map(jnp.asarray, npp),
                             mu=jax.tree.map(jnp.asarray, mu),
                             nu=jax.tree.map(jnp.asarray, nu))
    tstate = opt.TrainState(step=step, params=jax_to_torch(jstate.params),
                            mu=jax_to_torch(jstate.mu), nu=jax_to_torch(jstate.nu))
    return jstate, tstate


def _assert_states_equal(tstate, jstate):
    """Every leaf bit for bit (bfloat16 compared as its bits), in JAX's
    flatten order, the port's containers kept."""
    assert int(tstate.step) == int(jstate.step)
    for part in ("params", "mu", "nu"):
        t, j = getattr(tstate, part), getattr(jstate, part)
        assert (jax.tree.structure(t, is_leaf=torch.is_tensor)
                == jax.tree.structure(j))
        for a, b in zip(jax.tree.leaves(t, is_leaf=torch.is_tensor),
                        jax.tree.leaves(j)):
            b = np.asarray(b)
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
            if a.dtype == torch.bfloat16:
                np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                              b.view(np.int16))
            else:
                np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_same_files_and_manifest(tmp_path, moments):
    jstate, tstate = _lm_states(moments)
    jdir, tdir = jckpt.save(jstate, tmp_path / "jax", 5), ckpt.save(
        tstate, tmp_path / "port", 5)
    assert sorted(p.name for p in jdir.iterdir()) == sorted(
        p.name for p in tdir.iterdir())
    names = {p.name for p in tdir.iterdir()}
    assert "step__0-1.npy" in names
    wq = tstate.params["groups"][0][0]["attn"]["wq"].shape
    assert ("params.groups.0.0.attn.wq__"
            + "x".join(f"0-{d}" for d in wq) + ".npy") in names
    jm = json.loads((jdir / "manifest.json").read_text())
    tm = json.loads((tdir / "manifest.json").read_text())
    assert jm == tm
    assert (jm["leaves"]["mu/embed"].get("bf16_as_u16", False)
            == (moments == "bfloat16"))
    for f in jdir.iterdir():
        if f.suffix == ".npy":
            a, b = np.load(f), np.load(tdir / f.name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, moments):
    jstate, tstate = _lm_states(moments)
    jckpt.save(jstate, tmp_path, 5)
    zeros = opt.TrainState(step=0, params=opt.tree_map(torch.zeros_like, tstate.params),
                           mu=opt.tree_map(torch.zeros_like, tstate.mu),
                           nu=opt.tree_map(torch.zeros_like, tstate.nu))
    restored, step = ckpt.restore(zeros, tmp_path)
    assert step == 5
    _assert_states_equal(restored, jstate)
    model = build_model(ARCHS["gemma3-1b"].SMOKE)
    cfg = opt.AdamWConfig(moment_dtype=getattr(torch, moments))
    meta = opt.abstract_state(model.abstract_params(torch.float32), cfg)
    restored, _ = ckpt.restore(meta, tmp_path, device="cpu")
    _assert_states_equal(restored, jstate)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(tmp_path, moments):
    jstate, tstate = _lm_states(moments)
    ckpt.save(tstate, tmp_path, 5)
    template = jax.tree.map(jnp.zeros_like, jstate)
    restored, step = jckpt.restore(template, tmp_path)
    assert step == 5
    _assert_states_equal(tstate, restored)


def test_gc_across_packages(tmp_path):
    """Saves from both packages into one directory share the step
    numbering and the keep-k GC."""
    jstate, tstate = _lm_states("float32")
    jckpt.save(jstate, tmp_path, 1, keep=2)
    ckpt.save(tstate, tmp_path, 2, keep=2)
    jckpt.save(jstate, tmp_path, 3, keep=2)
    assert ckpt.latest_step(tmp_path) == jckpt.latest_step(tmp_path) == 3
    ckpt.save(tstate, tmp_path, 4, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_000000003", "ckpt_000000004"]


def test_restore_assembles_shards(tmp_path):
    """A leaf written as two shards (the files a sharded save leaves,
    bounds in their names) is assembled, in the port and in JAX."""
    w = torch.arange(24.0).reshape(4, 6)
    final = ckpt.save({"w": w, "b": torch.ones(3, dtype=torch.bfloat16)},
                      tmp_path, step=2)
    whole = final / "w__0-4x0-6.npy"
    data = np.load(whole)
    whole.unlink()
    np.save(final / "w__0-4x0-2.npy", data[:, :2])
    np.save(final / "w__0-4x2-6.npy", data[:, 2:])
    restored, _ = ckpt.restore({"w": torch.zeros(4, 6),
                                "b": torch.zeros(3, dtype=torch.bfloat16)}, tmp_path)
    assert torch.equal(restored["w"], w)
    assert torch.equal(restored["b"], torch.ones(3, dtype=torch.bfloat16))
    jrestored, _ = jckpt.restore({"w": jnp.zeros((4, 6)),
                                  "b": jnp.zeros(3, jnp.bfloat16)}, tmp_path)
    np.testing.assert_array_equal(np.asarray(jrestored["w"]), w.numpy())
