"""Parameter round trips between the packages, and the port's import
boundary: ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX
nor the JAX package."""
import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import csnn_paper as jpaper
from repro.configs import csnn_wide as jwide
from repro.core import csnn as jc
from repro_torch.convert import params_from_numpy, params_to_numpy

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("cfg", [jpaper.FULL, jwide.FULL], ids=["paper", "wide"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.int8])
def test_params_round_trip(cfg, dtype):
    rng = np.random.default_rng(2)
    shapes = jax.eval_shape(lambda: jc.init_params(jax.random.PRNGKey(2), cfg))
    np_params = jax.tree.map(
        lambda s: (rng.normal(size=s.shape) * 50).astype(dtype), shapes)
    tp = params_from_numpy(np_params, "cpu")
    assert set(tp) == set(np_params)
    for k, v in tp.items():
        for n, t in v.items():
            assert isinstance(t, torch.Tensor) and t.dtype == getattr(torch, np.dtype(dtype).name)
    back = params_to_numpy(tp)
    leaves = jax.tree_util.tree_leaves_with_path(np_params)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for path, leaf in leaves:
        got = back[path[0].key][path[1].key]
        assert got.dtype == leaf.dtype
        np.testing.assert_array_equal(got, leaf)


def test_bool_round_trip_and_copy():
    src = {"m": {"x": np.array([True, False])}}
    tp = params_from_numpy(src, "cpu")
    tp["m"]["x"][0] = False  # the tensors own their memory
    assert src["m"]["x"][0]
    np.testing.assert_array_equal(params_to_numpy(tp)["m"]["x"], [False, False])


@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-v2-236b"])
@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_lm_params_round_trip(arch, dtype):
    """A SMOKE LM tree (``groups`` is a list of tuples of dicts) crosses
    whole: containers, keys, shapes, dtypes and values kept both ways."""
    from repro.configs import ARCHS
    from repro.models.registry import build_model
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(
        lambda: build_model(ARCHS[arch].SMOKE).init_params(jax.random.PRNGKey(0)))
    np_params = jax.tree.map(
        lambda s: (rng.normal(size=s.shape) * 50).astype(dtype), shapes)
    tp = params_from_numpy(np_params, "cpu")
    assert isinstance(tp["groups"], list)
    assert all(isinstance(g, tuple) for g in tp["groups"])
    is_t = lambda x: isinstance(x, torch.Tensor)  # noqa: E731
    assert jax.tree.structure(tp, is_leaf=is_t) == jax.tree.structure(np_params)
    for t, w in zip(jax.tree.leaves(tp, is_leaf=is_t), jax.tree.leaves(np_params)):
        assert t.dtype == getattr(torch, np.dtype(dtype).name)
        np.testing.assert_array_equal(t.numpy(), w)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    port = ROOT / "src" / "repro_torch"
    for mod in ("models/common.py", "models/attention.py", "models/ffn.py",
                "models/linear_attn.py", "models/rwkv.py", "models/ssm.py",
                "models/transformer.py", "models/encdec.py",
                "models/registry.py", "serve/engine.py", "configs/base.py",
                "configs/gemma3_1b.py", "configs/deepseek_v2.py",
                "train/loop.py", "train/optimizer.py", "checkpoint/ckpt.py",
                "runtime/health.py", "sharding/compression.py",
                "data/synthetic.py", "launch/train.py", "launch/lm_train.py",
                "launch/lm_serve.py"):
        assert port / mod in files, mod
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
