"""The port's LM models (``repro_torch.models``) against the JAX
package's on the CPU.  All ten SMOKE architectures here: parameter specs
(paths, shapes, axes, initializers), ``n_params`` of the FULL configs
(spec arithmetic only), cache structures, and the port's own
prefill-versus-decode consistency.  ``loss`` values, ``prefill`` logits
and caches and 4 decode steps against JAX: the dense decoders here,
the other families in ``test_torch_lm_models_window.py`` (gemma3,
qwen2-vl, whisper), ``..._moe.py`` (llama4, deepseek-v2) and
``..._recurrent.py`` (rwkv6, zamba2), one file per ~50 s of one core.

Parameters and inputs are made with numpy (``torch_lm_ref``) and fed to
both.  Tolerances:

* float32 caches and logits: ``rtol=1e-4, atol=1e-5`` (float32 sums in
  another order).  Whole-model float32 outputs (loss, prefill logits,
  caches) of the models in ``torch_lm_ref.SHARP`` (one or two KV heads:
  sharp softmax) within ``rtol=1e-3, atol=1e-4``; JAX's own float32
  logits are 1.65e-4 from a float64 run of granite SMOKE.
* the default bfloat16 cache: JAX's own ``rtol=2e-2, atol=2e-3``
  (``tests/test_models_smoke.py``): a float32 value within float32 noise
  of a bfloat16 rounding boundary rounds to the neighbouring bfloat16.
* decode steps start from JAX's cache of the step before, so float32
  noise does not compound; the port's own cache chain is held by the
  consistency test (JAX's tolerance) and by
  ``test_torch_lm_blocks.py``'s ring-cache run past the window.

The JAX side of each architecture is computed once (jitted) and shared
by its tests (``torch_lm_ref.ModelCase``).
"""
import functools

import jax
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models.common import is_spec as j_is_spec
from repro.models.registry import build_model as jbuild
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import LM_ARCHS
from repro_torch.models.common import is_spec as t_is_spec
from repro_torch.models.registry import build_model as tbuild
from torch_lm_ref import (ModelCase, check_consistency, check_decode,
                          check_loss, check_prefill)

ARCH_IDS = list(LM_ARCHS)


@functools.lru_cache(maxsize=None)
def case(arch: str) -> ModelCase:
    return ModelCase(arch)


def _spec_leaves(specs, is_leaf):
    return [(jax.tree_util.keystr(p), (s.shape, s.axes, s.init, s.scale))
            for p, s in jax.tree_util.tree_flatten_with_path(specs, is_leaf=is_leaf)[0]]


def test_registry_ids():
    assert set(LM_ARCHS) == set(JARCHS)
    # csnn-vgg16 is the port's own network: the JAX package has no such id
    assert set(TARCHS) == set(JARCHS) | {"csnn-paper", "csnn-wide",
                                         "csnn-vgg16"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match(arch):
    j = jbuild(JARCHS[arch].SMOKE).specs
    t = tbuild(TARCHS[arch].SMOKE).specs
    assert _spec_leaves(t, t_is_spec) == _spec_leaves(j, j_is_spec)
    assert (jax.tree.structure(t, is_leaf=t_is_spec)
            == jax.tree.structure(j, is_leaf=j_is_spec))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_n_params_full(arch):
    tm = tbuild(TARCHS[arch].FULL)
    jm = jbuild(JARCHS[arch].FULL)
    assert tm.n_params() == jm.n_params()
    abstract = jax.tree.leaves(tm.abstract_params(), is_leaf=torch.is_tensor)
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16 for t in abstract)
    assert sum(t.numel() for t in abstract) == jm.n_params()
    assert (jax.tree.leaves(tm.logical_axes(), is_leaf=lambda x: isinstance(x, tuple))
            == jax.tree.leaves(jm.logical_axes(), is_leaf=lambda x: isinstance(x, tuple)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_structure(arch):
    for dt, jdt in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        t_cache, t_axes = tbuild(TARCHS[arch].SMOKE).cache_structure(2, 40, dtype=dt)
        j_cache, j_axes = jbuild(JARCHS[arch].SMOKE).cache_structure(
            2, 40, dtype=getattr(jax.numpy, jdt))
        got = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for t in jax.tree.leaves(t_cache, is_leaf=torch.is_tensor)]
        want = [(tuple(s.shape), str(s.dtype)) for s in jax.tree.leaves(j_cache)]
        assert got == want
        assert t_axes == j_axes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_consistency(arch):
    check_consistency(case(arch))


# JAX parity of the dense decoders; the other families are in
# test_torch_lm_models_{window,moe,recurrent}.py (one core per file)
PARITY = ["stablelm-3b", "granite-34b", "phi3-medium-14b"]


@pytest.mark.parametrize("arch", PARITY)
def test_loss(arch):
    check_loss(case(arch))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PARITY)
def test_prefill(arch, dtype):
    check_prefill(case(arch), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PARITY)
def test_decode_steps(arch, dtype):
    check_decode(case(arch), dtype)
