"""Gradients of the MoE decoders (llama4: interleaved MoE with a shared
expert; deepseek-v2: MLA, leading dense layers, the aux loss) against
``jax.value_and_grad`` on the CPU, remat on and off ``torch.equal``, and
``moe_forward``'s gradients where routing drops rows at capacity and where
tied router logits make top-k pick by index.  Parameters, inputs and
tolerances as in ``test_torch_lm_grads.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ffn as jffn
from repro_torch.models import ffn as tffn
from torch_lm_ref import (ModelCase, assert_grads_close, both, check_grads,
                          check_remat_equal, np_params)

ARCHS = ["llama4-maverick-400b-a17b", "deepseek-v2-236b"]


@functools.lru_cache(maxsize=None)
def case(arch: str) -> ModelCase:
    return ModelCase(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads(arch):
    check_grads(case(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_equal_grads(arch):
    check_remat_equal(case(arch))


@pytest.mark.parametrize("router", ["random", "tied"])
@pytest.mark.parametrize("top_k,softmax,cap", [(2, True, 0.5), (1, False, 0.5)])
def test_moe_grads_through_drops_and_ties(top_k, softmax, cap, router):
    """Capacity 0.5 drops the overflow of every popular expert (those rows
    get no expert gradient, as JAX's ``mode="drop"``); a zero router ties
    every expert (top-k by index).  The output and aux loss are weighted
    into one scalar; the gradients of the input and every parameter held
    against JAX's."""
    specs = jffn.moe_specs(64, 96, 8, n_shared=1)
    npp = np_params(specs, 6)
    if router == "tied":
        npp["router"] = np.zeros_like(npp["router"])
    jp, tp = both(npp)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    w = rng.normal(size=(2, 16, 64)).astype(np.float32)
    kw = dict(top_k=top_k, capacity_factor=cap, router_softmax=softmax)

    def jloss(p, a):
        out, aux = jffn.moe_forward(p, a, **kw)
        return jnp.sum(out * w) + 3.0 * aux

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tp = jax.tree.map(lambda t: t.requires_grad_(), tp,
                      is_leaf=torch.is_tensor)
    out, aux = tffn.moe_forward(tp, tx, **kw)
    ((out * torch.from_numpy(w)).sum() + 3.0 * aux).backward()
    got = jax.tree.map(lambda t: t.grad, tp, is_leaf=torch.is_tensor)
    assert_grads_close([got, tx.grad], list(jg))
