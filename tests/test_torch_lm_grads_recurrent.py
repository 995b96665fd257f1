"""Gradients of the recurrent models (rwkv6: chunked linear attention
with a data-dependent decay; zamba2: Mamba2 with a weight-shared
attention block) against ``jax.value_and_grad`` on the CPU, remat on and
off ``torch.equal``, and rwkv6 with its decay pinned on ``jnp.clip``'s
upper bound, where JAX passes half the gradient.  Parameters, inputs and
tolerances as in ``test_torch_lm_grads.py``."""
import functools

import jax
import numpy as np
import pytest

from torch_lm_ref import (ModelCase, assert_grads_close, both, check_grads,
                          check_remat_equal, jax_value_and_grad, np_params,
                          port_value_and_grad)

ARCHS = ["rwkv6-1.6b", "zamba2-1.2b"]


@functools.lru_cache(maxsize=None)
def case(arch: str) -> ModelCase:
    return ModelCase(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads(arch):
    check_grads(case(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_equal_grads(arch):
    check_remat_equal(case(arch))


def test_rwkv_decay_on_the_clip_bound():
    """decay_base = 1.0 and a zero decay LoRA put every channel's decay
    exactly on ``clip``'s upper bound (``_decay``: clip(base + lora, -8,
    1)): JAX's gradient of decay_base is half of what ``Tensor.clamp``
    would pass, and the port's equals JAX's."""
    c = case("rwkv6-1.6b")
    npp = np_params(c.jm.specs, seed=0)
    for layer in npp["groups"][0]:
        tm = layer["tm"]
        tm["decay_base"] = np.ones_like(tm["decay_base"])
        tm["decay_w2"] = np.zeros_like(tm["decay_w2"])
    jp, tp = both(npp)
    (_, _), jg = jax_value_and_grad(c.jm, jp, c.jbatch(c.train))
    (_, _), tg = port_value_and_grad(c.tm, tp, c.tbatch(c.train))
    jbase = np.asarray(jg["groups"][0][0]["tm"]["decay_base"])
    assert np.abs(jbase).max() > 0
    assert_grads_close(tg, jg)
