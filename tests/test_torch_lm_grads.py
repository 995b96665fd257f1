"""Gradients of the port's LM losses against ``jax.value_and_grad`` on the
CPU: the dense decoders (stablelm, granite, phi3), then the pieces the
backward pass recomputes or that have kinks: ``clip`` at its bounds
(JAX's split gradient), the query-blocked attention (each block
checkpointed) and the chunked cross entropy (each chunk checkpointed).

The other families: ``test_torch_lm_grads_window.py`` (gemma3, qwen2-vl,
whisper), ``..._moe.py`` (llama4, deepseek-v2), ``..._recurrent.py``
(rwkv6, zamba2).  Parameters from ``torch_lm_ref.np_params``; the loss,
ce and aux at rtol 1e-5; each gradient leaf within 1e-3 of its largest
JAX entry (``torch_lm_ref.GRAD_ATOL``); remat on and off ``torch.equal``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from torch_lm_ref import (ModelCase, assert_grads_close, check_grads,
                          check_remat_equal)

ARCHS = ["stablelm-3b", "granite-34b", "phi3-medium-14b"]


@functools.lru_cache(maxsize=None)
def case(arch: str) -> ModelCase:
    return ModelCase(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads(arch):
    check_grads(case(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_equal_grads(arch):
    check_remat_equal(case(arch))


@pytest.mark.parametrize("lo,hi", [(-8.0, 1.0), (None, 80.0), (0.0, None)])
def test_clip_matches_jnp_clip_at_its_bounds(lo, hi):
    """Values on each bound, inside and outside: ``clip``'s values and
    gradient equal ``jnp.clip``'s exactly (half the gradient on a bound);
    ``Tensor.clamp`` would pass all of it there."""
    pts = [v for v in (lo, hi) if v is not None]
    x = np.array(pts + [p + d for p in pts for d in (-0.5, 0.5)] + [0.25],
                 np.float32)
    w = np.linspace(0.5, 2.0, x.size).astype(np.float32)
    jval, jgrad = jax.value_and_grad(
        lambda a: jnp.sum(jnp.clip(a, lo, hi) * w))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    val = (tcommon.clip(t, lo, hi) * torch.from_numpy(w)).sum()
    val.backward()
    np.testing.assert_array_equal(val.detach().numpy(), np.asarray(jval))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jgrad))
    on_bound = np.isin(x, pts)
    np.testing.assert_array_equal(t.grad.numpy()[on_bound], 0.5 * w[on_bound])


@pytest.mark.parametrize("window", [None, 5])
def test_blocked_attention_grads(window):
    """The query-blocked path (every block checkpointed) at q_block 8 over
    S=20 (a padded last block; sliding KV slices when windowed): the
    output and the gradients of q, k and v against JAX's."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 20, h, 8)).astype(np.float32)
               for h in (4, 2, 2))
    w = rng.normal(size=(2, 20, 4, 8)).astype(np.float32)

    def jloss(q, k, v):
        out = jattn._attend_qblocks(q, k, v, window=window, q_block=8)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn._attend_qblocks(tq, tk, tv, window=window, q_block=8)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    assert_grads_close([tq.grad, tk.grad, tv.grad], list(jg))


def test_chunked_ce_grads():
    """The chunked cross entropy (each chunk checkpointed) at chunk 8 over
    S=21 (a padded chunk, masked labels): value and the gradients of the
    hidden states and the projection against JAX's."""
    rng = np.random.default_rng(4)
    h = rng.normal(size=(2, 21, 16)).astype(np.float32)
    wo = (0.3 * rng.normal(size=(16, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 21)).astype(np.int32)
    mask = (rng.random((2, 21)) > 0.2).astype(np.float32)
    jval, jg = jax.value_and_grad(
        lambda a, b: jcommon.chunked_softmax_ce(a, b, jnp.asarray(labels),
                                                jnp.asarray(mask), chunk=8),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(wo))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, wo))
    val = tcommon.chunked_softmax_ce(th, tw, torch.from_numpy(labels).long(),
                                     torch.from_numpy(mask), chunk=8)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-6)
    assert_grads_close([th.grad, tw.grad], list(jg))
