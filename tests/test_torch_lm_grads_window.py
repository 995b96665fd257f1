"""Gradients of gemma3 (5:1 sliding window), qwen2-vl (M-RoPE behind a
vision prefix) and whisper (encoder-decoder; every encoder and decoder
layer checkpointed under remat) against ``jax.value_and_grad`` on the
CPU, and remat on and off ``torch.equal``.  Parameters, inputs and
tolerances as in ``test_torch_lm_grads.py``."""
import functools

import pytest

from torch_lm_ref import ModelCase, check_grads, check_remat_equal

ARCHS = ["gemma3-1b", "qwen2-vl-7b", "whisper-medium"]


@functools.lru_cache(maxsize=None)
def case(arch: str) -> ModelCase:
    return ModelCase(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads(arch):
    check_grads(case(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_equal_grads(arch):
    check_remat_equal(case(arch))
