"""The port's LM models against the JAX package's: gemma3 (5:1 sliding
window, the ring cache wrapped by a prompt longer than its window),
qwen2-vl (M-RoPE behind a vision prefix) and whisper (encoder-decoder):
``loss``, ``prefill`` logits and caches, 4 decode steps.

Parameters, inputs, checks and tolerances as in
``test_torch_lm_models.py`` (``torch_lm_ref``).
"""
import functools

import pytest

from torch_lm_ref import ModelCase, check_decode, check_loss, check_prefill

PARITY = ['gemma3-1b', 'qwen2-vl-7b', 'whisper-medium']


@functools.lru_cache(maxsize=None)
def case(arch: str) -> ModelCase:
    return ModelCase(arch)


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
