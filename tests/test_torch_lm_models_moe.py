"""The port's LM models against the JAX package's: the MoE decoders
llama4-maverick (interleaved MoE, sigmoid router, top-1) and deepseek-v2
(MLA, a leading dense layer, top-2 of 8 with a shared expert):
``loss``, ``prefill`` logits and caches, 4 decode steps.

Parameters, inputs, checks and tolerances as in
``test_torch_lm_models.py`` (``torch_lm_ref``).
"""
import functools

import pytest

from torch_lm_ref import ModelCase, check_decode, check_loss, check_prefill

PARITY = ['llama4-maverick-400b-a17b', 'deepseek-v2-236b']


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
