"""The port's LM models against the JAX package's: the recurrent
families rwkv6 (chunked exclusive linear attention, token-shift state)
and zamba2 (Mamba2 SSD with a shared attention block): ``loss``,
``prefill`` logits and caches (states), 4 decode steps.

Parameters, inputs, checks and tolerances as in
``test_torch_lm_models.py`` (``torch_lm_ref``).
"""
import functools

import pytest

from torch_lm_ref import ModelCase, check_decode, check_loss, check_prefill

PARITY = ['rwkv6-1.6b', 'zamba2-1.2b']


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
