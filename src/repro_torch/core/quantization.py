"""Saturating fixed-point arithmetic (paper Sec. VI-B "Update calculation").

The accelerator stores membrane potentials, weights and biases at 8 or 16
bit and uses saturation arithmetic: an overflowing addition clamps to the
largest representable value, an underflowing one to the smallest.  The
sum is formed in int32 and clamped back, so a single addition never
wraps.  Port of ``repro.core.quantization.saturating_add``.
"""
from __future__ import annotations

import torch

INT_DTYPES = {8: torch.int8, 16: torch.int16, 32: torch.int32}
#: storage range of the saturating datapaths
SAT_RANGE = {torch.int8: (-128, 127), torch.int16: (-32768, 32767)}


def saturating_add(a: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """a + b with saturation at the int<bits> range; output int<bits>."""
    wide = a.to(torch.int32) + b.to(torch.int32)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return wide.clamp(lo, hi).to(INT_DTYPES[bits])


def acc(patch: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """patch + contrib in patch's dtype; saturating for int8/int16."""
    sat = SAT_RANGE.get(patch.dtype)
    if sat is None:
        return patch + contrib
    wide = patch.to(torch.int32) + contrib.to(torch.int32)
    return wide.clamp(*sat).to(patch.dtype)
