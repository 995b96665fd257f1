"""Saturating fixed-point arithmetic (paper Sec. VI-B "Update calculation";
port of ``repro.core.quantization``).

The accelerator stores membrane potentials, weights and biases at 8 or 16
bit and uses saturation arithmetic: an overflowing addition clamps to the
largest representable value, an underflowing one to the smallest.  The
sum is formed in int32 and clamped back, so a single addition never
wraps.  A symmetric quantizer (``QuantSpec``, ``calibrate_scale``,
``quantize``) maps trained float weights onto the fixed-point grid.

Rounding.  Every division here is float32 by a 0-dim float32 tensor on
the operand's device: for a Python-scalar divisor PyTorch's CUDA kernel
may multiply by the reciprocal instead, one ulp off, which flips a value
on a .5 boundary of the scale.  So ``quantize`` gives the same integers
on the card, on the CPU and in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .xla_arith import fma_f32, reciprocal_f32

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


@dataclass(frozen=True)
class QuantSpec:
    """Symmetric fixed-point format: value = int * scale."""

    bits: int
    scale: float

    @property
    def dtype(self) -> torch.dtype:
        return INT_DTYPES[self.bits]

    @property
    def max_int(self) -> int:
        return 2 ** (self.bits - 1) - 1

    @property
    def min_int(self) -> int:
        return -(2 ** (self.bits - 1))


def f32_scalar(value: float, device=None) -> torch.Tensor:
    """``value`` as a 0-dim float32 tensor on ``device``: the divisor (or
    factor) that keeps a float32 operation exact on every device."""
    return torch.full((), value, dtype=torch.float32, device=device)


def quantize(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Float -> saturating fixed-point integers (round half to even)."""
    q = torch.round(x / f32_scalar(spec.scale, x.device))
    return q.clamp(spec.min_int, spec.max_int).to(spec.dtype)


def dequantize(q: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    return q.to(torch.float32) * f32_scalar(spec.scale, q.device)


def fake_quant(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient (QAT)."""
    rounded = dequantize(quantize(x, spec), spec)
    return x + (rounded - x).detach()


def percentile_f32(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` (linear method, over all elements) as a
    0-dim float32 CPU tensor, bit for bit.  The arithmetic is the one XLA
    compiles an eager ``jnp.percentile`` call to (``core.xla_arith``),
    all in float32: the position q / 100 * (n - 1) becomes q * ((n - 1)
    * float32(1 / 100)), and the interpolation's second product and its
    sum fuse into one multiply-add.  ``torch.quantile`` refuses inputs
    above 2**24 elements; this sorts on ``x``'s device and reads the two
    neighbours (and the largest value) back."""
    a = torch.sort(x.detach().reshape(-1).to(torch.float32)).values
    n = torch.tensor(a.numel(), dtype=torch.float32)
    pos = (torch.tensor(q, dtype=torch.float32)
           * ((n - 1) * torch.tensor(reciprocal_f32(100))))
    low, high = pos.floor(), pos.ceil()
    w_high = pos - low
    w_low = 1 - w_high
    idx = [int(low.clamp(0, n - 1)), int(high.clamp(0, n - 1)), -1]
    v_low, v_high, v_max = a[idx].cpu()
    if torch.isnan(v_max):  # a NaN sorts last; jnp.percentile gives NaN
        return v_max
    return torch.tensor(fma_f32(v_high, w_high, v_low * w_low))


def calibrate_scale(x: torch.Tensor, bits: int,
                    percentile: float = 100.0) -> float:
    """The symmetric scale that covers |x| up to the given percentile:
    float32 ``amax / (2**(bits-1) - 1)``."""
    amax = torch.maximum(percentile_f32(x.abs(), percentile),
                         f32_scalar(1e-8))
    return float(amax / f32_scalar(2 ** (bits - 1) - 1))
