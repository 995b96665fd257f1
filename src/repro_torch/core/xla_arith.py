"""Scalar float32 arithmetic as XLA compiles it on the CPU.

Two host-side calibrations of the JAX package run through XLA, and the
port reproduces their numbers bit for bit: ``jnp.percentile`` (the
threshold balancing of ``core.conversion`` and ``calibrate_scale``) and
the learning-rate schedule of the AdamW ``fit_ann`` trains with.  XLA's
CPU compiler rewrites them in two ways that change float32 results:

* a division by a constant becomes a multiplication by the constant's
  float32 reciprocal (and constant factors fold together);
* a product followed by a sum fuses into one multiply-add, rounded once.

:func:`fma_f32` is the second; the callers spell the first out.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np


def fma_f32(a, b, c) -> np.float32:
    """a * b + c for float32 scalars, rounded once to float32 (nearest,
    ties to even), as a fused multiply-add rounds it."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))  # within one ulp of the exact value
    cands = (np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(v.view(np.int32)) & 1))


def reciprocal_f32(d) -> np.float32:
    """The float32 reciprocal XLA multiplies by in place of dividing by
    the constant ``d``."""
    return np.float32(1) / np.float32(d)
