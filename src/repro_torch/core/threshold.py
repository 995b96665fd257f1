"""Thresholding unit (paper Secs. V-C / VI-C; port of
``repro.core.threshold``).

After the conv unit has accumulated a time step's events, every neuron
is visited once: the per-channel bias is added (saturating for int
datapaths), the neuron spikes when it crosses V_t or its m-TTFS
indicator bit is already set, and an optional non-overlapping max-pool
of the binary map reduces to an OR over each window.  The batched CUDA
version of this pass is ``kernels/threshold_pool``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .quantization import INT_DTYPES, saturating_add


class ThresholdResult(NamedTuple):
    v_m: torch.Tensor     # bias-updated membrane potentials (H, W)
    fired: torch.Tensor   # updated spike-indicator bits (H, W)
    spikes: torch.Tensor  # binary output map (H, W) or pooled (H/p, W/p)


def or_pool(spikes: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Non-overlapping max-pool of a binary (..., H, W) map == OR over
    each window; ragged edges pad with False."""
    *lead, h, w = spikes.shape
    s = torch.nn.functional.pad(spikes.to(torch.uint8),
                                (0, -w % window, 0, -h % window))
    hh, ww = s.shape[-2:]
    s = s.reshape(*lead, hh // window, window, ww // window, window)
    return s.amax(dim=(-3, -1)).to(torch.bool)


def as_vm_scalar(x, dtype: torch.dtype):
    """``jnp.asarray(x, dtype)`` for a Python scalar: float32 rounding, or
    truncation toward zero for an int datapath."""
    if dtype in INT_DTYPES.values():
        return int(x)
    return float(torch.tensor(x, dtype=dtype))


def threshold_unit(
    v_m: torch.Tensor,
    bias,
    v_t,
    fired: torch.Tensor,
    *,
    pool: Optional[int] = None,
    sat_bits: Optional[int] = None,
) -> ThresholdResult:
    """One thresholding sweep over one channel's (H, W) potentials.

    ``bias`` (scalar or broadcastable tensor) is cast to the potentials'
    dtype — truncating toward zero for an int datapath, as JAX's
    ``jnp.asarray`` does — and added every time step, saturating in
    int<sat_bits> when ``sat_bits`` is set.
    """
    b = torch.as_tensor(bias, device=v_m.device)
    b = torch.broadcast_to(b.to(v_m.dtype), v_m.shape)
    if sat_bits is not None:
        v_m = saturating_add(v_m, b, sat_bits)
    else:
        v_m = v_m + b
    spikes = (v_m > as_vm_scalar(v_t, v_m.dtype)) | fired
    out = or_pool(spikes, pool) if pool is not None else spikes
    return ThresholdResult(v_m=v_m, fired=spikes, spikes=out)
