"""Input encoding: real-valued frames -> binary m-TTFS spike trains
(paper Sec. VII; port of ``repro.core.encoding``).

Thresholds are applied in decreasing order over time: at t=0 only pixels
above the largest threshold spike, each later step lowers the threshold,
so every per-pixel train is monotone (0...0 1...1).
"""
from __future__ import annotations

import torch


def mttfs_thresholds(t_steps: int, lo: float = 0.0, hi: float = 1.0,
                     device=None) -> torch.Tensor:
    """A strictly increasing threshold set with T-1 float32 entries in
    (lo, hi).

    ``torch.linspace`` rounds differently from ``jnp.linspace`` at several
    T (3, 6, 7, 10..15, ...), and a pixel sitting on a threshold would
    flip.  ``lo + arange(T+1) * float32((hi-lo)/T)`` reproduces the JAX
    thresholds bit for bit (tests/test_torch_encoding_aeq.py sweeps T).
    """
    if t_steps < 2:
        raise ValueError("m-TTFS input encoding needs at least 2 time steps")
    step = torch.tensor(hi - lo, dtype=torch.float32) / t_steps
    grid = lo + torch.arange(t_steps + 1, dtype=torch.float32) * step
    # encode_input builds the grid on the host (device=None): no copy
    # analysis: ignore[lint-host-sync-in-hot-path]
    return grid[1:-1].to(device)


def multi_threshold_encode(frames: torch.Tensor, thresholds: torch.Tensor,
                           t_steps: int) -> torch.Tensor:
    """(...,) frames -> (T, ...) bool spike maps, monotone per pixel."""
    thresholds = torch.sort(torch.as_tensor(thresholds)).values
    if thresholds.shape[0] != t_steps - 1:
        raise ValueError(f"need {t_steps - 1} thresholds for T={t_steps}, "
                         f"got {thresholds.shape[0]}")
    # decreasing order; the last step reuses the lowest threshold so the
    # trains stay monotone across all T steps
    order = torch.cat([thresholds.flip(0), thresholds[:1]])
    # T-1 host floats: an asynchronous copy, so encoding on a device never
    # waits for the work queued before it
    order = order.to(frames.device, non_blocking=True)
    order = order.reshape((t_steps,) + (1,) * frames.ndim)
    return frames[None] > order
