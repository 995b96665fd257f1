"""Input encoding: real-valued frames -> binary m-TTFS spike trains
(paper Sec. VII; port of ``repro.core.encoding``).

Thresholds are applied in decreasing order over time: at t=0 only pixels
above the largest threshold spike, each later step lowers the threshold,
so every per-pixel train is monotone (0...0 1...1).  ``rate_encode`` is
the Bernoulli rate-coding baseline; ``spike_sparsity`` the zero share of
a spike map.
"""
from __future__ import annotations

import torch

from .xla_arith import reciprocal_f32


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


def rate_encode(frames: torch.Tensor, t_steps: int,
                generator: torch.Generator) -> torch.Tensor:
    """Bernoulli rate coding baseline: P(spike at t) = pixel intensity in
    [0, 1].  (..,) frames -> (T, ...) bool, uniforms drawn from
    ``generator`` on its device (:func:`rate_encode_uniform`)."""
    u = torch.rand((t_steps,) + tuple(frames.shape), generator=generator,
                   device=generator.device)
    return rate_encode_uniform(frames, u.to(frames.device, non_blocking=True))


def rate_encode_uniform(frames: torch.Tensor,
                        uniforms: torch.Tensor) -> torch.Tensor:
    """:func:`rate_encode` given its (T, ...) float32 uniforms in [0, 1):
    ``uniforms < clip(frames, 0, 1)``, which is ``jax.random.bernoulli``
    (so JAX's uniforms give JAX's spikes exactly)."""
    return uniforms < frames.clamp(0.0, 1.0)[None]


def spike_sparsity(spikes: torch.Tensor) -> torch.Tensor:
    """Fraction of zero entries, the paper's 'sparsity' metric (Table
    III), as a 0-dim float32 tensor.  The mean is the exact spike count
    times float32(1 / n), as XLA compiles ``jnp.mean``
    (``core.xla_arith``), so the value is JAX's bit for bit."""
    inv_n = torch.tensor(reciprocal_f32(max(spikes.numel(), 1)))
    return 1.0 - spikes.to(torch.float32).sum() * inv_n.to(spikes.device)
