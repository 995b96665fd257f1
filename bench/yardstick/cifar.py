"""The CIFAR-like colour image generator (``synth_cifar``).

Procedural 10-class 32x32 colour images (smooth colour fields cut by an
edge, with noise) in place of CIFAR-10, which is not in the repository.
The program ships no such generator; it lives beside the reference so
that the benchmark's inputs cannot move with the program.
"""
from __future__ import annotations

import numpy as np


def _lerp_weights(n: int, k: int) -> np.ndarray:
    """(n, k) weights that interpolate k grid values linearly onto n
    points, the grid's ends on the first and last point."""
    at = np.linspace(0.0, k - 1.0, n)
    lo = np.minimum(np.floor(at).astype(np.int64), k - 2)
    frac = at - lo
    out = np.zeros((n, k))
    out[np.arange(n), lo] = 1.0 - frac
    out[np.arange(n), lo + 1] = frac
    return out


def synth_cifar(n: int, seed: int = 0, hw: tuple[int, int] = (32, 32),
                noise: float = 0.05, grid: int = 4
                ) -> tuple[np.ndarray, np.ndarray]:
    """Procedural 10-class colour images -> (images (N, H, W, 3) float32
    in [0, 1], labels (N,)).

    Each image is a smooth colour field (a ``grid`` x ``grid`` lattice of
    colours drawn in [0.1, 0.9], interpolated bilinearly), cut by one
    straight edge through a point near the centre at the class's angle
    (k * pi / 10, jittered) across which every channel shifts by its own
    amount in [-0.5, 0.5], plus Gaussian pixel noise, clipped to [0, 1].
    """
    h, w = hw
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    lattice = rng.uniform(0.1, 0.9, (n, grid, grid, 3))
    field = np.einsum("yi,nijc,xj->nyxc", _lerp_weights(h, grid), lattice,
                      _lerp_weights(w, grid), optimize=True)
    theta = labels * (np.pi / 10) + rng.uniform(-0.15, 0.15, n)
    cy, cx = rng.uniform(0.3, 0.7, (2, n))
    shift = rng.uniform(-0.5, 0.5, (n, 3))
    yy = (np.arange(h) + 0.5)[None, :, None] / h
    xx = (np.arange(w) + 0.5)[None, None, :] / w
    side = ((yy - cy[:, None, None]) * np.cos(theta)[:, None, None]
            - (xx - cx[:, None, None]) * np.sin(theta)[:, None, None]) > 0
    img = field + side[..., None] * shift[:, None, None, :]
    img += rng.normal(0.0, noise, img.shape)
    return np.clip(img, 0.0, 1.0).astype(np.float32), labels
