"""Open-loop Poisson arrivals at a fixed rate.

Traffic keys, under ``arrivals``: ``process: "poisson"`` and
``rate_per_s``.
"""
from __future__ import annotations

import numpy as np


def draw(spec: dict, seconds: float, n_pool: int, seed: int,
         stream: int) -> tuple[np.ndarray, np.ndarray]:
    """Due times in [0, seconds) and the pool row of each.  The gaps
    between arrivals are one fixed draw at the rate; ``seed`` orders them
    and the pool's rows (each used alike), so every seed offers the same
    arrivals in another order.  ``stream`` tells the warm-up's draw from
    the window's."""
    rate = spec["rate_per_s"]
    n = int(rate * seconds)
    gaps = np.random.default_rng(stream).exponential(1.0 / rate, n)
    gaps *= seconds / gaps.sum()  # exactly n arrivals in the window
    rng = np.random.default_rng([seed % 2**63, stream])
    due = np.concatenate([[0.0], np.cumsum(rng.permutation(gaps))[:-1]])
    return due, rng.permutation(np.arange(n) % n_pool)
