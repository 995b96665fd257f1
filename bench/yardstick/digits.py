"""Frozen copy of the digit-like image generator (``synth_digits``).

Procedurally rendered 10-class glyphs that mimic MNIST's statistics
(28x28, white strokes on black): the same draws from the same seed as the
generator the program ships, kept here so that the benchmark's inputs
cannot move with the program.
"""
from __future__ import annotations

import numpy as np


def synth_digits(n: int, seed: int = 0, hw: tuple[int, int] = (28, 28),
                 noise: float = 0.08) -> tuple[np.ndarray, np.ndarray]:
    """Procedural 10-class digit-like dataset -> (images (N,H,W,1) in [0,1],
    labels (N,)).  Classes are distinct stroke patterns (segments of a
    7-segment-like glyph plus diagonals), randomly jittered and blurred.
    """
    h, w = hw
    rng = np.random.default_rng(seed)
    # 7-segment style layout in a unit square: (x0,y0,x1,y1) strokes
    seg = {
        "top": (0.2, 0.15, 0.8, 0.15), "mid": (0.2, 0.5, 0.8, 0.5),
        "bot": (0.2, 0.85, 0.8, 0.85), "tl": (0.2, 0.15, 0.2, 0.5),
        "tr": (0.8, 0.15, 0.8, 0.5), "bl": (0.2, 0.5, 0.2, 0.85),
        "br": (0.8, 0.5, 0.8, 0.85), "diag": (0.2, 0.85, 0.8, 0.15),
    }
    digit_segs = {
        0: ["top", "bot", "tl", "tr", "bl", "br"],
        1: ["tr", "br"],
        2: ["top", "mid", "bot", "tr", "bl"],
        3: ["top", "mid", "bot", "tr", "br"],
        4: ["mid", "tl", "tr", "br"],
        5: ["top", "mid", "bot", "tl", "br"],
        6: ["top", "mid", "bot", "tl", "bl", "br"],
        7: ["top", "tr", "br", "diag"],
        8: ["top", "mid", "bot", "tl", "tr", "bl", "br"],
        9: ["top", "mid", "bot", "tl", "tr", "br"],
    }
    images = np.zeros((n, h, w), np.float32)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        cls = labels[i]
        jx, jy = rng.uniform(-0.08, 0.08, 2)
        scale = rng.uniform(0.85, 1.1)
        thick = rng.uniform(0.035, 0.055)
        img = np.zeros((h, w), np.float32)
        for name in digit_segs[int(cls)]:
            x0, y0, x1, y1 = seg[name]
            x0, x1 = ((v - 0.5) * scale + 0.5 + jx for v in (x0, x1))
            y0, y1 = ((v - 0.5) * scale + 0.5 + jy for v in (y0, y1))
            px0, py0, px1, py1 = x0 * w, y0 * h, x1 * w, y1 * h
            # distance of each pixel to the stroke segment
            dx, dy = px1 - px0, py1 - py0
            ln2 = dx * dx + dy * dy + 1e-9
            t = np.clip(((xx - px0) * dx + (yy - py0) * dy) / ln2, 0, 1)
            dist2 = (xx - (px0 + t * dx)) ** 2 + (yy - (py0 + t * dy)) ** 2
            img = np.maximum(img, np.exp(-dist2 / (2 * (thick * w) ** 2)))
        img += rng.normal(0, noise, (h, w)).astype(np.float32)
        images[i] = np.clip(img, 0.0, 1.0)
    return images[..., None], labels
