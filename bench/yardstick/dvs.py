"""Frozen copy of the MVSEC-style moving-edge DVS generator and its binning.

``dvs_moving_edges`` sweeps an oriented edge band across a 28x28 field of
view: pixels the band newly covers fire ON events (polarity 1), pixels it
uncovers OFF events (polarity 0), plus a uniform noise floor, in shuffled
arbiter order.  ``events_to_frames`` bins a trace into dense (T, H, W, 2)
bool frames (channel 0 OFF, channel 1 ON).  The same draws from the same
seed as the generator the program ships, kept here so that the
benchmark's inputs cannot move with the program.
"""
from __future__ import annotations

import numpy as np

# (dy, dx) per direction class: right, left, down, up, and the diagonals
_DIRECTIONS = [(0, 1), (0, -1), (1, 0), (-1, 0),
               (1, 1), (-1, -1), (1, -1), (-1, 1)]


def dvs_moving_edges(
    n: int,
    t_bins: int,
    hw: tuple[int, int] = (28, 28),
    *,
    classes: int = 4,
    band: int = 2,
    noise_rate: float = 0.01,
    seed: int = 0,
) -> tuple[list[np.ndarray], np.ndarray]:
    """Generate ``n`` moving-edge event traces.

    Each trace is an oriented band of ``band`` pixels sweeping across the
    (H, W) field of view over ``t_bins`` time bins in one of ``classes``
    directions (the label).  Per bin, newly covered pixels emit ON
    events, newly uncovered ones OFF events; ``noise_rate`` adds
    uniform background events per pixel per bin.  Returns
    ``(traces, labels)`` where each trace is an (N_i, 4) int32 array of
    (t, y, x, polarity) rows in shuffled (non-raster) order — trace
    lengths vary with the scene, exactly like a real sensor.
    """
    if not 1 <= classes <= len(_DIRECTIONS):
        raise ValueError(f"classes must be in [1, {len(_DIRECTIONS)}]")
    h, w = hw
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    labels = rng.integers(0, classes, size=n).astype(np.int32)
    traces = []
    for i in range(n):
        dy, dx = _DIRECTIONS[int(labels[i])]
        # signed distance of each pixel along the sweep direction
        proj = dy * yy + dx * xx
        lo, hi = int(proj.min()), int(proj.max())
        # the band front advances linearly from just outside the FOV;
        # jittered start/speed so traces of one class still differ
        speed = (hi - lo + band) / max(t_bins - 1, 1)
        speed *= rng.uniform(0.85, 1.15)
        start = lo - band + rng.uniform(-1.0, 1.0)
        rows = []
        prev = np.zeros((h, w), bool)
        for t in range(t_bins):
            front = start + speed * t
            cover = (proj >= front - band) & (proj < front)
            on = cover & ~prev
            off = prev & ~cover
            prev = cover
            for pol, mask in ((1, on), (0, off)):
                ys, xs = np.nonzero(mask)
                if ys.size:
                    rows.append(np.stack(
                        [np.full(ys.size, t), ys, xs,
                         np.full(ys.size, pol)], axis=-1))
            n_noise = rng.poisson(noise_rate * h * w)
            if n_noise:
                rows.append(np.stack(
                    [np.full(n_noise, t),
                     rng.integers(0, h, n_noise),
                     rng.integers(0, w, n_noise),
                     rng.integers(0, 2, n_noise)], axis=-1))
        ev = (np.concatenate(rows, axis=0) if rows
              else np.zeros((0, 4), np.int32)).astype(np.int32)
        rng.shuffle(ev, axis=0)  # arbiter order, not raster order
        traces.append(ev)
    return traces, labels


def events_to_frames(events: np.ndarray, t_bins: int, hw: tuple[int, int],
                     channels: int = 2) -> np.ndarray:
    """Bin raw events into dense (T, H, W, C) bool frames — the reference
    frame-binned input (the layout ``snn_step_chunk`` takes, matching
    ``encode_input``'s channel-last output).  Out-of-window events drop,
    duplicates dedupe, exactly like ``aeq.append_events``."""
    h, w = hw
    ev = np.asarray(events, dtype=np.int64).reshape(-1, 4)
    frames = np.zeros((t_bins, h, w, channels), bool)
    if ev.size:
        t, y, x, p = ev.T
        ok = ((t >= 0) & (t < t_bins) & (y >= 0) & (y < h)
              & (x >= 0) & (x < w) & (p >= 0) & (p < channels))
        frames[t[ok], y[ok], x[ok], p[ok]] = True
    return frames
