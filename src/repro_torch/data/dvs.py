"""Synthetic DVS event traces of the port: a numpy copy of
``repro.data.dvs`` (the same draws from the same seed, so both packages
see the same traces row for row).

MVSEC-style moving-edge scenes.

A real event camera emits an address event (t, y, x, polarity) whenever a
pixel's log-intensity changes past a contrast threshold — exactly the
sparse workload the paper's accelerator (and the streaming AEQ ingestion
of ``core/aeq.py``) is built for.  MVSEC-class automotive/indoor scenes
are dominated by moving intensity *edges*, so the generator here sweeps
an oriented edge band across the field of view: pixels the band newly
covers fire ON events (polarity 1), pixels it uncovers fire OFF events
(polarity 0), plus a uniform noise-event floor.  Event order inside a
trace is shuffled — sensor arbiters do not emit in raster order, and the
ingestion path must be order-invariant (tests/test_torch_streaming.py).

Polarity maps onto the existing 2-channel input path
(``CSNNConfig.input_channels=2``): channel 0 = OFF, channel 1 = ON.

Host-side helpers of the two admission paths:

* ``events_to_frames`` — the frame-binned reference: dense (T, H, W, C)
  bool frames, the input the legacy pipeline re-compacts with a sort;
* ``events_to_banks`` — the streaming admission: scatter events straight
  into the interlace-column bank layout of
  :class:`repro_torch.core.aeq.StreamState` (a cheap numpy assignment —
  this is the engine's per-request "encode");
* ``iter_stream_chunks`` — slice a trace into fixed-buffer
  :class:`repro_torch.core.aeq.StreamChunk` windows for admission.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.geometry import GEOM_3X3

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


def events_to_banks(events: np.ndarray, t_bins: int, hw: tuple[int, int],
                    channels: int = 2, geometry=None) -> np.ndarray:
    """Scatter raw events straight into the (T, C, n_banks, HB, WB) bool
    interlace-column banks of :class:`repro_torch.core.aeq.StreamState` —
    the host-side streaming admission: one vectorized assignment per chunk,
    no threshold encode, no sort (numpy twin of ``aeq.append_events``).
    ``geometry`` is the first conv layer's window (default 3x3); the bank
    count and macro grid follow it."""
    if geometry is None:
        geometry = GEOM_3X3
    kh, kw = geometry.kh, geometry.kw
    h, w = hw
    hb, wb = -(-h // kh), -(-w // kw)
    ev = np.asarray(events, dtype=np.int64).reshape(-1, 4)
    banks = np.zeros((t_bins, channels, kh * kw, hb, wb), bool)
    if ev.size:
        t, y, x, p = ev.T
        ok = ((t >= 0) & (t < t_bins) & (y >= 0) & (y < h)
              & (x >= 0) & (x < w) & (p >= 0) & (p < channels))
        t, y, x, p = t[ok], y[ok], x[ok], p[ok]
        banks[t, p, (y % kh) * kw + x % kw, y // kh, x // kw] = True
    return banks


def iter_stream_chunks(events: np.ndarray, t_bins: int, window: int,
                       buffer: int):
    """Split a trace into per-window (t0, events, num) admission chunks.

    Yields one (t0, padded_events (buffer, 4) int32, num) triple per
    ``window``-bin slice of the trace, with event times re-based to the
    window start — the fixed-shape unit an ``append_events`` call admits.
    A slice holding more than ``buffer`` events raises: the ingestion
    buffer (``LayerPlan.ingest_capacity``) is backpressure, not silent
    truncation.
    """
    ev = np.asarray(events, dtype=np.int32).reshape(-1, 4)
    for t0 in range(0, t_bins, window):
        sel = ev[(ev[:, 0] >= t0) & (ev[:, 0] < min(t0 + window, t_bins))]
        if sel.shape[0] > buffer:
            raise ValueError(
                f"window [{t0}, {t0 + window}) holds {sel.shape[0]} events "
                f"> ingest buffer {buffer}; deepen LayerPlan.ingest_capacity "
                f"or shorten the admission window")
        out = np.full((buffer, 4), -1, np.int32)
        out[:sel.shape[0]] = sel
        out[:sel.shape[0], 0] -= t0
        yield t0, out, sel.shape[0]
