"""Synthetic data of the port: numpy copies of
``repro.data.synthetic`` (same draws from the same seed, so both
packages see the same data), and the batcher that moves LM batches to
devices.

* ``TokenStream`` — deterministic synthetic language-model data with
  learnable structure (a Zipfian unigram mixture + periodic copy motifs),
  so small LMs show decreasing loss within a few hundred steps.
* ``synth_digits`` — procedurally rendered 10-class digit-like glyphs for
  the CSNN: MNIST is not downloadable offline, and the generator mimics
  its statistics (28x28, white strokes on black, ~19% active pixels).
* ``ShardedBatcher`` — a ``TokenStream`` batch as tensors on one device,
  or as contiguous batch shards over a list of devices.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class TokenStream:
    """Deterministic, seekable synthetic token stream.

    Structure: tokens follow a Zipf distribution, but every ``motif_every``
    positions a motif of ``motif_len`` tokens is repeated from earlier in
    the sequence — an in-context copy signal that gives attention/SSM
    models something real to learn.
    """

    def __init__(self, vocab: int, seed: int = 0, motif_len: int = 8,
                 motif_every: int = 32):
        self.vocab = vocab
        self.seed = seed
        self.motif_len = motif_len
        self.motif_every = motif_every

    def batch(self, step: int, batch_size: int, seq_len: int) -> dict:
        """Returns {"tokens", "labels"} int32 arrays (B, S); labels are the
        inputs shifted by the model's loss (next-token), so labels==tokens."""
        rng = np.random.default_rng((self.seed, step))
        ranks = np.arange(1, self.vocab + 1)
        probs = 1.0 / ranks ** 1.1
        probs /= probs.sum()
        toks = rng.choice(self.vocab, size=(batch_size, seq_len), p=probs)
        for row in toks:  # plant copy motifs
            for start in range(self.motif_every, seq_len - self.motif_len,
                               self.motif_every):
                src = start - self.motif_every
                row[start: start + self.motif_len] = row[src: src + self.motif_len]
        toks = toks.astype(np.int32)
        return {"tokens": toks, "labels": toks.copy()}


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


class ShardedBatcher:
    """``TokenStream`` batches as tensors on the devices.

    With ``devices=None`` a call returns the batch on ``device``.  Given a
    list of devices (``sharding.specs.batch_devices``) it returns one
    batch dict per device, each the next contiguous ``batch_size / n``
    rows: the shards JAX's batcher lays over a 1-D data mesh.  The
    iterator state is just (seed, step), so a restarted job resumes
    mid-epoch byte-identically.  A copy to a CUDA device goes through
    pinned memory without blocking the host.
    """

    def __init__(self, stream: TokenStream, batch_size: int, seq_len: int,
                 device="cuda", devices: Optional[Sequence] = None):
        import torch
        self.stream = stream
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.device = torch.device(device)
        self.devices = None if devices is None else [torch.device(d)
                                                     for d in devices]
        if self.devices is not None and batch_size % len(self.devices):
            raise ValueError(f"batch {batch_size} does not split over "
                             f"{len(self.devices)} devices")

    @staticmethod
    def _put(a: np.ndarray, device):
        import torch
        t = torch.from_numpy(a)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def __call__(self, step: int):
        host = self.stream.batch(step, self.batch_size, self.seq_len)
        if self.devices is None:
            return {k: self._put(v, self.device) for k, v in host.items()}
        n = self.batch_size // len(self.devices)
        return [{k: self._put(np.ascontiguousarray(v[i * n:(i + 1) * n]), d)
                 for k, v in host.items()}
                for i, d in enumerate(self.devices)]
