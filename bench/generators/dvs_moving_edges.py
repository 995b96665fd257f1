"""Synthetic 2-polarity event-camera traces of moving edges (the frozen
copy ``yardstick/dvs.py``), binned at set-up to (T, H, W, C) spike
frames, which the program takes as they are.

Traffic keys, under ``inputs``: ``generator: "dvs_moving_edges"``,
``seed``, ``pool`` (the number of traces), ``classes``, ``band`` and
``noise_rate``.
"""
from __future__ import annotations

import numpy as np
import torch

from harness.record import Pool
from yardstick import dvs


def generate(spec: dict, net: dict) -> Pool:
    t, hw = net["t_steps"], tuple(net["input_hw"])
    traces, _ = dvs.dvs_moving_edges(
        spec["pool"], t, hw, classes=spec["classes"], band=spec["band"],
        noise_rate=spec["noise_rate"], seed=spec["seed"])
    frames = np.stack([dvs.events_to_frames(tr, t, hw, net["input_channels"])
                       for tr in traces])
    return Pool(torch.from_numpy(frames), "spikes")
