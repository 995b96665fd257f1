"""Digit-like 28x28 grey images (the frozen copy ``yardstick/digits.py``),
which the program encodes on the device.

Traffic keys, under ``inputs``: ``generator: "synth_digits"``, ``seed``
and ``pool`` (the number of images).
"""
from __future__ import annotations

import torch

from harness.record import Pool
from yardstick import digits


def generate(spec: dict, net: dict) -> Pool:
    images, _ = digits.synth_digits(spec["pool"], seed=spec["seed"],
                                    hw=tuple(net["input_hw"]))
    return Pool(torch.from_numpy(images), "images")
