"""CIFAR-like 32x32 colour images (``yardstick/cifar.py``),
which the program encodes on the device.  CIFAR-10 itself is not in the
repository, so the images are synthetic.

Traffic keys, under ``inputs``: ``generator: "synth_cifar"``, ``seed``
and ``pool`` (the number of images).
"""
from __future__ import annotations

import torch

from harness.record import Pool
from yardstick import cifar


def generate(spec: dict, net: dict) -> Pool:
    images, _ = cifar.synth_cifar(spec["pool"], seed=spec["seed"],
                                  hw=tuple(net["input_hw"]))
    return Pool(torch.from_numpy(images), "images")
