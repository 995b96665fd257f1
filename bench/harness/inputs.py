"""The pool of inputs a cell's traffic draws from: made on the host by the
generator that the traffic file names (``generators/<name>.py``) from the
traffic's own seed, its rows in the order the run's seed draws."""
from __future__ import annotations

import numpy as np
import torch

from . import config
from .record import Pool


def _reorder(x, order: np.ndarray):
    if isinstance(x, torch.Tensor):
        return x[torch.from_numpy(order)]
    return [x[i] for i in order]


def make_pool(spec: dict, net: dict, seed: int) -> Pool:
    """``spec`` is the traffic file's ``inputs`` object.  The pool is the
    traffic's own (``spec["seed"]``); ``seed`` orders its rows, so that
    every run's seed gives the same work in another order."""
    gen = config.load_module("generators", spec["generator"])
    pool = gen.generate(spec, net)
    order = np.random.default_rng([seed % 2**63, 0]).permutation(len(pool))
    ref = None
    if pool.reference is not None:
        ref = (_reorder(pool.reference[0], order), pool.reference[1])
    return Pool(_reorder(pool.data, order), pool.kind, ref)
