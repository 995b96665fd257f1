"""Parameters across the two packages.

The JAX package keeps CSNN parameters as a pytree
``{"conv0": {"w": array, "b": array}, ...}``; the port keeps the same
layout with tensors.  Numpy is the bridge: a JAX pytree becomes numpy
with ``jax.tree.map(np.asarray, params)`` on the JAX side, and these two
functions do the rest.  Dtypes (float32, int16, int8, bool) are kept.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(np_params: dict, device="cuda") -> dict:
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device``."""
    return {k: params_from_numpy(v, device) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in np_params.items()}


def params_to_numpy(params: dict) -> dict:
    """Nested dict of tensors -> the same dict of numpy arrays."""
    return {k: params_to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy()
            for k, v in params.items()}
