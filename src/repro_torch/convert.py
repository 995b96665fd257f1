"""Parameters across the two packages.

The JAX package keeps parameters as pytrees: CSNN parameters as
``{"conv0": {"w": array, "b": array}, ...}``, LM parameters as nested
dicts, lists and tuples (a decoder's ``groups`` is a list of tuples).
The port keeps the same layout with tensors.  Numpy is the bridge: a JAX
pytree becomes numpy with ``jax.tree.map(np.asarray, params)`` on the
JAX side, and these two functions do the rest.  Containers keep their
type (dict, list, tuple), leaves their dtype (float32, bfloat16 as
numpy's ``bfloat16`` from ml_dtypes excepted, int16, int8, bool).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(np_params: Any, device="cuda") -> Any:
    """Tree of dicts, lists and tuples of numpy arrays -> the same tree
    of tensors on ``device`` (each leaf copied: the tensors own their
    memory)."""
    if isinstance(np_params, dict):
        return {k: params_from_numpy(v, device) for k, v in np_params.items()}
    if isinstance(np_params, (list, tuple)):
        return type(np_params)(params_from_numpy(v, device) for v in np_params)
    return torch.from_numpy(np.array(np_params, copy=True)).to(device)


def params_to_numpy(params: Any) -> Any:
    """Tree of dicts, lists and tuples of tensors -> the same tree of
    numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to_numpy(v) for v in params)
    return params.detach().cpu().numpy()
