"""The devices a batch is sharded over (port of
``repro.sharding.specs.batch_mesh``).

JAX builds a 1-D ``Mesh`` over its local devices; the port's counterpart
is a plain list of ``torch.device``s, one per shard, which
``core.csnn.snn_apply_sharded`` takes as ``devices=``.  A device may
appear more than once: its shards then run on streams of their own.
"""
from __future__ import annotations

from typing import Optional

import torch


def batch_devices(n_devices: Optional[int] = None) -> list[torch.device]:
    """The first ``n_devices`` visible CUDA devices (all of them when
    None).  Raises when CUDA is absent or fewer devices exist than asked
    for: there is no CPU fallback (pass CPU devices explicitly)."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0:
        raise RuntimeError("batch_devices: no CUDA device is visible; pass "
                           "devices= explicitly to run on the CPU")
    n = have if n_devices is None else n_devices
    if not 1 <= n <= have:
        raise ValueError(f"requested {n_devices} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]
