"""Plain PyTorch version of the event-set builder: the composition the
scheduler ran before the kernel, unchanged (``aeq.build_aeq_batched``,
``aeq.segment_pad`` when ``event_par`` > 1, then the permutes into the
conv unit's launch layout)."""
from __future__ import annotations

import torch

from repro_torch.core.aeq import build_aeq_batched, segment_pad
from repro_torch.core.geometry import GEOM_3X3, ConvGeometry


def aeq_build_ref(spikes: torch.Tensor, capacity: int, event_par: int,
                  geometry: ConvGeometry = GEOM_3X3
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """spikes (B, T, H, W, C_in) -> (coords (T, C_in, B, cap_pad, 2)
    int32, valid (T, C_in, B, cap_pad) bool, count (T, B, C_in) int32),
    coords and valid contiguous."""
    queues = build_aeq_batched(spikes.permute(1, 0, 4, 2, 3), capacity,
                               geometry=geometry)
    if event_par > 1:
        queues = segment_pad(queues, event_par, geometry)
    return (queues.coords.permute(0, 2, 1, 3, 4).contiguous(),
            queues.valid.permute(0, 2, 1, 3).contiguous(), queues.count)
