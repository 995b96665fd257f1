"""The event-driven sparse FC head (port of ``event_readout`` and
``drive_active_counts`` from ``repro.core.sparse_ffn``; the LM FFN
functions of that module are not ported).

The AEQ idea applied to the classification unit: the accumulated FC
drive (spike counts into the head) is mostly zeros, so its
top-``capacity`` entries per sample are the head's event queue.  They
are scattered back into a zero operand and the same product as the dense
head runs on it, so the logits equal the dense head's whenever the queue
covers every nonzero entry (size it with ``aeq.calibrate_capacity`` over
:func:`drive_active_counts`).
"""
from __future__ import annotations

import torch

from .scheduler import head_product


def event_readout(drive: torch.Tensor, weights: torch.Tensor, *,
                  capacity: int) -> torch.Tensor:
    """AEQ-compacted head product: drive (..., D) -> (..., n_classes).

    The queue keeps the ``capacity`` largest entries per sample.  Drives
    are integer counts, so ties are the rule; among equal entries the
    lower index is kept first, as ``jax.lax.top_k`` keeps it — a stable
    descending sort, where ``torch.topk`` promises no order among ties.
    """
    d = drive.shape[-1]
    if not 1 <= capacity <= d:
        raise ValueError(f"capacity={capacity} must be in [1, D={d}]")
    flat = drive.reshape(-1, d)
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    compact = torch.zeros_like(flat).scatter_(1, idx[:, :capacity],
                                              vals[:, :capacity])
    return head_product(compact.reshape(drive.shape), weights)


def drive_active_counts(drive: torch.Tensor) -> torch.Tensor:
    """Nonzero drive entries per sample — feed to
    ``aeq.calibrate_capacity`` to size :func:`event_readout`'s queue."""
    return (drive != 0).sum(dim=-1)
