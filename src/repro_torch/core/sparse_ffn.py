"""The AEQ idea beyond the paper's network (port of
``repro.core.sparse_ffn``): the event-driven sparse FC head of the CSNN,
and the event-driven transformer FFN.

The FFN: for one token, h = relu(x @ W_up) is mostly zeros; its
top-``capacity`` activations (the token's event queue) select rows of
W_down, so work scales with the queue, not with d_ff.  The output equals
the dense ReLU MLP whenever the capacity covers every active unit
(:func:`active_counts` feeds ``aeq.calibrate_capacity``).

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
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec
from repro_torch.models.ffn import top_k_stable

from .scheduler import head_product


def sparse_ffn_specs(d_model: int, d_ff: int) -> dict:
    return {
        "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp"), "scaled"),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed"), "scaled"),
    }


def dense_relu_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Oracle: the plain dense ReLU MLP."""
    return F.relu(x @ p["w_up"]) @ p["w_down"]


def event_ffn(p: dict, x: torch.Tensor, *, capacity: int) -> torch.Tensor:
    """Event-driven FFN: per-token compaction of active hidden units.

    x: (..., d_model).  The top-``capacity`` hidden activations per token
    (its AEQ) select rows of W_down; everything below the queue is
    dropped, like events past the queue depth in the paper.
    """
    h = F.relu(x @ p["w_up"])                            # (..., d_ff)
    vals, idx = top_k_stable(h, capacity)               # the token's AEQ
    rows = p["w_down"][idx]                              # (..., k, d_model)
    return torch.einsum("...k,...kd->...d", vals, rows)


def active_counts(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Per-token active hidden units — feed to aeq.calibrate_capacity."""
    return (F.relu(x @ p["w_up"]) > 0).sum(dim=-1)


def event_ffn_flops(d_model: int, d_ff: int, capacity: int) -> tuple[float, float]:
    """(dense flops, event flops) per token — the napkin the paper makes."""
    dense = 2.0 * d_model * d_ff * 2
    event = 2.0 * d_model * d_ff + 2.0 * capacity * d_model
    return dense, event


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
    vals, idx = top_k_stable(flat, capacity)
    compact = torch.zeros_like(flat).scatter_(1, idx, vals)
    return head_product(compact.reshape(drive.shape), weights)


def drive_active_counts(drive: torch.Tensor) -> torch.Tensor:
    """Nonzero drive entries per sample — feed to
    ``aeq.calibrate_capacity`` to size :func:`event_readout`'s queue."""
    return (drive != 0).sum(dim=-1)
