"""Feed-forward blocks: SwiGLU / GELU MLP and capacity-bounded
Mixture-of-Experts (port of ``repro.models.ffn``).

The MoE dispatch reuses the paper's core primitive — compact the *active
set* into a fixed-capacity buffer and make compute scale with it: each
expert gathers the tokens routed to it into a ``capacity``-bounded buffer
(sort-free ranking via cumsum over the routing mask), computes one dense
(E, C, d) batch, and scatters back with the gate weights.

JAX's ``moe_forward_sharded`` (expert parallelism over a mesh) falls back
to :func:`moe_forward` without a mesh and no config selects it; it waits
for the port's sharding layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ParamSpec, clip


def mlp_specs(d_model: int, d_ff: int, gated: bool = True) -> dict:
    s = {
        "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp"), "scaled"),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed"), "scaled"),
    }
    if gated:
        s["w_gate"] = ParamSpec((d_model, d_ff), ("embed", "mlp"), "scaled")
    return s


def mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in p:  # SwiGLU
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:  # plain GELU MLP (granite-style); jax.nn.gelu is the tanh form
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


def moe_specs(d_model: int, d_ff: int, n_experts: int, n_shared: int = 0) -> dict:
    s = {
        "router": ParamSpec((d_model, n_experts), ("embed", "experts"), "scaled"),
        "we_gate": ParamSpec((n_experts, d_model, d_ff), ("experts", "embed", "expert_mlp"), "scaled"),
        "we_up": ParamSpec((n_experts, d_model, d_ff), ("experts", "embed", "expert_mlp"), "scaled"),
        "we_down": ParamSpec((n_experts, d_ff, d_model), ("experts", "expert_mlp", "embed"), "scaled"),
    }
    if n_shared:
        s["shared"] = mlp_specs(d_model, d_ff * n_shared)
    return s


def top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the ``k`` largest, the lower
    index first among ties (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(tokens: int, top_k: int, capacity_factor: float,
                 n_experts: int) -> int:
    """Slots per expert queue; Python's ``round`` (half to even), as JAX."""
    return int(max(1, round(tokens * top_k * capacity_factor / n_experts)))


def moe_forward(p: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
                router_softmax: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with per-expert capacity.

    x: (B, S, D).  Returns (out (B,S,D), aux_loss ()).

    Dispatch = the AEQ idea: per expert, rank the tokens routed to it with
    a cumsum over the routing mask (position-in-queue), drop overflow
    (capacity), gather into (E, C, D), batch-matmul, scatter-add back.
    JAX writes the queues with ``mode="drop"``; here dropped rows go to a
    spare slot ``capacity`` that is cut off before the expert products,
    so no row is filtered by a data-dependent shape (no host sync), and
    none clobbers a real slot.
    """
    b, s, d = x.shape
    n_experts = p["router"].shape[1]
    t = b * s
    xt = x.reshape(t, d)
    logits = (xt @ p["router"]).float()                       # (T, E)
    probs = torch.softmax(logits, dim=-1) if router_softmax else torch.sigmoid(logits)
    gate_vals, idx = top_k_stable(probs, top_k)               # (T, k)
    if router_softmax and top_k > 1:
        gate_vals = gate_vals / clip(gate_vals.sum(-1, keepdim=True), 1e-9)

    capacity = moe_capacity(t, top_k, capacity_factor, n_experts)
    # routing mask (T, k, E) -> position of each (token, slot) inside its
    # expert's queue, via exclusive cumsum over the flattened (T*k) order.
    onehot = F.one_hot(idx, n_experts).int()                  # (T, k, E)
    flat = onehot.reshape(t * top_k, n_experts)
    pos_in_expert = torch.cumsum(flat, dim=0) - flat          # exclusive
    pos_in_expert = (pos_in_expert * flat).sum(dim=1).reshape(t, top_k)
    keep = (pos_in_expert < capacity) & (onehot.sum(-1) > 0)

    expert_of = idx                                            # (T, k)
    slot = torch.where(keep, pos_in_expert, capacity).long()
    token_ids = torch.arange(t, device=x.device)[:, None].expand(t, top_k)
    buf = x.new_zeros((n_experts, capacity + 1, d))
    buf[expert_of, slot] = xt[token_ids]
    buf = buf[:, :capacity]

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["we_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["we_up"])
    out_buf = torch.einsum("ecf,efd->ecd", h, p["we_down"])   # (E, C, D)

    # scatter back with gate weights; a dropped row reads slot capacity-1
    # (JAX's gather clamps) and is weighted 0
    gathered = out_buf[expert_of, slot.clamp(max=capacity - 1)]  # (T, k, D)
    gathered = gathered * torch.where(keep, gate_vals, 0.0).to(x.dtype)[..., None]
    out = gathered.sum(dim=1).reshape(b, s, d)

    if "shared" in p:
        out = out + mlp_forward(p["shared"], x)

    # load-balancing aux loss (Switch/GShard form)
    me = probs.mean(dim=0)                                     # (E,)
    ce = flat.reshape(t, top_k, n_experts).sum(dim=(0, 1)) / max(t * top_k, 1)
    aux = n_experts * (me * ce).sum()
    return out, aux
