"""Feed-forward blocks: SwiGLU / GELU MLP and capacity-bounded
Mixture-of-Experts (port of ``repro.models.ffn``).

The MoE dispatch reuses the paper's core primitive — compact the *active
set* into a fixed-capacity buffer and make compute scale with it: each
expert gathers the tokens routed to it into a ``capacity``-bounded buffer
(sort-free ranking via cumsum over the routing mask), computes one dense
(E, C, d) batch, and scatters back with the gate weights.

:func:`moe_forward_sharded` is the expert-parallel form over a mesh
(``cfg.moe_impl == "sharded"``); without a mesh it is :func:`moe_forward`.
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


def moe_forward_sharded(p: dict, x: torch.Tensor, *, top_k: int, n_experts: int,
                        capacity_factor: float = 1.25, router_softmax: bool = True,
                        mesh=None, expert_axis: str = "model",
                        batch_axes=("pod", "data")) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE: local-expert masked compaction per rank.

    Tokens are replicated over the expert (model) axis; each rank ranks
    ONLY the tokens routed to its own experts into queues of a capacity
    computed from its *local* token count, computes its expert batch, and
    the ranks' partial outputs are combined with one ``psum`` over the
    expert axis — the only collective of this layer besides the
    auxiliary loss's mean over the batch axes.

    x: (B, S, D) sharded batch-over-``batch_axes``; expert tensors sharded
    (expert_axis, None, None).  A DTensor ``x`` gives DTensors, a plain
    (global) one plain tensors.  Without a mesh (argument or the registered
    constraint mesh), without the expert axis, or with experts that do not
    split over it, this is :func:`moe_forward`.
    """
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.collectives import axis_index, psum, shard_map
    from repro_torch.sharding.specs import PartitionSpec as P
    from repro_torch.sharding.specs import constraint_mesh, mesh_shape
    if mesh is None:
        mesh = constraint_mesh()
    sizes = {} if mesh is None else mesh_shape(mesh)
    if expert_axis not in sizes or n_experts % sizes[expert_axis] != 0:
        return moe_forward(p, x, top_k=top_k, capacity_factor=capacity_factor,
                           router_softmax=router_softmax)
    e_loc = n_experts // sizes[expert_axis]
    d = x.shape[-1]
    baxes = tuple(a for a in batch_axes if a in sizes)

    def body(xb, router, we_gate, we_up, we_down):
        t = xb.shape[0] * xb.shape[1]
        xt = xb.reshape(t, d)
        logits = (xt @ router).float()                           # (T_loc, E)
        probs = torch.softmax(logits, -1) if router_softmax else torch.sigmoid(logits)
        gate_vals, idx = top_k_stable(probs, top_k)              # (T_loc, k)
        if router_softmax and top_k > 1:
            gate_vals = gate_vals / clip(gate_vals.sum(-1, keepdim=True), 1e-9)
        shard = axis_index(mesh, expert_axis)
        local = idx // e_loc == shard                            # (T_loc, k) mine?
        idx_loc = torch.where(local, idx % e_loc, e_loc)         # e_loc = drop slot
        capacity = moe_capacity(t, top_k, capacity_factor, n_experts)
        onehot = (idx_loc[..., None] == torch.arange(e_loc, device=xb.device)
                  ).int()                                        # (T, k, E_loc)
        flat = onehot.reshape(t * top_k, e_loc)
        pos = torch.cumsum(flat, dim=0) - flat
        pos = (pos.reshape(t, top_k, e_loc) * onehot).sum(-1)    # (T, k)
        keep = local & (pos < capacity)
        slot = torch.where(keep, pos, capacity).long()           # spare slot
        expert = torch.where(keep, idx_loc, e_loc).long()        # spare expert
        token_ids = torch.arange(t, device=xb.device)[:, None].expand(t, top_k)
        buf = xb.new_zeros((e_loc + 1, capacity + 1, d))
        buf[expert, slot] = xt[token_ids]
        buf = buf[:e_loc, :capacity]
        h = F.silu(torch.einsum("ecd,edf->ecf", buf, we_gate))
        h = h * torch.einsum("ecd,edf->ecf", buf, we_up)
        out_buf = torch.einsum("ecf,efd->ecd", h, we_down)
        gathered = out_buf[idx_loc.clamp(max=e_loc - 1).long(),
                           slot.clamp(max=capacity - 1)]
        gathered = gathered * torch.where(keep, gate_vals, 0.0).to(xb.dtype)[..., None]
        out = psum(gathered.sum(dim=1).reshape(xb.shape), mesh, expert_axis)
        # local aux estimate (router replicated; idx covers global experts)
        me = probs.mean(dim=0)
        ce = torch.zeros(n_experts, device=xb.device).index_add_(
            0, idx.reshape(-1), torch.ones(idx.numel(), device=xb.device)
        ) / max(t * top_k, 1)
        aux = n_experts * (me * ce).sum()
        n_b = 1
        for a in baxes:  # the mean of the per-shard estimates
            aux = psum(aux, mesh, a)
            n_b *= sizes[a]
        return out, aux / n_b

    bspec = P(baxes if baxes else None, None, None)
    espec = P(expert_axis, None, None)
    out, aux = shard_map(body, mesh=mesh,
                         in_specs=(bspec, P(), espec, espec, espec),
                         out_specs=(bspec, P()))(
        x, p["router"], p["we_gate"], p["we_up"], p["we_down"])
    if not isinstance(x, DTensor):  # global values in, global values out
        out, aux = out.full_tensor(), aux.full_tensor()
    if "shared" in p:
        out = out + mlp_forward(p["shared"], x)
    return out, aux
