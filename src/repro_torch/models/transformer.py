"""Generic decoder assembly for all decoder-only architectures (port of
``repro.models.transformer``).

A config is compiled into a **layer plan**: a short list of *groups*,
each a repeating unit of layer descriptors run ``reps`` times with
stacked parameters (JAX scans them; the port loops over the leading
index).  The plan covers:

* dense GQA/MQA decoders (stablelm, granite, phi3)
* 5:1 local:global sliding-window patterns (gemma3)
* interleaved / leading-dense MoE (llama4-maverick, deepseek-v2)
* MLA attention (deepseek-v2)
* Mamba2 stacks with a weight-shared attention block every N layers
  (zamba2) — shared weights, per-application KV caches
* RWKV6 (attention-free)
* M-RoPE + stub vision frontend (qwen2-vl)

Three entry points per model: ``loss_fn`` (the training loss; autograd
gives its gradient, ``train.loop``), ``prefill`` (full seq -> cache +
last logits), ``decode_step`` (one token against the cache, which it
updates in place).  ``pos`` is a Python int throughout.

Recomputation, as JAX's: in the training phase with ``cfg.remat`` each
repetition of a stacked group's unit (JAX's scan body) is checkpointed
(``torch.utils.checkpoint``), so the backward pass keeps one activation
per repetition and recomputes the rest; a group run once is not.  The
recomputed values are the forward's, so the gradients equal those of a
run without it.

Under a registered mesh the hidden states are pinned to ("batch", "seq",
None) on entry and after each repetition of a stacked unit
(``sharding.specs.constrain``, JAX's constraint sites).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.specs import constrain
from . import attention as attn
from . import ffn as ffn_lib
from . import rwkv as rwkv_lib
from . import ssm as ssm_lib
from .common import (ParamSpec, chunked_softmax_ce, positions, rms_norm,
                     stack_specs, tree_index, tree_stack)

# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    kind: str                      # attn | mamba | rwkv
    window: Optional[int] = None   # sliding window (attn)
    ffn: str = "mlp"               # mlp | moe | none
    d_ff: Optional[int] = None
    shared: bool = False           # params come from the shared block (zamba)


@dataclasses.dataclass(frozen=True)
class Group:
    descs: tuple
    reps: int


def build_plan(cfg: ArchConfig) -> list[Group]:
    f = cfg.family
    if f in ("dense", "vlm"):
        if cfg.global_every:
            loc = LayerDesc("attn", window=cfg.sliding_window)
            glb = LayerDesc("attn")
            unit = (loc,) * (cfg.global_every - 1) + (glb,)
            reps, rem = divmod(cfg.n_layers, cfg.global_every)
            groups = [Group(unit, reps)]
            if rem:
                groups.append(Group((loc,) * rem, 1))
            return groups
        return [Group((LayerDesc("attn"),), cfg.n_layers)]
    if f == "moe":
        groups = []
        if cfg.n_dense_layers:
            groups.append(Group((LayerDesc("attn", d_ff=cfg.dense_d_ff or cfg.d_ff),),
                                cfg.n_dense_layers))
        n_rest = cfg.n_layers - cfg.n_dense_layers
        if cfg.moe_every == 1:
            groups.append(Group((LayerDesc("attn", ffn="moe"),), n_rest))
        else:
            unit = tuple(
                LayerDesc("attn", ffn="moe") if j == cfg.moe_every - 1
                else LayerDesc("attn", d_ff=cfg.dense_d_ff or cfg.d_ff)
                for j in range(cfg.moe_every))
            reps, rem = divmod(n_rest, cfg.moe_every)
            groups.append(Group(unit, reps))
            if rem:
                groups.append(Group(
                    (LayerDesc("attn", d_ff=cfg.dense_d_ff or cfg.d_ff),) * rem, 1))
        return groups
    if f == "rwkv":
        return [Group((LayerDesc("rwkv", ffn="none"),), cfg.n_layers)]
    if f == "hybrid":
        m = LayerDesc("mamba", ffn="none")
        s = LayerDesc("attn", shared=True)
        n = cfg.shared_attn_every
        reps, rem = divmod(cfg.n_layers, n)
        groups = [Group((m,) * n + (s,), reps)]
        if rem:
            groups.append(Group((m,) * rem, 1))
        return groups
    raise ValueError(f"unknown family {f}")


# ---------------------------------------------------------------------------
# Per-desc specs
# ---------------------------------------------------------------------------


def _rwkv_dims(cfg: ArchConfig) -> rwkv_lib.RWKVDims:
    return rwkv_lib.RWKVDims.make(cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim)


def _ssm_dims(cfg: ArchConfig) -> ssm_lib.SSMDims:
    return ssm_lib.SSMDims.make(cfg.d_model, cfg.ssm_state, cfg.ssm_expand,
                                cfg.ssm_head_dim, cfg.ssm_conv)


def _attn_specs(cfg: ArchConfig) -> dict:
    if cfg.use_mla:
        return attn.mla_specs(cfg.d_model, cfg.n_heads, q_lora=cfg.q_lora,
                              kv_lora=cfg.kv_lora, qk_nope=cfg.qk_nope,
                              qk_rope=cfg.qk_rope, v_dim=cfg.v_head_dim)
    return attn.gqa_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.use_qk_norm)


def desc_specs(desc: LayerDesc, cfg: ArchConfig) -> dict:
    if desc.kind == "rwkv":
        dims = _rwkv_dims(cfg)
        return {"ln1": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
                "tm": rwkv_lib.rwkv6_time_mix_specs(dims),
                "ln2": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
                "cm": rwkv_lib.rwkv6_channel_mix_specs(dims)}
    if desc.kind == "mamba":
        return {"ln": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
                "mamba": ssm_lib.mamba2_specs(_ssm_dims(cfg))}
    s = {"ln1": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
         "attn": _attn_specs(cfg),
         "ln2": ParamSpec((cfg.d_model,), ("embed",), "zeros")}
    if desc.ffn == "moe":
        s["ffn"] = ffn_lib.moe_specs(cfg.d_model, cfg.d_ff_expert or cfg.d_ff,
                                     cfg.n_experts, cfg.n_shared_experts)
    elif desc.ffn == "mlp":
        s["ffn"] = ffn_lib.mlp_specs(cfg.d_model, desc.d_ff or cfg.d_ff,
                                     gated=cfg.gated_mlp)
    return s


def build_param_specs(cfg: ArchConfig) -> dict:
    plan = build_plan(cfg)
    specs: dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed")),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"), "scaled")
    groups = []
    for g in plan:
        per_desc = tuple(
            {} if d.shared else
            (desc_specs(d, cfg) if g.reps == 1 else stack_specs(desc_specs(d, cfg), g.reps))
            for d in g.descs)
        groups.append(per_desc)
    specs["groups"] = groups
    if any(d.shared for g in plan for d in g.descs):
        specs["shared_attn"] = desc_specs(LayerDesc("attn", d_ff=cfg.d_ff), cfg)
    return specs


def _layers(params: dict, plan: list[Group]):
    """(group index, rep, desc index, desc, the layer's parameters) in
    execution order: a group's unit ``reps`` times, its stacked
    parameters indexed per rep, zamba's shared block reused in every
    repetition."""
    for gi, g in enumerate(plan):
        gp = params["groups"][gi]
        for r in range(g.reps):
            for di, d in enumerate(g.descs):
                if d.shared:
                    p = params["shared_attn"]
                else:
                    p = gp[di] if g.reps == 1 else tree_index(gp[di], r)
                yield gi, r, di, d, p


# ---------------------------------------------------------------------------
# Context & positions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Ctx:
    cfg: ArchConfig
    positions: torch.Tensor                         # (B, S)
    mrope_positions: Optional[torch.Tensor] = None  # (3, B, S)
    phase: str = "train"                            # train | prefill | decode


def _mrope_ids(cfg: ArchConfig, batch: int, n_vis: int, s_text: int,
               device=None) -> torch.Tensor:
    g = cfg.vision_grid
    vi = torch.arange(n_vis, device=device)
    vis = torch.stack([torch.zeros_like(vi), vi // g, vi % g])        # (3, Nv)
    start = (n_vis + g - 1) // g + 1
    ti = start + torch.arange(s_text, device=device)
    txt = torch.stack([ti, ti, ti])                                   # (3, St)
    ids = torch.cat([vis, txt], dim=1)                                # (3, S)
    return ids[:, None, :].expand(3, batch, n_vis + s_text)


# ---------------------------------------------------------------------------
# Layer application — full sequence (train / prefill without cache)
# ---------------------------------------------------------------------------


def _attention(desc: LayerDesc, p: dict, h: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    cfg = ctx.cfg
    if cfg.use_mla:
        return attn.mla_forward(p, h, positions=ctx.positions,
                                rope_theta=cfg.rope_theta, qk_nope=cfg.qk_nope,
                                qk_rope=cfg.qk_rope)
    return attn.gqa_forward(p, h, positions=ctx.positions,
                            rope_theta=cfg.rope_theta, window=desc.window,
                            mrope_sections=cfg.mrope_sections,
                            mrope_positions=ctx.mrope_positions)


def _ffn(desc: LayerDesc, p: dict, x: torch.Tensor, cfg: ArchConfig):
    """x + the layer's FFN of rms_norm(x, ln2) -> (x, aux loss or None)."""
    h = rms_norm(x, p["ln2"])
    if desc.ffn == "moe" and cfg.moe_impl == "sharded":
        out, aux = ffn_lib.moe_forward_sharded(
            p["ffn"], h, top_k=cfg.top_k, n_experts=cfg.n_experts,
            capacity_factor=cfg.capacity_factor,
            router_softmax=cfg.router_softmax)
        return x + out, aux
    if desc.ffn == "moe":
        out, aux = ffn_lib.moe_forward(p["ffn"], h, top_k=cfg.top_k,
                                       capacity_factor=cfg.capacity_factor,
                                       router_softmax=cfg.router_softmax)
        return x + out, aux
    if desc.ffn == "mlp":
        return x + ffn_lib.mlp_forward(p["ffn"], h), None
    return x, None


def apply_layer(desc: LayerDesc, p: dict, x: torch.Tensor, ctx: Ctx):
    """Returns (x, aux_loss)."""
    cfg = ctx.cfg
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if desc.kind == "rwkv":
        x = x + rwkv_lib.time_mix_forward(p["tm"], rms_norm(x, p["ln1"]), _rwkv_dims(cfg))
        x = x + rwkv_lib.channel_mix_forward(p["cm"], rms_norm(x, p["ln2"]))
        return x, aux
    if desc.kind == "mamba":
        x = x + ssm_lib.mamba2_forward(p["mamba"], rms_norm(x, p["ln"]), _ssm_dims(cfg))
        return x, aux
    x = x + _attention(desc, p["attn"], rms_norm(x, p["ln1"]), ctx)
    x, moe_aux = _ffn(desc, p, x, cfg)
    return x, aux if moe_aux is None else moe_aux


def _unit(descs: tuple, ps: list, x: torch.Tensor, aux: torch.Tensor,
          ctx: Ctx):
    """One repetition of a group's unit (JAX's scan body) -> (x, aux)."""
    for d, p in zip(descs, ps):
        x, a = apply_layer(d, p, x, ctx)
        aux = aux + a
    return x, aux


def forward(params: dict, x: torch.Tensor, cfg: ArchConfig, ctx: Ctx):
    """Run all groups; returns (hidden (B,S,D), total aux loss)."""
    x = constrain(x, ("batch", "seq", None))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, g in enumerate(build_plan(cfg)):
        gp = params["groups"][gi]
        remat = (cfg.remat and ctx.phase == "train" and g.reps > 1
                 and torch.is_grad_enabled())
        for r in range(g.reps):
            ps = [params["shared_attn"] if d.shared else
                  (gp[di] if g.reps == 1 else tree_index(gp[di], r))
                  for di, d in enumerate(g.descs)]
            if remat:
                x, aux_total = checkpoint(_unit, g.descs, ps, x, aux_total, ctx,
                                          use_reentrant=False)
            else:
                x, aux_total = _unit(g.descs, ps, x, aux_total, ctx)
            if g.reps > 1:  # JAX's constraint at the end of its scan body
                x = constrain(x, ("batch", "seq", None))
    return rms_norm(x, params["final_norm"]), aux_total


def logits_of(params: dict, hidden: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return hidden @ params["embed"].T
    return hidden @ params["lm_head"]


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.tie_embeddings:  # gemma-style scaling: sqrt(d_model) in float32,
        # then in the activation dtype (a CPU scalar tensor: no copy)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# Train / prefill / decode entry points
# ---------------------------------------------------------------------------


def _embed_prompt(params: dict, batch: dict, cfg: ArchConfig):
    """Token (and, for the VLM, vision-prefix) embeddings -> (x, mrope ids)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    mrope = None
    if cfg.family == "vlm":
        vis = batch["vision_embeds"].to(x.dtype)
        x = torch.cat([vis, x], dim=1)
        mrope = _mrope_ids(cfg, b, vis.shape[1], s, x.device)
    return x, mrope


def loss_fn(params: dict, batch: dict, cfg: ArchConfig):
    """Next-token cross entropy (+ the MoE aux loss) -> (total, metrics)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x, mrope = _embed_prompt(params, batch, cfg)
    ctx = Ctx(cfg, positions(b, x.shape[1], x.device), mrope, phase="train")
    hidden, aux = forward(params, x, cfg, ctx)
    if cfg.family == "vlm":
        hidden = hidden[:, -s:, :]
    labels = batch["labels"]
    mask = (labels >= 0).float()
    w_out = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    # positions 0..S-2 predict labels 1..S-1; chunked CE never materializes
    # the full (B, S, V) logits
    ce = chunked_softmax_ce(hidden[:, :-1], w_out, torch.clamp(labels[:, 1:], min=0),
                            mask[:, 1:])
    total = ce + cfg.aux_loss_coef * aux
    return total, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# KV / state caches
# ---------------------------------------------------------------------------


def _desc_cache_layout(desc: LayerDesc, cfg: ArchConfig, batch: int, max_seq: int,
                       dtype=torch.bfloat16) -> dict:
    """name -> (shape-without-reps, logical axes, dtype)."""
    if desc.kind == "rwkv":
        dims = _rwkv_dims(cfg)
        return {
            "wkv": ((batch, dims.n_heads, dims.head_dim, dims.head_dim),
                    ("batch", "heads", None, None), torch.float32),
            "shift_tm": ((batch, cfg.d_model), ("batch", "embed"), dtype),
            "shift_cm": ((batch, cfg.d_model), ("batch", "embed"), dtype),
        }
    if desc.kind == "mamba":
        dims = _ssm_dims(cfg)
        return {
            "ssm": ((batch, dims.n_heads, dims.d_state, dims.head_dim),
                    ("batch", "heads", None, None), torch.float32),
            "conv": ((batch, dims.conv_w - 1, dims.conv_dim),
                     ("batch", None, "mlp"), dtype),
        }
    if cfg.use_mla:
        return {
            "c_kv": ((batch, max_seq, cfg.kv_lora),
                     ("batch", "cache_seq", "kv_lora"), dtype),
            "k_rope": ((batch, max_seq, cfg.qk_rope),
                       ("batch", "cache_seq", None), dtype),
        }
    slots = min(desc.window, max_seq) if desc.window else max_seq
    lay = {
        "k": ((batch, slots, cfg.n_kv_heads, cfg.head_dim),
              ("batch", "cache_seq", "kv_heads", "head_dim"), dtype),
        "v": ((batch, slots, cfg.n_kv_heads, cfg.head_dim),
              ("batch", "cache_seq", "kv_heads", "head_dim"), dtype),
    }
    if desc.window:
        lay["slot_pos"] = ((slots,), ("cache_seq",), torch.int32)
    return lay


def cache_structure(cfg: ArchConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                    abstract: bool = True, device="cuda"):
    """Returns (cache tree, logical-axes tree) for the whole model; the
    cache's tensors are on the ``meta`` device when ``abstract``, zeros on
    ``device`` otherwise."""
    caches, axes = [], []
    for g in build_plan(cfg):
        g_cache, g_axes = [], []
        for d in g.descs:
            layout = _desc_cache_layout(d, cfg, batch, max_seq, dtype)
            c, a = {}, {}
            for name, (shape, ax, dt) in layout.items():
                full = (g.reps,) + shape if g.reps > 1 else shape
                c[name] = torch.zeros(full, dtype=dt,
                                      device="meta" if abstract else device)
                a[name] = (("layers",) + ax) if g.reps > 1 else ax
            g_cache.append(c)
            g_axes.append(a)
        caches.append(tuple(g_cache))
        axes.append(tuple(g_axes))
    return {"groups": caches}, {"groups": axes}


# ---------------------------------------------------------------------------
# Prefill (full sequence -> cache) and decode (single token)
# ---------------------------------------------------------------------------


def _fill_layer(desc: LayerDesc, p: dict, x: torch.Tensor, ctx: Ctx, max_seq: int,
                cache_dtype=torch.bfloat16):
    """Full-seq layer application that also emits this layer's cache."""
    cfg = ctx.cfg
    if desc.kind == "rwkv":
        h1 = rms_norm(x, p["ln1"])
        out, st = rwkv_lib.time_mix_prefill(p["tm"], h1, _rwkv_dims(cfg), chunk=16)
        x = x + out
        h2 = rms_norm(x, p["ln2"])
        x = x + rwkv_lib.channel_mix_forward(p["cm"], h2)
        cache = {"wkv": st, "shift_tm": h1[:, -1, :].to(cache_dtype),
                 "shift_cm": h2[:, -1, :].to(cache_dtype)}
        return x, cache
    if desc.kind == "mamba":
        out, st, conv = ssm_lib.mamba2_prefill(p["mamba"], rms_norm(x, p["ln"]),
                                               _ssm_dims(cfg))
        return x + out, {"ssm": st, "conv": conv.to(cache_dtype)}
    h = rms_norm(x, p["ln1"])
    if cfg.use_mla:
        a, cache = attn.mla_fill_cache(p["attn"], h, positions=ctx.positions,
                                       rope_theta=cfg.rope_theta, qk_nope=cfg.qk_nope,
                                       qk_rope=cfg.qk_rope, max_seq=max_seq)
    else:
        a, cache = attn.gqa_fill_cache(p["attn"], h, positions=ctx.positions,
                                       rope_theta=cfg.rope_theta, window=desc.window,
                                       max_seq=max_seq,
                                       mrope_sections=cfg.mrope_sections,
                                       mrope_positions=ctx.mrope_positions)
    cache = {k: t if t.dtype == torch.int32 else t.to(cache_dtype)
             for k, t in cache.items()}
    x, _ = _ffn(desc, p, x + a, cfg)
    return x, cache


def _group_caches(plan: list[Group], per_layer: dict) -> list:
    """Per-layer caches keyed (group, rep, desc) -> JAX's layout: per
    group a tuple over descs, each stacked over reps when reps > 1."""
    out = []
    for gi, g in enumerate(plan):
        out.append(tuple(
            per_layer[gi, 0, di] if g.reps == 1 else
            tree_stack([per_layer[gi, r, di] for r in range(g.reps)])
            for di in range(len(g.descs))))
    return out


def prefill(params: dict, batch: dict, cfg: ArchConfig, max_seq: int,
            cache_dtype=torch.bfloat16):
    """Full-sequence forward emitting the KV/state cache.

    Returns (last-token logits (B, V), cache tree).
    """
    x, mrope = _embed_prompt(params, batch, cfg)
    ctx = Ctx(cfg, positions(x.shape[0], x.shape[1], x.device), mrope,
              phase="prefill")
    plan = build_plan(cfg)
    per_layer = {}
    for gi, r, di, d, p in _layers(params, plan):
        x, per_layer[gi, r, di] = _fill_layer(d, p, x, ctx, max_seq, cache_dtype)
    hidden = rms_norm(x, params["final_norm"])
    logits = logits_of(params, hidden[:, -1:, :], cfg)[:, 0, :]
    return logits, {"groups": _group_caches(plan, per_layer)}


def _decode_layer(desc: LayerDesc, p: dict, c: dict, x: torch.Tensor, pos: int,
                  ctx: Ctx) -> torch.Tensor:
    """One layer of one decode step; writes the layer's cache ``c`` in
    place (for a stacked group ``c`` is a view of the stacked tensors)."""
    cfg = ctx.cfg
    if desc.kind == "rwkv":
        dims = _rwkv_dims(cfg)
        h1 = rms_norm(x, p["ln1"])
        out, wkv, sh_tm = rwkv_lib.time_mix_decode(
            p["tm"], h1, c["wkv"], c["shift_tm"].to(h1.dtype), dims)
        x = x + out
        h2 = rms_norm(x, p["ln2"])
        out2, sh_cm = rwkv_lib.channel_mix_decode(p["cm"], h2,
                                                  c["shift_cm"].to(h2.dtype))
        c["wkv"].copy_(wkv)
        c["shift_tm"].copy_(sh_tm)
        c["shift_cm"].copy_(sh_cm)
        return x + out2
    if desc.kind == "mamba":
        h = rms_norm(x, p["ln"])
        out, st = ssm_lib.mamba2_decode(
            p["mamba"], h, {"ssm": c["ssm"], "conv": c["conv"].to(h.dtype)},
            _ssm_dims(cfg))
        c["ssm"].copy_(st["ssm"])
        c["conv"].copy_(st["conv"])
        return x + out
    h = rms_norm(x, p["ln1"])
    if cfg.use_mla:
        a, _ = attn.mla_decode(p["attn"], h, c, pos, rope_theta=cfg.rope_theta,
                               qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope)
    else:
        a, _ = attn.gqa_decode(p["attn"], h, c, pos, rope_theta=cfg.rope_theta,
                               window=desc.window,
                               mrope_sections=cfg.mrope_sections,
                               mrope_positions=ctx.mrope_positions)
    x, _ = _ffn(desc, p, x + a, cfg)
    return x


def decode_step(params: dict, cache: dict, batch: dict, cfg: ArchConfig):
    """One decode step. batch: {"tokens": (B,1), "pos": int} -> (logits,
    cache).  The cache is updated in place and returned."""
    tokens = batch["tokens"]
    pos = int(batch["pos"])
    b = tokens.shape[0]
    x = embed_tokens(params, tokens, cfg)
    pos_ids = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    mrope = None
    if cfg.family == "vlm":
        # `pos` counts concat-space slots; map the text index into mrope space
        start = (cfg.n_vision_tokens + cfg.vision_grid - 1) // cfg.vision_grid + 1
        mrope = torch.full((3, b, 1), pos - cfg.n_vision_tokens + start,
                           dtype=torch.int32, device=x.device)
    ctx = Ctx(cfg, pos_ids, mrope, phase="decode")
    plan = build_plan(cfg)
    for gi, r, di, d, p in _layers(params, plan):
        gc = cache["groups"][gi][di]
        c = gc if plan[gi].reps == 1 else tree_index(gc, r)
        x = _decode_layer(d, p, c, x, pos, ctx)
    hidden = rms_norm(x, params["final_norm"])
    logits = logits_of(params, hidden, cfg)[:, 0, :]
    return logits, cache
