"""Chunked decay linear attention — shared core for Mamba2 (SSD) and RWKV6
(port of ``repro.models.linear_attn``).

Both architectures are linear RNNs over an outer-product state
S_t (d_k, d_v) with per-step, per-channel decay w_t in (0, 1]:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = q_t S_t                      (inclusive; Mamba2: q=C, k=B*dt, w=exp(dt*A))
    o_t = q_t S_{t-1} + (q_t*u . k_t) v_t   (exclusive+bonus; RWKV6: q=r, u=bonus)

The chunked algorithm processes the sequence in chunks of ``chunk``
steps: within a chunk, outputs come from a masked (T_c, T_c) "attention"
with per-channel decay factors folded into q~ and k~; across chunks the
state is carried by a loop (JAX's ``lax.scan``).  All state math is
float32, with JAX's padding and chunk sizes.

Numerical note: the per-channel path folds decays as q~ = q * exp(L_t)
and k~ = k * exp(-L_s), exact only while the in-chunk decay span stays
within float32 range, so callers choose chunk * max|log_w| < ~80 (RWKV6:
chunk=16).  Scalar-per-head decays (Mamba2/SSD) use
:func:`chunked_scalar`, which builds the (T, T) decay matrix from
pairwise differences (segsum) and is stable for any decay.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .common import clip

MAX_EXP = 80.0  # guard only; callers keep spans below this (see chunk sizes)
f32 = torch.float32


class LinAttnOut(NamedTuple):
    out: torch.Tensor    # (B, S, H, d_v)
    state: torch.Tensor  # (B, H, d_k, d_v) final state


def single_step(state, q_t, k_t, v_t, log_w_t, *, exclusive=False, u=None):
    """One decode step. state: (B,H,dk,dv) fp32; q_t/k_t/log_w_t: (B,H,dk); v_t: (B,H,dv)."""
    w = torch.exp(log_w_t.float())
    kv = torch.einsum("bhk,bhv->bhkv", k_t.float(), v_t.float())
    if exclusive:
        eff = state + u[None, :, :, None] * kv if u is not None else state
        o = torch.einsum("bhk,bhkv->bhv", q_t.float(), eff)
        state = w[..., None] * state + kv
    else:
        state = w[..., None] * state + kv
        o = torch.einsum("bhk,bhkv->bhv", q_t.float(), state)
    return state, o.to(v_t.dtype)


def recurrent_reference(q, k, v, log_w, *, state0=None, exclusive=False, u=None):
    """Exact step-by-step recurrence (oracle + decode path).

    q/k: (B,S,H,dk); v: (B,S,H,dv); log_w: (B,S,H,dk) (<= 0).
    u: (H, dk) bonus for the exclusive (RWKV) form.
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    st = (torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
          if state0 is None else state0.float())
    outs = []
    for t in range(s):
        st, ot = single_step(st, q[:, t], k[:, t], v[:, t], log_w[:, t],
                             exclusive=exclusive,
                             u=None if u is None else u.float())
        outs.append(ot.float())
    return LinAttnOut(torch.stack(outs, dim=1).to(v.dtype), st)


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (the sequence) at its end."""
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def chunked(q, k, v, log_w, *, chunk: int = 64, exclusive: bool = False,
            u: Optional[torch.Tensor] = None,
            state0: Optional[torch.Tensor] = None) -> LinAttnOut:
    """Chunk-parallel evaluation; matches :func:`recurrent_reference`.

    Shapes as in recurrent_reference; S is padded to a multiple of
    ``chunk`` (zero k/v and log_w=0 leave the state untouched; outputs
    cropped).  All state math in fp32.
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    pad = -s % chunk
    if pad:
        q, k, v, log_w = (_pad_seq(t, pad) for t in (q, k, v, log_w))
    n = (s + pad) // chunk
    st = (torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
          if state0 is None else state0.float())
    ti = torch.arange(chunk, device=q.device)
    mask = ti[:, None] > ti[None, :] if exclusive else ti[:, None] >= ti[None, :]
    outs = []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        qt, kt, vt, lw = (x[:, sl].float() for x in (q, k, v, log_w))  # (B,T,H,*)
        lcum = torch.cumsum(lw, dim=1)                   # inclusive L_t
        lprev = lcum - lw                                # exclusive L_{t-1}
        l_end = lcum[:, -1:]                             # (B,1,H,dk)
        l_q = lprev if exclusive else lcum               # decay seen by q_t
        q_in = qt * torch.exp(l_q)                       # <= 1
        k_dec = kt * torch.exp(clip(-lcum, hi=MAX_EXP))
        # intra-chunk "attention": scores (B,H,T,T) strictly causal
        scores = torch.einsum("bthk,bshk->bhts", q_in, k_dec)
        scores = torch.where(mask[None, None], scores, 0.0)
        o_intra = torch.einsum("bhts,bshv->bthv", scores, vt)
        if exclusive and u is not None:  # current-token bonus term
            diag = torch.einsum("bthk,hk,bthk->bth", qt, u.float(), kt)
            o_intra = o_intra + diag[..., None] * vt
        # inter-chunk: contribution of the carried state
        o_inter = torch.einsum("bthk,bhkv->bthv", q_in, st)
        # state update to chunk end
        k_end = kt * torch.exp(l_end - lcum)             # decay s -> chunk end
        st = torch.exp(l_end[:, 0])[..., None] * st + torch.einsum(
            "bshk,bshv->bhkv", k_end, vt)
        outs.append(o_intra + o_inter)
    out = torch.cat(outs, dim=1)[:, :s].to(v.dtype)
    return LinAttnOut(out, st)


def chunked_scalar(q, k, v, log_w, *, chunk: int = 64,
                   state0: Optional[torch.Tensor] = None) -> LinAttnOut:
    """Chunked linear attention for scalar-per-head decay (Mamba2 / SSD).

    q/k: (B,S,H,dk); v: (B,S,H,dv); log_w: (B,S,H) (<= 0, any magnitude).
    Inclusive form (o_t sees its own k_t v_t).  The intra-chunk decay
    matrix is exp(segsum) of pairwise differences, always <= 1 — stable.
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    pad = -s % chunk
    if pad:
        q, k, v, log_w = (_pad_seq(t, pad) for t in (q, k, v, log_w))
    n = (s + pad) // chunk
    st = (torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
          if state0 is None else state0.float())
    ti = torch.arange(chunk, device=q.device)
    causal = ti[:, None] >= ti[None, :]
    outs = []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        qt, kt, vt, lw = (x[:, sl].float() for x in (q, k, v, log_w))
        lcum = torch.cumsum(lw, dim=1)                    # (B,T,H) inclusive
        l_end = lcum[:, -1, :]                            # (B,H)
        # decay matrix L[t,s] = exp(L_t - L_s), t >= s — differences first
        diff = lcum[:, :, None, :] - lcum[:, None, :, :]  # (B,T,S,H)
        decay = torch.exp(torch.where(causal[None, :, :, None], diff, -torch.inf))
        qk = torch.einsum("bthk,bshk->bhts", qt, kt)
        o_intra = torch.einsum("bhts,btsh,bshv->bthv", qk, decay, vt)
        o_inter = torch.einsum("bthk,bth,bhkv->bthv", qt, torch.exp(lcum), st)
        k_end = kt * torch.exp(l_end[:, None, :] - lcum)[..., None]
        st = torch.exp(l_end)[..., None, None] * st + torch.einsum(
            "bshk,bshv->bhkv", k_end, vt)
        outs.append(o_intra + o_inter)
    out = torch.cat(outs, dim=1)[:, :s].to(v.dtype)
    return LinAttnOut(out, st)
