"""Shared model machinery: parameter specs, norms, RoPE, losses (port of
``repro.models.common``).

Models are plain functions over parameter trees: nested dicts, lists and
tuples of tensors.  Every parameter leaf is declared by a ``ParamSpec``
carrying its shape, initializer and **logical axis names** (e.g.
("embed", "mlp")); the same spec tree yields

* real initialized tensors           (:func:`init_tree`, from a generator),
* ``meta``-device stand-ins           (:func:`abstract_tree`, no allocation),
* the logical axes of every leaf      (:func:`logical_axes_tree`).

Gradients: the training path takes autograd through these functions.
:func:`clip` is ``jnp.clip`` with its gradient (``Tensor.clamp`` passes
the whole gradient at a bound, JAX's splits it), and
:func:`chunked_softmax_ce` recomputes each chunk's logits in the backward
pass (``torch.utils.checkpoint``), as JAX's chunked scan does.

JAX's sharding hooks (``repro.sharding.specs.constrain``) are no-ops
without a mesh; the port has no mesh here and drops them.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]      # logical axis names, len == ndim
    init: str = "normal"                 # normal | zeros | ones | scaled
    scale: float = 1.0                   # stddev multiplier for "normal"/"scaled"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             f"in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree: Any, is_leaf: Callable = is_spec) -> Any:
    """``fn`` over the leaves of a tree of dicts, lists and tuples, the
    containers kept.  Dict keys are visited in sorted order, as
    ``jax.tree`` flattens them."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, is_leaf) for t in tree)
    return fn(tree)


def tree_leaves(tree: Any, is_leaf: Callable = is_spec) -> list:
    """The leaves of a tree, in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree, is_leaf)
    return out


def _init_leaf(spec: ParamSpec, generator: torch.Generator, device,
               dtype) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "scaled":  # fan-in scaled normal
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
    else:
        std = spec.scale * 0.02
    draw = torch.randn(spec.shape, generator=generator, dtype=dtype,
                       device=generator.device)
    return draw.mul_(std).to(device)


def init_tree(specs: Any, generator: torch.Generator, device="cuda",
              dtype=torch.float32) -> Any:
    """Materialize a spec tree into real parameter tensors on ``device``,
    drawn from ``generator`` (on its own device) leaf by leaf in the
    tree's order.  ``jax.random`` draws other numbers: parity tests take
    the JAX side's parameters through numpy instead."""
    return tree_map(lambda s: _init_leaf(s, generator, device, dtype), specs)


def abstract_tree(specs: Any, dtype=torch.bfloat16) -> Any:
    """Spec tree -> tree of ``meta`` tensors (shapes and dtypes only; no
    allocation: the dry-run path)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"),
                    specs)


def logical_axes_tree(specs: Any) -> Any:
    """Spec tree -> tree of logical-axis tuples (for sharding rules)."""
    return tree_map(lambda s: s.axes, specs)


def param_count(specs: Any) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


def stack_specs(spec_tree: Any, n: int, axis_name: Optional[str] = "layers") -> Any:
    """Prepend a stacking (layer) dimension to every leaf of a layer's specs."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.init, s.scale),
        spec_tree)


def tree_index(tree: Any, i: int) -> Any:
    """Leaf ``[i]`` of every tensor of a stacked tree: one layer's
    parameters (JAX scans over this leading axis)."""
    return tree_map(lambda t: t[i], tree, is_leaf=torch.is_tensor)


def tree_stack(trees: list) -> Any:
    """Inverse of :func:`tree_index`: stack same-structured trees on a new
    leading axis."""
    first = trees[0]
    if torch.is_tensor(first):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return type(first)(tree_stack([t[i] for t in trees])
                       for i in range(len(first)))


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    x32 = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * (1.0 + gamma.float())).to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * gamma + beta).to(dt)


def rope_frequencies(d_head: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections: tuple[int, ...],
                theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the head dim is split into sections that
    rotate with different position streams (temporal, height, width).

    x: (B, S, H, D); positions: (n_sections, B, S); sum(sections) == D//2.
    """
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)             # (D/2,)
    # searchsorted(cumsum((0,) + sections), i, side="right") - 1: the
    # count of section ends at or below frequency i, made on the device
    # (a boundary tensor from the host would be a blocking copy)
    freq = torch.arange(d // 2, device=positions.device)
    sec_id = torch.zeros_like(freq)
    for end in itertools.accumulate(sections):
        sec_id += freq >= end
    pos = positions[sec_id]                                  # (D/2, B, S)
    return _rotate(x, torch.movedim(pos, 0, -1).float() * freqs)


def clip(x: torch.Tensor, lo: Optional[float] = None,
         hi: Optional[float] = None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)``, whose
    backward splits the gradient half and half where ``x`` equals a bound,
    as JAX's does (``Tensor.clamp`` passes all of it there).  The forward
    values are ``clamp``'s."""
    if lo is not None:
        x = torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.full((), hi, dtype=x.dtype, device=x.device))
    return x


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The gold logit, by an iota compare and a sum (JAX's reduction)."""
    iota = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(iota == labels[..., None], logits, 0.0).sum(dim=-1)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy. logits: (B,S,V) or (N,V); labels int."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - _gold(logits, labels)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def _ce_chunk(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
              m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of :func:`chunked_softmax_ce`: (masked nll sum, mask sum)."""
    logits = (h @ w).float()                                 # (B, chunk, V)
    nll = (torch.logsumexp(logits, dim=-1) - _gold(logits, labels)) * m
    return nll.sum(), m.sum()


def chunked_softmax_ce(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Cross entropy without ever materializing the full (B, S, V) logits.

    hidden: (B, S, D) at the positions that predict ``labels`` (B, S);
    w: (D, V) output projection.  A loop over sequence chunks computes
    each chunk's logits, reduces them to (logz, gold) per token and frees
    them — bounding live logits memory to one chunk; under autograd each
    chunk is checkpointed, so the backward pass recomputes its logits
    instead of keeping every chunk's (B, chunk, V) float32 tensors (what
    keeps 262k-vocab training inside device memory).
    """
    b, s, d = hidden.shape
    # a sequence shorter than a chunk is one chunk of its own length (JAX
    # pads it to a whole chunk: masked rows, which add zeros)
    chunk = min(chunk, s)
    pad = -s % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    n = (s + pad) // chunk
    grad = torch.is_grad_enabled() and (hidden.requires_grad or w.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (hidden[:, sl], w, labels[:, sl], mask[:, sl])
        nll, m = (checkpoint(_ce_chunk, *args, use_reentrant=False) if grad
                  else _ce_chunk(*args))
        tot = tot + nll
        cnt = cnt + m
    return tot / torch.clamp(cnt, min=1.0)


def positions(b: int, s: int, device=None) -> torch.Tensor:
    """(b, s) int32 positions 0..s-1 of every sequence."""
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def causal_mask(s_q: int, s_k: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """(s_q, s_k) boolean mask; True = attend.  q position i sits at i+q_offset."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    return kj <= qi


def sliding_mask(s_q: int, s_k: int, window: int, q_offset: int = 0,
                 device=None) -> torch.Tensor:
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    return (kj <= qi) & (kj > qi - window)
