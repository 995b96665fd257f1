"""AdamW on trees of tensors (port of ``repro.train.optimizer``): the
CSNN's dicts (``core.conversion.fit_ann``) and the LMs' dicts of lists of
tuples (``train.loop``).

A plain update on tensors rather than ``torch.optim.AdamW`` plus a
scheduler, so that the eps placement, the bias corrections, the global
norm clip and the cosine floor are JAX's.  The step is a host integer
and the schedule host float32 arithmetic, as JAX's jitted update
computes it (:func:`lr_at`); every division of a tensor is by a 0-dim
float32 tensor on its device.  Leaves are visited in ``jax.tree.leaves``
order: dict keys sorted, lists and tuples in order.

``moment_dtype=torch.bfloat16`` keeps the moments in bfloat16 (the
float32 master parameters stay in ``params``); the clip's norm is
float32 whatever the parameters' dtype.  :func:`state_logical_axes`
gives the state the parameters' sharding (ZeRO via the fsdp axis: the
update is elementwise).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.quantization import f32_scalar
from repro_torch.core.xla_arith import fma_f32, reciprocal_f32


@dataclasses.dataclass
class TrainState:
    step: int

    params: Any
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: torch.dtype = torch.float32
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples of tensors
    (all of one structure), the containers kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any, is_leaf: Optional[Callable] = None) -> list:
    """The leaves in ``jax.tree.leaves`` order: dict keys sorted, lists
    and tuples in order; a node for which ``is_leaf`` holds is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [tree]


def tree_unflatten(tree: Any, leaves: list) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    out = _rebuild(tree, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _rebuild(tree: Any, it) -> Any:
    if isinstance(tree, dict):
        got = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: got[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    return next(it)


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup, then cosine decay to ``min_lr_frac``: the float32
    value of JAX's jitted ``lr_at`` (``core.xla_arith``: the divisions by
    the warmup and decay lengths are multiplications by their float32
    reciprocals, and ``(1 + cos) * 0.45 + 0.1`` one multiply-add).  The
    cosine is float64 ``math.cos`` rounded to float32: correctly rounded,
    where XLA calls the C library's ``cosf``, which is 1 ulp off on about
    1 % of arguments."""
    f = np.float32
    s = f(int(step))
    if s < cfg.warmup_steps:
        frac = s * reciprocal_f32(max(cfg.warmup_steps, 1))
    else:
        span = reciprocal_f32(max(cfg.total_steps - cfg.warmup_steps, 1))
        prog = min(max((s - f(cfg.warmup_steps)) * span, f(0)), f(1))
        cos = f(math.cos(float(prog * f(math.pi))))
        frac = fma_f32(cos + f(1), f((1 - cfg.min_lr_frac) * 0.5),
                       f(cfg.min_lr_frac))
    return float(frac * f(cfg.lr))


def init_state(params: Any, cfg: AdamWConfig) -> TrainState:
    """Step 0 and zero moments in ``cfg.moment_dtype`` beside ``params``."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    return TrainState(step=0, params=params, mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


def abstract_state(abstract_params: Any, cfg: AdamWConfig) -> TrainState:
    """A ``TrainState`` of ``meta`` tensors (shapes and dtypes, no
    memory): the template :func:`repro_torch.checkpoint.ckpt.restore`
    fills.  ``abstract_params`` is a tree of (meta) tensors, e.g.
    ``Model.abstract_params(torch.float32)``."""
    meta = lambda p: torch.empty(p.shape, dtype=cfg.moment_dtype,
                                 device="meta")
    params = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                            device="meta"), abstract_params)
    return TrainState(step=0, params=params, mu=tree_map(meta, params),
                      nu=tree_map(meta, params))


def state_logical_axes(param_axes: Any) -> TrainState:
    """Optimizer state shards exactly like the parameters."""
    return TrainState(step=(), params=param_axes, mu=param_axes, nu=param_axes)


def global_norm(tree: Any) -> torch.Tensor:
    sums = [x.to(torch.float32).square().sum() for x in tree_leaves(tree)]
    return torch.stack(sums).sum().sqrt()


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    dev = norm.device
    scale = torch.minimum(
        f32_scalar(1.0, dev),
        f32_scalar(max_norm, dev) / torch.maximum(norm, f32_scalar(1e-9, dev)))
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


@torch.no_grad()
def adamw_update(state: TrainState, grads: Any,
                 cfg: AdamWConfig) -> TrainState:
    """One AdamW step: clip by global norm, moments, bias-corrected
    update with the eps outside the square root and decoupled decay."""
    if cfg.clip_norm is not None:
        grads, _ = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = lr_at(cfg, step)
    f32 = torch.float32
    # float32 bias corrections, as divisors on the moments' device
    b1c, b2c = (np.float32(1) - np.float32(b) ** np.float32(step)
                for b in (cfg.b1, cfg.b2))
    # JAX's expressions, each operation rounded as there; the in-place
    # operations only reuse temporaries this update made (a pass over a
    # 1 B-parameter tree costs a fresh 4 GB tensor)
    mu = tree_map(lambda m, g: (cfg.b1 * m.to(f32)).add_(
        (1 - cfg.b1) * g.to(f32)).to(cfg.moment_dtype), state.mu, grads)
    nu = tree_map(lambda v, g: (cfg.b2 * v.to(f32)).add_(
        g.to(f32).square().mul_(1 - cfg.b2)).to(cfg.moment_dtype),
        state.nu, grads)

    def upd(p, m, v):
        mhat = m.to(f32) / f32_scalar(b1c, m.device)
        den = (v.to(f32) / f32_scalar(b2c, v.device)).sqrt_().add_(cfg.eps)
        delta = mhat.div_(den).add_(cfg.weight_decay * p.to(f32))
        return (p.to(f32) - delta.mul_(lr)).to(p.dtype)

    return TrainState(step=step, params=tree_map(upd, state.params, mu, nu),
                      mu=mu, nu=nu)
