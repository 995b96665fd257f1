"""Training loop with fault-tolerance hooks (port of ``repro.train.loop``).

Wires together: model loss -> autograd -> AdamW update (optionally
through gradient event-compression), periodic and preemption-triggered
checkpoints, and the elastic remesh protocol (checkpoint -> replan ->
``on_remesh``).  The step is eager: no host sync inside it; the loop
reads the loss on the host at log steps only, as JAX's does.

The parameters' gradients come from ``torch.autograd.grad`` over their
leaves (each a detached alias with ``requires_grad``), so the state's
tensors are never mutated by autograd and ``adamw_update`` builds the
next state as JAX's does.

Under a mesh (``run(mesh=...)``, ``make_train_step(shardings=...)``) the
state is a tree of DTensors placed by ``optimizer.state_logical_axes``
and the rules, the batch comes from ``ShardedBatcher(mesh=...)``, and the
step runs in ``sharding.mesh_mode.MeshMode``.  The loss is reduced to a
replicated value before autograd (the gradient of the global mean, however
many unmasked tokens each shard holds), the gradients are laid onto the
parameters' shardings (the data-parallel reduction), and the new state onto
the state's shardings: JAX's ``jit`` with ``in_shardings``/``out_shardings``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import ckpt
from repro_torch.runtime.health import FaultPolicy
from repro_torch.sharding.compression import (CompressedGrad,
                                              compress_with_error_feedback,
                                              decompress)
from repro_torch.sharding.mesh_mode import MeshMode
from repro_torch.sharding.specs import default_rules, shard_tree, tree_shardings
from . import optimizer as opt


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    grad_compression_density: Optional[float] = None  # e.g. 0.01; None = dense


def value_and_grad(model, params: Any, batch: dict, compute_dtype=None):
    """((loss, metrics), grads) of ``model.loss`` at ``params``: JAX's
    ``value_and_grad(..., has_aux=True)``.  With ``compute_dtype`` the
    float32 leaves of more than one dimension are cast inside the loss,
    so their gradients land on the float32 masters."""
    leaves = opt.tree_leaves(params)
    req = [p.detach().requires_grad_() for p in leaves]

    def cast(p):
        if compute_dtype is not None and p.dtype == torch.float32 and p.dim() > 1:
            return p.to(compute_dtype)
        return p

    with torch.enable_grad():
        loss, metrics = model.loss(opt.tree_unflatten(params,
                                                      [cast(p) for p in req]),
                                   batch)
        if isinstance(loss, DTensor):  # a partial sum over the mesh
            loss = loss.full_tensor()
        grads = torch.autograd.grad(loss, req)
    metrics = {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach()
               for k, v in metrics.items()}
    return (loss.detach(), metrics), opt.tree_unflatten(params, list(grads))


def make_train_step(model, opt_cfg: opt.AdamWConfig,
                    compute_dtype=None,
                    shardings: Optional[opt.TrainState] = None) -> Callable:
    """Returns (state, batch) -> (state, metrics).  ``shardings`` (a
    ``TrainState`` of ``NamedSharding``s) runs the step on a state of
    DTensors and keeps the new state on them."""

    def train_step(state: opt.TrainState, batch: dict):
        (loss, metrics), grads = value_and_grad(model, state.params, batch,
                                                compute_dtype)
        new_state = opt.adamw_update(state, grads, opt_cfg)
        return new_state, {"loss": loss, **metrics}

    if shardings is None:
        return train_step

    def sharded_step(state: opt.TrainState, batch: dict):
        with MeshMode():
            (loss, metrics), grads = value_and_grad(model, state.params, batch,
                                                    compute_dtype)
            grads = shard_tree(grads, shardings.params)
            new_state = shard_tree(opt.adamw_update(state, grads, opt_cfg),
                                   shardings)
        return new_state, {"loss": loss, **metrics}

    return sharded_step


def state_shardings(model, mesh, rules: dict,
                    param_dtype=torch.float32,
                    opt_cfg: Optional[opt.AdamWConfig] = None) -> opt.TrainState:
    """The ``TrainState`` of ``NamedSharding``s the rules give ``model``'s
    state on ``mesh`` (the step replicated)."""
    template = opt.abstract_state(model.abstract_params(param_dtype),
                                  opt_cfg or opt.AdamWConfig())
    return tree_shardings(mesh, opt.state_logical_axes(model.logical_axes()),
                          template, rules)


def make_compressed_train_step(model, opt_cfg: opt.AdamWConfig) -> Callable:
    """Train step with top-k gradient event-compression + error feedback.

    The carry holds the EF residuals; the transmitted gradient is the
    decompressed queue (what the wire-efficient all-reduce would deliver).
    """

    def train_step(carry, batch):
        state, ef = carry
        (loss, metrics), grads = value_and_grad(model, state.params, batch)
        comp, ef = compress_with_error_feedback(grads, ef, density=0.01)
        queues = opt.tree_leaves(
            comp, is_leaf=lambda x: isinstance(x, CompressedGrad))
        sparse_grads = opt.tree_unflatten(grads, [
            decompress(c).reshape(g.shape).to(g.dtype)
            for g, c in zip(opt.tree_leaves(grads), queues)])
        new_state = opt.adamw_update(state, sparse_grads, opt_cfg)
        return (new_state, ef), {"loss": loss, **metrics}

    return train_step


def run(model, data_iter: Callable[[int], dict], loop_cfg: LoopConfig,
        opt_cfg: opt.AdamWConfig, generator: torch.Generator,
        policy: Optional[FaultPolicy] = None,
        preempted: Callable[[], bool] = lambda: False,
        on_remesh: Optional[Callable] = None,
        param_dtype=torch.float32, device="cuda", mesh=None,
        rules: Optional[dict] = None) -> tuple[opt.TrainState, list]:
    """Train for total_steps with checkpoint/restart + FT hooks.

    data_iter(step) -> batch dict on ``device``.  The run resumes from the
    latest checkpoint in ckpt_dir if one exists (crash/preemption restart
    path), restored onto an abstract state; else the parameters are drawn
    from ``generator`` (``Model.init_params``).  With ``mesh`` (a
    DeviceMesh; ``rules`` default to ``default_rules()``) the state is
    placed on it by :func:`state_shardings`, restored onto it, and the
    batches are DTensors.  The history holds the first step and every
    ``log_every``-th: {"step", "loss", "sec"}, ``sec`` the host time to
    issue the step.
    """
    shardings = (None if mesh is None else
                 state_shardings(model, mesh, rules or default_rules(),
                                 param_dtype, opt_cfg))
    if loop_cfg.ckpt_dir and ckpt.latest_step(loop_cfg.ckpt_dir) is not None:
        template = opt.abstract_state(model.abstract_params(param_dtype), opt_cfg)
        state, start = ckpt.restore(template, loop_cfg.ckpt_dir, device=device,
                                    shardings=shardings)
    else:
        params = model.init_params(generator, device, param_dtype)
        state, start = opt.init_state(params, opt_cfg), 0
        if shardings is not None:
            state = shard_tree(state, shardings)
    step_fn = make_train_step(model, opt_cfg, shardings=shardings)
    history = []
    for step in range(start, loop_cfg.total_steps):
        t0 = time.monotonic()
        state, metrics = step_fn(state, data_iter(step))
        dt = time.monotonic() - t0
        if policy is not None:
            decision = policy.decide(step, preempted=preempted())
            if decision == "checkpoint_now" and loop_cfg.ckpt_dir:
                ckpt.save(state, loop_cfg.ckpt_dir, step + 1)
                break  # yield to the preemption; restart resumes here
            if decision == "remesh":
                if loop_cfg.ckpt_dir:
                    ckpt.save(state, loop_cfg.ckpt_dir, step + 1)
                plan = policy.replan()
                if on_remesh is not None:
                    on_remesh(plan)  # launcher rebuilds the mesh + restores
                break
        if loop_cfg.ckpt_dir and (step + 1) % loop_cfg.ckpt_every == 0:
            ckpt.save(state, loop_cfg.ckpt_dir, step + 1)
        if (step + 1) % loop_cfg.log_every == 0 or step == start:
            # the loop's one host sync, at log steps only, as JAX's
            # analysis: ignore[lint-host-sync-in-hot-path]
            loss = metrics["loss"].item()
            history.append({"step": step + 1, "loss": loss, "sec": dt})
    return state, history
