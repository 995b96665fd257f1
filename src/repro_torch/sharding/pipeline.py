"""Pipeline parallelism over a mesh axis, GPipe-style microbatching (port
of ``repro.sharding.pipeline``).

Layer stages are placed along a mesh axis, activations flow stage to
stage with ``ppermute``, and microbatches keep every stage busy except
the (n_stages - 1)-bubble.  With S stages and M microbatches the loop
runs S+M-1 ticks; at tick t, stage s processes microbatch t-s.  Every
stage runs the same program on its own parameter slice: stage placement
is the leading (stacked) parameter axis sharded over the pipeline axis.
A stage with no microbatch at a tick passes its carry on unchanged (JAX
computes and discards that stage's output; the values are the same).
"""
from __future__ import annotations

from typing import Callable

import torch

from .collectives import axis_index, axis_size, ppermute, psum, shard_map
from .specs import PartitionSpec as P


def pipeline_apply(stage_fn: Callable, stacked_params, x: torch.Tensor, *,
                   mesh, axis: str, n_microbatches: int):
    """Run ``n_stages`` stacked stages over ``x`` with microbatch pipelining.

    stage_fn(params_slice, x_mb) -> x_mb     (one stage, one microbatch)
    stacked_params: dict of tensors with leading dim n_stages ==
        the size of ``axis``; each rank holds its own stage's weights.
    x: (B, ...) global batch; B % n_microbatches == 0.

    Returns stage_{S-1}(...stage_0(x)) for the whole batch, replicated.
    """
    n_stages = axis_size(mesh, axis)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not split into {n_microbatches} "
                         f"microbatches")
    mb = b // n_microbatches

    def body(params_slice, x_all):
        params_slice = {k: t[0] for k, t in params_slice.items()}
        stage = axis_index(mesh, axis)
        n_ticks = n_stages + n_microbatches - 1
        perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        x_mbs = x_all.reshape(n_microbatches, mb, *x_all.shape[1:])
        out_mbs = torch.zeros_like(x_mbs)
        carry = torch.zeros_like(x_mbs[0])
        for t in range(n_ticks):
            # stage 0 ingests microbatch t (if still in range)
            cur = x_mbs[min(max(t, 0), n_microbatches - 1)] if stage == 0 else carry
            y = (stage_fn(params_slice, cur)
                 if 0 <= t - stage < n_microbatches else carry)
            # the last stage banks its finished microbatch t - (S-1)
            if stage == n_stages - 1 and t - (n_stages - 1) >= 0:
                out_mbs[t - (n_stages - 1)] = y
            carry = ppermute(y, mesh, axis, perm)
        # finished microbatches live on the last stage: broadcast them back
        out = psum(out_mbs if stage == n_stages - 1 else torch.zeros_like(out_mbs),
                   mesh, axis)
        return out.reshape(b, *x_all.shape[1:])

    return shard_map(body, mesh=mesh, in_specs=(P(axis), P()),
                     out_specs=P())(stacked_params, x)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble overhead — the napkin number for stage/microbatch sizing."""
    return (n_stages - 1) / (n_stages + n_microbatches - 1)
