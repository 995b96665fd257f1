"""CSNN model assembly: the paper's 28x28-32C3-32C3-P3-10C3-F10 network
(main-path port of ``repro.core.csnn``).

* ``snn_apply_batched`` — event-driven m-TTFS inference for a sample
  batch, the serving entry point: ``init_state``, then
  ``snn_step_chunk`` once per time chunk, then ``snn_readout``;
* :class:`CSNN` — an ``nn.Module`` holding the parameters under the JAX
  package's keys (``conv0.w``, ``fc3.b``, ...) whose forward is
  ``snn_apply_batched``.

Parameters are a plain dict ``{"conv0": {"w": ..., "b": ...}, ...}`` —
the JAX pytree's layout, so ``convert.params_from_numpy`` moves weights
across unchanged.  Tensors live on ``device``, which defaults to
``"cuda"``; pass ``device="cpu"`` for the plain path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from .encoding import mttfs_thresholds, multi_threshold_encode
from .plan import NOT_PORTED, NetworkPlan, plan_network
from .scheduler import (LayerStats, head_product, init_conv_carry,
                        run_conv_layer_batched_chunk)


@dataclass(frozen=True)
class ConvSpec:
    channels: int
    kernel: int = 3
    pool: Optional[int] = None  # OR-max-pool window applied after this layer


@dataclass(frozen=True)
class FCSpec:
    features: int


@dataclass(frozen=True)
class CSNNConfig:
    """`28x28-32C3-32C3-P3-10C3-F10` == the paper's network (defaults)."""

    input_hw: tuple[int, int] = (28, 28)
    input_channels: int = 1
    layers: Sequence = field(default_factory=lambda: (
        ConvSpec(32), ConvSpec(32, pool=3), ConvSpec(10), FCSpec(10)))
    t_steps: int = 5
    v_t: float = 1.0


def conv_out_hw(hw: tuple[int, int], spec: ConvSpec) -> tuple[int, int]:
    h, w = hw  # SAME padding keeps H, W; pooling ceil-divides
    if spec.pool:
        return (-(-h // spec.pool), -(-w // spec.pool))
    return (h, w)


def init_params(cfg: CSNNConfig, *, seed: int = 0, dtype=torch.float32,
                device="cuda") -> dict:
    """Random He-style parameters in the JAX pytree layout, drawn on the
    CPU from ``torch.Generator().manual_seed(seed)`` and moved to
    ``device``, so every device sees the same numbers."""
    g = torch.Generator().manual_seed(seed)
    params = {}
    hw, c_in = cfg.input_hw, cfg.input_channels
    for idx, spec in enumerate(cfg.layers):
        if isinstance(spec, ConvSpec):
            fan_in = spec.kernel * spec.kernel * c_in
            w = torch.randn((spec.kernel, spec.kernel, c_in, spec.channels),
                            generator=g) * (2.0 / fan_in) ** 0.5
            params[f"conv{idx}"] = {"w": w, "b": torch.zeros(spec.channels)}
            hw, c_in = conv_out_hw(hw, spec), spec.channels
        else:
            d = hw[0] * hw[1] * c_in
            w = torch.randn((d, spec.features), generator=g) * (1.0 / d) ** 0.5
            params[f"fc{idx}"] = {"w": w, "b": torch.zeros(spec.features)}
    return {k: {n: t.to(device=device, dtype=dtype) for n, t in p.items()}
            for k, p in params.items()}


def encode_input(images: torch.Tensor, cfg: CSNNConfig) -> torch.Tensor:
    """(B, H, W, C) floats in [0, 1] -> (B, T, H, W, C) m-TTFS spikes."""
    thresholds = mttfs_thresholds(cfg.t_steps)
    return multi_threshold_encode(images, thresholds,
                                  cfg.t_steps).transpose(0, 1)


class CSNNState(NamedTuple):
    """Explicit per-layer carry of the event pipeline over a batch:
    one ``ConvCarry`` per conv layer and the (B, D) accumulated FC drive
    (exact small integers in the head's dtype)."""

    convs: tuple
    fc_drive: torch.Tensor


def init_state(params: dict, cfg: CSNNConfig, plan: NetworkPlan,
               batch: int, device=None) -> CSNNState:
    """Fresh (t=0) state for ``batch`` samples on the parameters' device
    (or ``device``)."""
    plan.validate(cfg)
    fc = [params[f"fc{i}"]["w"] for i, s in enumerate(cfg.layers)
          if not isinstance(s, ConvSpec)]
    any_w = fc[-1] if fc else next(iter(params.values()))["w"]
    dev = any_w.device if device is None else device
    convs = tuple(init_conv_carry(lp, batch, device=dev) for lp in plan.layers)
    last = plan.layers[-1]
    d = last.out_hw[0] * last.out_hw[1] * last.c_out
    fc_dtype = fc[-1].dtype if fc else torch.float32
    return CSNNState(convs=convs,
                     fc_drive=torch.zeros((batch, d), dtype=fc_dtype,
                                          device=dev))


def snn_step_chunk(params: dict, state: CSNNState,
                   spikes_chunk: torch.Tensor, cfg: CSNNConfig,
                   plan: NetworkPlan, *, collect_stats: bool = False):
    """Advance the batched pipeline by one chunk of time steps.

    spikes_chunk: (B, t_chunk, H, W, C_in) bool.  Each conv layer consumes
    the chunk from its carry; the head drive accumulates the last conv
    layer's spikes.  Returns the new state, or (state, [LayerStats, ...])
    with ``collect_stats``.

    The layer boundary: when the next conv layer is pinned to
    ``"fused-handoff"``, the producer emits that layer's
    ``aeq.FusedHandoff`` carrier from its threshold kernel (the JAX
    package builds the same carrier here with ``build_fused_handoff``),
    and the carrier passes in place of the dense spikes.
    """
    if not isinstance(spikes_chunk, torch.Tensor):
        raise NotImplementedError(NOT_PORTED["stream"])
    x, stats, ci = spikes_chunk, [], 0
    n_conv = len(plan.layers)
    new_convs = []
    for idx, spec in enumerate(cfg.layers):
        if isinstance(spec, ConvSpec):
            p = params[f"conv{idx}"]
            nxt = plan.layers[ci + 1] if ci + 1 < n_conv else None
            emit = ((nxt.capacity, nxt.geometry) if nxt is not None
                    and nxt.resolve_variant() == "fused-handoff" else None)
            x, carry, st = run_conv_layer_batched_chunk(
                x, p["w"], p["b"], cfg.v_t, plan.layers[ci],
                state.convs[ci], emit=emit)
            new_convs.append(carry)
            stats.append(st)
            ci += 1
    b, c = x.shape[:2]
    drive = x.reshape(b, c, -1).to(state.fc_drive.dtype).sum(dim=1)
    state = CSNNState(convs=tuple(new_convs),
                      fc_drive=state.fc_drive + drive)
    return (state, stats) if collect_stats else state


def snn_readout(params: dict, state: CSNNState, cfg: CSNNConfig,
                plan: Optional[NetworkPlan] = None) -> torch.Tensor:
    """Classification-unit readout: drive @ W + T * b, never thresholded
    (the product is :func:`scheduler.head_product`)."""
    if plan is not None and plan.fc_capacity is not None:
        raise NotImplementedError(NOT_PORTED["fc_capacity"])
    logits = None
    for idx, spec in enumerate(cfg.layers):
        if not isinstance(spec, ConvSpec):
            p = params[f"fc{idx}"]
            logits = (head_product(state.fc_drive, p["w"])
                      + cfg.t_steps * p["b"])
    if logits is None:
        raise ValueError("cfg has no FC head layer")
    return logits


def _merge_chunk_stats(chunks: list) -> list:
    """Per-chunk LayerStats -> whole-T stats: counts concatenate along the
    time axis; ``in_sparsity`` averages the (equal-length) chunk means."""
    merged = []
    for per_layer in zip(*chunks):
        merged.append(LayerStats(
            in_spike_counts=torch.cat([s.in_spike_counts for s in per_layer],
                                      dim=1),
            out_spike_counts=torch.cat([s.out_spike_counts for s in per_layer],
                                       dim=1),
            in_sparsity=sum(s.in_sparsity for s in per_layer) / len(per_layer),
            event_block=per_layer[0].event_block,
            event_par=per_layer[0].event_par,
        ))
    return merged


def snn_apply_batched(
    params: dict,
    in_spikes: torch.Tensor,
    cfg: CSNNConfig,
    plan: Optional[NetworkPlan] = None,
    *,
    collect_stats: bool = True,
):
    """Event-driven m-TTFS inference for a sample batch.

    in_spikes: (B, T, H, W, C_in) bool on the parameters' device.  Returns
    (logits (B, n_classes), [LayerStats, ...]) or logits alone.  ``plan``
    carries the per-layer sizing (``plan_network``; its defaults when
    None).  Chaining ``plan.chunk_steps`` chunks is exact for every
    chunking.
    """
    plan = plan_network(cfg) if plan is None else plan.validate(cfg)
    t, chunk = cfg.t_steps, plan.chunk_steps
    state = init_state(params, cfg, plan, in_spikes.shape[0],
                       device=in_spikes.device)
    chunk_stats = []
    for k in range(0, t, chunk):
        state, stats = snn_step_chunk(
            params, state, in_spikes[:, k:k + chunk], cfg, plan,
            collect_stats=True)
        chunk_stats.append(stats)
    logits = snn_readout(params, state, cfg, plan)
    if not collect_stats:
        return logits
    return logits, _merge_chunk_stats(chunk_stats)


class CSNN(nn.Module):
    """The network as an ``nn.Module``: parameters under the JAX keys
    (``conv0.w``, ``conv0.b``, ..., ``fc3.b``) and ``forward`` =
    :func:`snn_apply_batched`.  Inference only: nothing requires grad."""

    def __init__(self, cfg: CSNNConfig, params: Optional[dict] = None, *,
                 seed: int = 0, device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, seed=seed, device=device)
        for name, p in params.items():
            layer = nn.Module()
            for key, t in p.items():
                layer.register_parameter(
                    key, nn.Parameter(t, requires_grad=False))
            self.add_module(name, layer)

    def params(self) -> dict:
        """The parameter dict in the JAX pytree layout."""
        return {name: dict(mod.named_parameters(recurse=False))
                for name, mod in self.named_children()}

    def forward(self, in_spikes: torch.Tensor,
                plan: Optional[NetworkPlan] = None, **kwargs):
        return snn_apply_batched(self.params(), in_spikes, self.cfg, plan,
                                 **kwargs)
