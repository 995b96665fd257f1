"""ANN -> SNN conversion (paper Sec. VII, Rueckauer et al. style; port of
``repro.core.conversion``).

The paper trains a conventional CNN with the clamped-ReLU activation,
converts the weights with data-based activation normalization and
quantizes to 8/16 bit:

* ``fit_ann`` — minibatch AdamW training of the clamped-ReLU CNN
  (``csnn.ann_apply``), with JAX's batches (``np.random.default_rng``)
  and JAX's optimizer (``train.optimizer``);
* ``normalize_params`` — threshold balancing: each layer's weights and
  biases are rescaled by lambda_{l-1} / lambda_l, where lambda_l is a
  high percentile of the layer's ANN activations on a calibration batch,
  so that V_t = 1 holds in every layer;
* ``quantize_params`` — one symmetric fixed-point format for every conv
  layer (the datapath then runs saturating integer arithmetic,
  ``core.quantization``), with ``quantized_threshold`` the integer V_t;
* ``ann_accuracy`` / ``snn_accuracy`` — the two networks' accuracies;
  the SNN through ``snn_apply_batched`` (or ``snn_apply_sharded`` with
  ``devices=``), which is bit-exact against JAX's ``vmap(snn_apply)``.

Everything runs on the parameters' device (``"cuda"`` by default in
``csnn.init_params``; the tests pass ``"cpu"``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .csnn import (CSNNConfig, ConvSpec, _max_pool, ann_apply, clamped_relu,
                   encode_input, snn_apply_batched, snn_apply_sharded)
from .event_conv import _fp32_convolutions, conv2d_same
from .plan import plan_network
from .quantization import (QuantSpec, calibrate_scale, f32_scalar,
                           percentile_f32, quantize)
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_state, tree_map)


def _device(params: dict) -> torch.device:
    return next(iter(params.values()))["w"].device


def layer_activations(params: dict, images: torch.Tensor,
                      cfg: CSNNConfig) -> list[torch.Tensor]:
    """ANN forward that records each conv layer's post-ReLU activations
    (B, H, W, C), before pooling."""
    acts, x = [], images
    for idx, spec in enumerate(cfg.layers):
        if isinstance(spec, ConvSpec):
            p = params[f"conv{idx}"]
            x = clamped_relu(conv2d_same(x, p["w"]) + p["b"], cfg.relu_clamp)
            acts.append(x)
            if spec.pool:
                x = _max_pool(x, spec.pool)
    return acts


def layer_lambdas(params: dict, images: torch.Tensor, cfg: CSNNConfig,
                  percentile: float = 99.9) -> list[float]:
    """lambda_l of every conv layer: the ``percentile`` of its
    activations on ``images`` (``jnp.percentile``'s float32 value), at
    least 1e-6."""
    with torch.no_grad():
        acts = layer_activations(params, images, cfg)
    return [max(float(percentile_f32(a, percentile)), 1e-6) for a in acts]


def normalize_params(params: dict, images: torch.Tensor, cfg: CSNNConfig,
                     percentile: float = 99.9) -> dict:
    """Data-based weight normalization so that V_t = 1 holds in every
    layer: w_l <- w_l * lambda_{l-1} / lambda_l, b_l <- b_l / lambda_l.
    With the ReLU clamped at 1.0 the lambdas are already ~1; the general
    rescaling keeps unclamped networks right too.  FC layers are kept."""
    lambdas = layer_lambdas(params, images, cfg, percentile)
    out, prev, ai = dict(params), 1.0, 0
    for idx, spec in enumerate(cfg.layers):
        if isinstance(spec, ConvSpec):
            lam, p = lambdas[ai], params[f"conv{idx}"]
            dev = p["w"].device
            out[f"conv{idx}"] = {
                "w": p["w"] * f32_scalar(prev / lam, dev),
                "b": p["b"] / f32_scalar(lam, dev)}
            prev, ai = lam, ai + 1
    return out


def quantize_params(params: dict, bits: int,
                    v_t: float = 1.0) -> tuple[dict, QuantSpec]:
    """Shared-scale symmetric quantization: returns (int params, spec).

    One fixed-point format serves every layer given (as on the FPGA
    datapath), so one integer firing threshold is valid everywhere.  The
    threshold joins the calibration range with 2x headroom: otherwise a
    small weight scale could push the integer threshold past saturation
    and silence the network."""
    dev = _device(params)
    vals = torch.cat([t for p in params.values()
                      for t in (p["w"].reshape(-1), p["b"].reshape(-1))]
                     + [torch.full((1,), 2.0 * v_t, dtype=torch.float32,
                                   device=dev)])
    spec = QuantSpec(bits=bits, scale=calibrate_scale(vals, bits))
    q_params = {name: {"w": quantize(p["w"], spec),
                       "b": quantize(p["b"], spec)}
                for name, p in params.items()}
    return q_params, spec


def quantized_threshold(v_t: float, spec: QuantSpec) -> int:
    return int(round(v_t / spec.scale))


# ---------------------------------------------------------------------------
# ANN training (paper Sec. VII: train a clamped-ReLU CNN, then convert)
# ---------------------------------------------------------------------------


def _loss(params: dict, x: torch.Tensor, y: torch.Tensor,
          cfg: CSNNConfig) -> torch.Tensor:
    """Mean softmax cross-entropy of ``ann_apply``'s logits."""
    logits = ann_apply(params, x, cfg)
    gold = logits.gather(-1, y[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def _loss_and_grads(params: dict, x: torch.Tensor, y: torch.Tensor,
                    cfg: CSNNConfig) -> tuple[torch.Tensor, dict]:
    """One training step's loss and its gradients (a tree like
    ``params``), forward and backward in full float32: the convolutions'
    backward runs under the same TF32-off guard as their forward."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    flat = [t for p in leaves.values() for t in p.values()]
    with _fp32_convolutions():
        loss = _loss(leaves, x, y, cfg)
        grads = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), tree_map(lambda _: next(grads), leaves)


def fit_ann(params: dict, cfg: CSNNConfig, images, labels, *,
            steps: int = 300, batch: int = 64, lr: float = 2e-3,
            seed: int = 0, log_every: int = 0) -> dict:
    """Minibatch AdamW training of the clamped-ReLU CNN (10 warmup steps,
    clip norm 1.0, no weight decay), on the parameters' device, in full
    float32 whatever the process's TF32 switches say.  Step k trains on
    ``images[np.random.default_rng(seed).integers(0, n, batch)]``, the
    k-th draw, as JAX's ``fit_ann`` does; ``log_every`` prints the loss in
    its format."""
    ocfg = AdamWConfig(lr=lr, warmup_steps=10, total_steps=steps,
                       weight_decay=0.0, clip_norm=1.0)
    dev = _device(params)
    state = init_state(tree_map(lambda t: t.detach(), params), ocfg)
    x_all = torch.as_tensor(images).to(dev, non_blocking=True)
    y_all = torch.as_tensor(labels).to(dev, torch.long, non_blocking=True)
    rng = np.random.default_rng(seed)
    n = x_all.shape[0]
    for step in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, batch)).to(dev)
        loss, grads = _loss_and_grads(state.params, x_all[idx], y_all[idx],
                                      cfg)
        state = adamw_update(state, grads, ocfg)
        if log_every and (step + 1) % log_every == 0:
            print(f"  ann step {step + 1}: loss {float(loss):.4f}")
    return state.params


def ann_accuracy(params: dict, cfg: CSNNConfig, images, labels,
                 batch: int = 256) -> float:
    dev = _device(params)
    x_all = torch.as_tensor(images)
    y_all = torch.as_tensor(labels)
    correct = 0
    with torch.no_grad():
        for i in range(0, x_all.shape[0], batch):
            logits = ann_apply(params, x_all[i:i + batch].to(dev), cfg)
            correct += int((logits.argmax(-1).cpu()
                            == y_all[i:i + batch]).sum())
    return correct / x_all.shape[0]


def snn_predictions(params: dict, cfg: CSNNConfig, images, *,
                    capacity: int | Sequence[int] = 256, batch: int = 32,
                    sat_bits: Optional[int] = None, channel_block: int = 1,
                    devices: Optional[Sequence] = None) -> torch.Tensor:
    """The m-TTFS event-driven SNN's class per image, (N,) int64 on the
    CPU: ``snn_apply_batched`` under ``plan_network(cfg,
    capacity=capacity, channel_block=channel_block, sat_bits=sat_bits)``,
    ``batch`` images at a time; with ``devices``, ``snn_apply_sharded``
    over them (``batch`` must then divide over them)."""
    dev = _device(params)
    plan = plan_network(cfg, capacity=capacity, channel_block=channel_block,
                        sat_bits=sat_bits)
    x_all = torch.as_tensor(images)
    preds = []
    for i in range(0, x_all.shape[0], batch):
        spikes = encode_input(x_all[i:i + batch].to(dev), cfg)
        if devices is None:
            logits = snn_apply_batched(params, spikes, cfg, plan,
                                       collect_stats=False)
        else:
            logits = snn_apply_sharded(params, spikes, cfg, plan,
                                       devices=devices)
        preds.append(logits.argmax(-1).cpu())
    return torch.cat(preds)


def snn_accuracy(params: dict, cfg: CSNNConfig, images, labels, *,
                 capacity: int | Sequence[int] = 256, batch: int = 32,
                 sat_bits: Optional[int] = None, channel_block: int = 1,
                 devices: Optional[Sequence] = None) -> float:
    """m-TTFS event-driven SNN accuracy (:func:`snn_predictions`)."""
    preds = snn_predictions(params, cfg, images, capacity=capacity,
                            batch=batch, sat_bits=sat_bits,
                            channel_block=channel_block, devices=devices)
    return int((preds == torch.as_tensor(labels)).sum()) / preds.shape[0]
