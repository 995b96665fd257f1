"""Plain PyTorch reference of the m-TTFS convolutional spiking network.

The semantics of the paper's CSNN (Sommer et al., TCAD 2022, Secs. V-VII)
written frame by frame, with none of the program's event queues, kernels,
plans or batching:

* m-TTFS input encoding: T-1 equally spaced thresholds in (0, 1), applied
  in decreasing order over time (the last step reuses the lowest), so a
  pixel spikes from the step its threshold first lies below it onwards;
* per conv layer and time step: v_m += SAME conv of the input spike map,
  then v_m += bias, then the neuron spikes when v_m > v_t or it has
  spiked before (the fired latch), then an OR over non-overlapping pool
  windows (ragged edges pad with no spike);
* the head: the last conv layer's spikes summed over time, flattened in
  (H, W, C) order, times the weights summed in float64 and rounded once,
  plus T times the bias.

``dtype`` is the precision of the weights, the convolutions and the
membranes: float64 for the reference, bfloat16 for the control that
stands in for a lower-precision program.  It imports nothing of the
program and takes only the inputs and weights the benchmark made.

A configuration file names this file as its ``reference``; the harness
calls :func:`check` once the window has closed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from yardstick import counts


@dataclass
class RefOutput:
    logits: torch.Tensor       # (B, n_out) float32
    conv_events: list          # per conv layer, (B, T) input events
    head_events: torch.Tensor  # (B, T) spikes into the head


def thresholds(t_steps: int) -> torch.Tensor:
    """The T encoding thresholds in the order they are applied."""
    step = torch.tensor(1.0, dtype=torch.float32) / t_steps
    grid = torch.arange(t_steps + 1, dtype=torch.float32) * step
    th = grid[1:-1]
    return torch.cat([th.flip(0), th[:1]])


def encode(images: torch.Tensor, t_steps: int) -> torch.Tensor:
    """(B, H, W, C) float32 in [0, 1] -> (B, T, H, W, C) bool spikes."""
    order = thresholds(t_steps).to(images.device)
    return images[:, None] > order.reshape(1, t_steps, 1, 1, 1)


def conv_layer(spikes: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               v_t: float, pool, dtype: torch.dtype) -> torch.Tensor:
    """(B, T, H, W, C_in) bool -> (B, T, H', W', C_out) bool."""
    bsz, t_steps, h, wd, c_in = spikes.shape
    k = w.shape[0]
    x = spikes.permute(0, 1, 4, 2, 3).reshape(bsz * t_steps, c_in, h, wd)
    u = F.conv2d(x.to(dtype), w.permute(3, 2, 0, 1).to(dtype),
                 padding=k // 2)
    u = u.reshape(bsz, t_steps, -1, h, wd)
    bias = b.to(dtype).reshape(1, -1, 1, 1)
    vm = torch.zeros_like(u[:, 0])
    fired = torch.zeros(vm.shape, dtype=torch.bool, device=vm.device)
    outs = []
    for t in range(t_steps):
        vm = vm + u[:, t]
        vm = vm + bias
        fired = fired | (vm > v_t)
        out = fired
        if pool:
            out = F.max_pool2d(out.to(torch.float32), pool, pool,
                               ceil_mode=True) > 0
        outs.append(out)
    return torch.stack(outs, dim=1).permute(0, 1, 3, 4, 2)


def head(drive: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
         t_steps: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, D) spike counts -> (B, n_out) float32 logits."""
    if dtype == torch.float64:
        prod = (drive.to(torch.float64) @ w.to(torch.float64)).to(w.dtype)
        return prod + t_steps * b
    return (drive.to(dtype) @ w.to(dtype)
            + t_steps * b.to(dtype)).to(torch.float32)


def forward(params: dict, spikes: torch.Tensor, net: dict,
            dtype: torch.dtype = torch.float64) -> RefOutput:
    """The network on (B, T, H, W, C_in) bool input spikes.

    ``params`` maps ``conv<i>``/``fc<i>`` to {"w", "b"} (conv weights
    (k, k, C_in, C_out), head weights (D, n_out)); ``net`` is the
    configuration file's ``network`` object."""
    x, conv_events, head_events, logits = spikes, [], None, None
    t_steps = net["t_steps"]
    for i, layer in enumerate(net["layers"]):
        p = params[f"{'conv' if 'conv' in layer else 'fc'}{i}"]
        if "conv" in layer:
            conv_events.append(x.flatten(2).sum(-1))
            x = conv_layer(x, p["w"], p["b"], net["v_t"], layer.get("pool"),
                           dtype)
        else:
            head_events = x.flatten(2).sum(-1)
            drive = x.flatten(2).sum(1)
            logits = head(drive, p["w"], p["b"], t_steps, dtype)
    return RefOutput(logits=logits, conv_events=conv_events,
                     head_events=head_events)


def forward_blocks(params: dict, spikes_fn, n: int, net: dict,
                   dtype: torch.dtype = torch.float64,
                   block: int = 512) -> RefOutput:
    """:func:`forward` over ``n`` samples in blocks of ``block`` rows;
    ``spikes_fn(lo, hi)`` gives the input spikes of rows [lo, hi)."""
    parts = [forward(params, spikes_fn(lo, min(lo + block, n)), net, dtype)
             for lo in range(0, n, block)]
    return RefOutput(
        logits=torch.cat([p.logits for p in parts]),
        conv_events=[torch.cat(list(ev)) for ev in
                     zip(*(p.conv_events for p in parts))],
        head_events=torch.cat([p.head_events for p in parts]))


def input_spikes(data, kind: str, net: dict, device) -> torch.Tensor:
    """Rows of a pool as the network's input spikes: images are encoded,
    spike frames taken as they are."""
    rows = data.to(device)
    if kind == "images":
        return encode(rows, net["t_steps"])
    if kind == "spikes":
        return rows
    raise ValueError(f"the reference reads no inputs of kind {kind!r}")


@dataclass
class Outcome:
    logits: torch.Tensor       # (N, n_out) float32 on the host, pool rows
    adds: torch.Tensor         # (N,) synaptic adds per pool row, float64
    least_time_s: Callable     # [rows of each forward] -> least conv s


def check(params: dict, pool, conf: dict, device) -> Outcome:
    """The reference over the whole pool, in blocks, and the work counted
    from its own spikes (``counts``)."""
    net = conf["network"]
    data, kind = pool.for_reference
    ref = forward_blocks(
        params, lambda lo, hi: input_spikes(data[lo:hi], kind, net, device),
        len(data), net)
    conv_events = [ev.cpu() for ev in ref.conv_events]

    def least_time_s(batches: list) -> float:
        return sum(counts.conv_least_time_s([ev[rows] for ev in conv_events],
                                            net, conf["dtype"])
                   for rows in batches)

    return Outcome(
        logits=ref.logits.cpu(),
        adds=counts.sample_adds(ref.conv_events, ref.head_events, net).cpu(),
        least_time_s=least_time_s)
