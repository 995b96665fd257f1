"""The work a forward needs, counted from the reference's own spikes and
the network's shapes, whatever implements it.

* Synaptic adds: per conv layer and time step, the layer's input events
  times k_h * k_w * C_out; for the head, its input events times its
  outputs.
* Least time of a batch's conv work: per conv layer and time step, the
  larger of its bytes over the HBM rate and its adds over the float32
  peak, summed.  The bytes: membrane potentials read once and written
  once (H * W * C_out of the membranes' type per sample), the weights
  read once per batch, the input and output spike maps as bits per
  sample.
"""
from __future__ import annotations

import torch

from . import peaks

_VM_BYTES = {"float32": 4, "int16": 2, "int8": 1}


def layer_shapes(net: dict) -> list[dict]:
    """Per layer: kind, k, c_in, c_out, input (h, w), output (h, w)."""
    out, hw, c_in = [], tuple(net["input_hw"]), net["input_channels"]
    for layer in net["layers"]:
        if "conv" in layer:
            pool = layer.get("pool")
            ohw = (-(-hw[0] // pool), -(-hw[1] // pool)) if pool else hw
            out.append({"kind": "conv", "k": layer["kernel"], "c_in": c_in,
                        "c_out": layer["conv"], "in_hw": hw, "conv_hw": hw,
                        "out_hw": ohw})
            hw, c_in = ohw, layer["conv"]
        else:
            out.append({"kind": "fc", "d": hw[0] * hw[1] * c_in,
                        "c_out": layer["fc"]})
    return out


def sample_adds(conv_events: list, head_events: torch.Tensor,
                net: dict) -> torch.Tensor:
    """(B,) synaptic adds per sample, from the reference's (B, T) event
    counts of each conv layer's input and of the head's input."""
    shapes = layer_shapes(net)
    adds = torch.zeros(head_events.shape[0], dtype=torch.float64,
                       device=head_events.device)
    convs = [s for s in shapes if s["kind"] == "conv"]
    for ev, s in zip(conv_events, convs):
        adds += ev.to(torch.float64).sum(1) * (s["k"] ** 2 * s["c_out"])
    fc = shapes[-1]
    adds += head_events.to(torch.float64).sum(1) * fc["c_out"]
    return adds


def conv_least_time_s(conv_events: list, net: dict,
                      vm_dtype: str = "float32") -> float:
    """Least seconds the card needs for the conv work of one forward of the
    batch whose reference counts are given ((B, T) per conv layer)."""
    convs = [s for s in layer_shapes(net) if s["kind"] == "conv"]
    b = conv_events[0].shape[0]
    vm = _VM_BYTES[vm_dtype]
    total = 0.0
    for ev, s in zip(conv_events, convs):
        (h, w), (oh, ow) = s["conv_hw"], s["out_hw"]
        per_sample = (2 * h * w * s["c_out"] * vm
                      + (h * w * s["c_in"] + oh * ow * s["c_out"]) / 8)
        weights = s["k"] ** 2 * s["c_in"] * s["c_out"] * 4
        adds_t = ev.to(torch.float64).sum(0) * (s["k"] ** 2 * s["c_out"])
        for t in range(ev.shape[1]):
            total += max((b * per_sample + weights) / peaks.HBM_BYTES_PER_S,
                         float(adds_t[t]) / peaks.FP32_FLOPS)
    return total
