"""The builder of the CSNN configurations: the configuration file's
``network`` and ``plan`` as the program's ``CSNNConfig`` and pinned
``NetworkPlan``, the weights the benchmark draws, and the entry the loops
drive (``repro_torch.core.csnn.snn_apply_batched``).

Configuration keys: ``network``, ``plan`` (passed to ``plan_network`` as
it is: no tuning, no plan cache) and ``init`` (the weights' draw).
"""
from __future__ import annotations

import torch

from harness.record import Program


def program_config(net: dict):
    """The configuration file's ``network`` as the program's CSNNConfig."""
    from repro_torch.core.csnn import CSNNConfig, ConvSpec, FCSpec
    layers = tuple(ConvSpec(l["conv"], kernel=l["kernel"], pool=l.get("pool"))
                   if "conv" in l else FCSpec(l["fc"]) for l in net["layers"])
    return CSNNConfig(input_hw=tuple(net["input_hw"]),
                      input_channels=net["input_channels"], layers=layers,
                      t_steps=net["t_steps"], v_t=net["v_t"])


def program_plan(cfg, plan: dict):
    """The plan pinned in the configuration file (no tuning, no cache)."""
    from repro_torch.core.plan import plan_network
    return plan_network(cfg, **plan)


def _on_grid(t: torch.Tensor, bits: int) -> torch.Tensor:
    return torch.round(t * 2.0 ** bits) / 2.0 ** bits


def _block_perm(c: int, block: int, g: torch.Generator, device):
    """A permutation of ``c`` channels that moves each block of ``block``
    consecutive channels (the plan's channel block, snapped down to a
    divisor of ``c`` as the plan snaps it) whole onto another block, in
    another order within it."""
    block = max(d for d in range(1, min(block, c) + 1) if c % d == 0)
    n = c // block
    blocks = torch.randperm(n, generator=g, device=device)
    within = torch.argsort(torch.rand((n, block), generator=g, device=device),
                           dim=1)
    return (blocks[:, None] * block + within).reshape(-1)


def make_weights(net: dict, init: dict, seed: int, device,
                 blocks: list) -> dict:
    """The configuration's weights, in the channel order that ``seed``
    draws.

    The weights come from the configuration's own ``init["seed"]``, drawn
    on ``device`` in one call per tensor: conv weights normal with std
    sqrt(2 / fan_in) (He), head weights std sqrt(1 / D), biases std
    ``init["bias_std"]``, each rounded to a multiple of
    2**-``init["grid_bits"]``.  ``seed`` then permutes every conv layer's
    output channels (and the next layer's input channels with them) by
    whole channel blocks (``blocks``, one per conv layer): the same
    network, with the same channels in each block the program launches,
    so every seed gives the same work, laid out in another order.  (A
    permutation across blocks moved the DVS cell's samples/s by 0.4 %
    from seed to seed; across pool orders it moved 0.05 %.)

    On that grid every membrane sum the network can form is exact in
    float32 (at 14 bits, any sum under 1024 in magnitude; the largest a
    conv layer here can form is a few hundred), in any order of addition.
    So a program computing in float32 equals the float64 reference bit
    for bit, and the comparison can be exact; a lower precision (TF32,
    bfloat16, float16, a rescaled integer datapath) cannot hold the grid
    and shows."""
    g = torch.Generator(device=device)
    g.manual_seed(init["seed"])
    order = torch.Generator(device=device)
    order.manual_seed(seed % 2**63)
    params, hw, c_in = {}, tuple(net["input_hw"]), net["input_channels"]
    perm = None  # the previous conv layer's channel order
    conv_blocks = iter(blocks)
    for i, layer in enumerate(net["layers"]):
        if "conv" in layer:
            k, c_out = layer["kernel"], layer["conv"]
            w = torch.randn((k, k, c_in, c_out), generator=g, device=device)
            w *= (2.0 / (k * k * c_in)) ** 0.5
            name = f"conv{i}"
            pool = layer.get("pool")
            if pool:
                hw = (-(-hw[0] // pool), -(-hw[1] // pool))
            c_in = c_out
        else:
            c_out, d = layer["fc"], hw[0] * hw[1] * c_in
            w = torch.randn((d, c_out), generator=g, device=device)
            w *= (1.0 / d) ** 0.5
            name = f"fc{i}"
        b = torch.randn((c_out,), generator=g, device=device)
        b *= init["bias_std"]
        w, b = _on_grid(w, init["grid_bits"]), _on_grid(b, init["grid_bits"])
        if perm is not None:  # this layer's input channels follow
            if "conv" in layer:
                w = w[:, :, perm]
            else:
                w = w.reshape(hw[0], hw[1], -1, c_out)[:, :, perm]
                w = w.reshape(-1, c_out)
        if "conv" in layer:
            perm = _block_perm(c_out, next(conv_blocks), order, device)
            w, b = w[..., perm], b[perm]
        params[name] = {"w": w.contiguous(), "b": b.contiguous()}
    return params


def weights(conf: dict, seed: int, device) -> dict:
    """The weights both the program and the reference are given."""
    return make_weights(conf["network"], conf["init"], seed, device,
                        conf["plan"]["channel_block"])


def build(conf: dict, params: dict, device) -> Program:
    """The program set up on ``params``; its entry is looked up here, at
    set-up, so that a control can stand in its place."""
    from repro_torch.core import csnn
    cfg = program_config(conf["network"])
    return Program(cfg=cfg, plan=program_plan(cfg, conf["plan"]),
                   params=params, entry=csnn.snn_apply_batched,
                   encode=lambda x: csnn.encode_input(x, cfg))
