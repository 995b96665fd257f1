"""Roofline terms of a dry-run cell on NVIDIA H100s (port of
``repro.launch.roofline``).

Per (arch x shape x mesh) cell:
  compute term    = per-device matmul FLOPs of each dtype / that dtype's peak
  memory term     = per-device bytes of the materializing ops / HBM rate
  collective term = per-device wire bytes of each collective / its link rate

The counts come from ``launch/op_cost.py``: what one rank executes, from
local shapes (JAX's come from the partitioned HLO).  Collectives use
JAX's ring multipliers (:func:`collective_bytes`).

Constants: the data sheet of the **NVIDIA H100 SXM5 80 GB at 700 W**
(dense rates), stated as such, never measured here:

  * bf16 / fp16 on the tensor cores 989 TFLOP/s; float32 outside them
    67 TFLOP/s (the port trains in IEEE float32);
  * HBM3 3.35 TB/s;
  * NVLink 4, 450 GB/s per direction, among the 8 GPUs of one node;
  * the DGX H100 network, one 400 Gb/s NIC per GPU: 50 GB/s.

One rule places a collective: its group runs at NVLink speed when all its
ranks lie in one block of 8 consecutive ranks (one node), otherwise at
the network rate.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_F32 = PEAK_FLOPS[torch.float32]
PEAK_BYTES = 3.35e12          # HBM3 bytes/s
NVLINK_BW = 450e9             # bytes/s per direction
NET_BW = 50e9                 # bytes/s per GPU (400 Gb/s NIC)
NODE = 8                      # GPUs per NVLink node


def link_rate(ranks) -> float:
    """Bytes/s of a collective over ``ranks`` (global rank ids)."""
    return NVLINK_BW if len({r // NODE for r in ranks}) == 1 else NET_BW


def wire_bytes(kind: str, out_bytes: float, n: int) -> float:
    """Per-device on-wire bytes of one collective of ``n`` ranks (ring
    algorithms); ``out_bytes`` is the output buffer's size."""
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * out_bytes * frac          # reduce-scatter + all-gather
    if kind == "all-gather":
        return out_bytes * frac                # output is the gathered buffer
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)             # output is the scattered shard
    if kind == "all-to-all":
        return out_bytes * frac
    if kind == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float                 # per-device on-wire bytes (ring algs)
    payload_bytes: float              # raw output bytes (no multipliers)
    counts: dict                      # op kind -> #ops
    by_kind: dict                     # op kind -> wire bytes
    seconds: float = 0.0              # each collective at its link rate

    def to_dict(self):
        return dataclasses.asdict(self)


def collective_bytes(records, n_devices: int) -> CollectiveStats:
    """Sum the wire bytes of recorded collectives: (kind, output bytes,
    ranks of the group) each; a group of one moves no data."""
    counts: dict[str, int] = {}
    by_kind: dict[str, float] = {}
    wire = payload = secs = 0.0
    for kind, out_bytes, ranks in records:
        n = len(ranks)
        if n <= 1:
            continue
        w = wire_bytes(kind, out_bytes, n)
        counts[kind] = counts.get(kind, 0) + 1
        by_kind[kind] = by_kind.get(kind, 0.0) + w
        wire += w
        payload += out_bytes
        secs += w / link_rate(ranks)
    return CollectiveStats(wire, payload, counts, by_kind, secs)


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    n_devices: int
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: Optional[float] = None        # 6ND napkin (global)
    useful_flops_ratio: Optional[float] = None  # model / (counted * devices)
    collectives: Optional[dict] = None
    memory_analysis: Optional[str] = None

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(cost, n_devices: int, model_flops: Optional[float] = None,
            memory_analysis: Optional[str] = None) -> Roofline:
    """Roofline terms from an ``op_cost.OpCost`` of one rank's step."""
    flops = sum(cost.flops_by_dtype.values())
    t_c = 0.0
    for dtype, f in cost.flops_by_dtype.items():
        if dtype not in PEAK_FLOPS:
            raise ValueError(f"no H100 peak for {dtype} products")
        t_c += f / PEAK_FLOPS[dtype]
    t_m = cost.bytes / PEAK_BYTES
    coll = collective_bytes(cost.collectives, n_devices)
    terms = {"compute": t_c, "memory": t_m, "collective": coll.seconds}
    ratio = model_flops / max(flops * n_devices, 1.0) if model_flops else None
    return Roofline(
        flops_per_device=flops, bytes_per_device=cost.bytes,
        wire_bytes_per_device=coll.wire_bytes, n_devices=n_devices,
        t_compute=t_c, t_memory=t_m, t_collective=coll.seconds,
        bottleneck=max(terms, key=terms.get), model_flops=model_flops,
        useful_flops_ratio=ratio,
        collectives={"counts": coll.counts, "wire_by_kind": coll.by_kind,
                     "flops_by_dtype": {str(k).removeprefix("torch."): v
                                        for k, v in cost.flops_by_dtype.items()}},
        memory_analysis=memory_analysis)


def model_flops_estimate(n_params_active: float, tokens: float, phase: str) -> float:
    """6*N*D for train, 2*N*D for inference forward passes."""
    return (6.0 if phase == "train" else 2.0) * n_params_active * tokens
