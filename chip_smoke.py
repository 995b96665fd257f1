#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-threshold OTHER/threshold_pool.cu ...
    python3 chip_smoke.py --stress-emit SECONDS
    python3 chip_smoke.py --crossover
    python3 chip_smoke.py --vgg
    python3 chip_smoke.py --aeq-build

The second form only builds the given base-mode threshold sources beside
this checkout's, holds each against the plain version and times them in
turns at the FULL forward's shapes (another commit's kernel, or a probe
build).  The third relaunches the emit-mode threshold kernel at every
configuration of phase 3 (fresh seeded inputs, each relaunched into
buffers filled with stale bits, back to back and one at a time on an idle
card) for about SECONDS and exits non-zero on any output that differs from
the plain version: a search for a rare cross-CTA race in the kernel's
cluster exchange, which one pass of phase 3 cannot see.  The fourth
builds, holds the interlaced conv unit on both its paths against the plain
version (phase 3's ``check_interlaced_gather``) and prints the crossover
table and the offline plan's launch counts of phase 7.  The fifth runs
phase 7's VGG-16 check alone, then trains and converts a VGG-16 with the
port's own path and reads its activity beside the benchmark's drawn
weights (``vgg_converted``), and writes the readings to
``results/vgg_smoke.json``.  The sixth builds, holds the event-set
builder against its plain version (phase 3's ``check_aeq_build``), times
it (phase 7's ``aeq_build_timing``) and runs phase 7's offline paper plan
and VGG-16 checks with their exact launch counts.

Phases (any failure exits non-zero before the result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print the build time and ptxas usage;
3. hold each kernel against its plain PyTorch version on the card with
   ``torch.equal``: FULL-path shapes, k in {1, 3, 5}, float32/int16/int8,
   truncated and segment-padded queues, a tile over 48 KB, repeated
   coordinates in an interlaced group; the base-mode threshold kernel at
   the three shapes of the FULL forward (B=8 and one sample, k in {1, 3,
   5}), on views at odd offsets, with ``fired_out`` = ``fired`` and on the
   int rails; the emit-mode threshold kernel at the conv0 -> conv1 tiles (pool None) and the conv1 -> conv2 handoff
   (pool 3) for B=8 and one sample and with C=5, at capacities from 1 to
   above the map and at the demand, relaunched into buffers filled with
   stale bits; the banked conv over truncating, empty, all-set and sparse
   carriers of 32 input channels at the conv1 tile (B=8 and one sample)
   and the conv2 tile (C=5), fresh and in place; the single-queue conv units
   at the FULL single-sample tiles (k in {1, 3, 5}, f32/i16/i8, truncated,
   segment-padded and unpadded queues, repeated coordinates, a 115 KB tile
   over several CTAs, in place); the sequential conv unit over every input
   channel of a (block, t) in one launch at the FULL shapes (conv0 1, conv1
   and conv2 32 input channels; B=8 and one sample) and with 4 input
   channels for k in {1, 3, 5} on 3 tiles and on one; the interlaced conv
   unit the same way, at the serve plan's event_par and queue depth, and
   with 4 input channels at event_par 8, 4, 2, 16 and 6, unpadded queues
   (mixed groups) and repeated coordinates, each batched case also on the
   tile path; the tile path as the wrapper chooses it at the offline
   benchmark's conv shapes (f32/i16/i8, padded and mixed groups,
   repeated coordinates, fresh and in place) and one launch on each side
   of the crossover, each counted on its own path; the event-set builder
   (``aeq_build``) at every cell's queue layer (the paper net's 28x28x1,
   28x28x32, 10x10x32, VGG-16's 32x32x3 to 2x2x512), event_par 1-8,
   capacities at and below the demand, random, empty, full and strided
   maps, and the 1x1 and 5x5 windows, against its plain version (the
   composition it replaced) in every element;
3b. the auditor (``repro_torch.analysis``): the plan contracts, the hazard
   proofs, the kernel audit with ``device="cuda"`` (every wrapper's
   operands in red zones; each kernel of ``runtime.LAUNCHES`` must count
   a launch),
   the lint and the self-test, one line per pass with its obligations per
   rule and its time; then ``python -m repro_torch.analysis --only kernels
   --device cuda`` under ``compute-sanitizer --tool memcheck`` with
   ``PYTORCH_NO_CUDA_MEMORY_CACHING=1``, its ``ERROR SUMMARY`` line and
   wall time (where the sanitizer does not support the card, its refusal
   is printed and the red-zone audit stands in);
4. the main paths: ``snn_apply_batched``'s steps (``init_state``,
   ``snn_step_chunk``, ``snn_readout``) on ``csnn_paper.FULL`` with B=8
   under the serve plan (interlaced), with ``event_par=1``, with every
   layer pinned to ``"fused-handoff"`` and to ``"banked-cuda"``, each held
   against the port's plain path on the CPU (spikes, counts and carried
   state exact; logits within tolerance; argmax equal); the fused and
   banked runs held against the serve plan's card run, and the fused run
   repeated; then ``csnn_wide.FULL`` under the serve plan and fused
   (a 5x5 layer at the network edge), held the same way; the sparse FC
   head (``fc_capacity``) at a calibrated and a truncating queue, held
   against the CPU plain path; then ``snn_apply`` (one sample) on 8
   ``synth_digits`` images under the same four plans, each held against
   the CPU plain path and the card's ``snn_apply_batched`` on the same
   images, and at a covering capacity against ``snn_apply_dense``
   (argmax); then the serving engine on FULL under the serve plan, with
   synchronizing CUDA calls made errors (``no_sync``): micro-batching
   (8 requests, one size flush, then 3, a deadline flush padded to 8),
   continuous refill (8 slots, one time step per chunk, 12 requests
   staggered so that later ones refill mid-flight and the first steps
   alone at bucket 1) and streaming admission of 8 ``dvs_moving_edges``
   traces (28x28, 2 polarities) under the serve plan and
   ``"fused-handoff"``; every request's logits ``torch.equal`` the card's
   ``snn_apply_batched`` on the same inputs (streams: the binned frames),
   and each streamed forward equals the CPU plain path (stats, state);
   then the measured tuner (``tune="measured"``, a plan cache in a
   temporary directory): FULL at the serve knobs, every candidate's time
   and roofline, the winners and the tuning wall time; one B=8 forward
   under the tuned plan held against the serve plan's card run (exact,
   logits ``torch.equal``); a ``tune="cached"`` reload with no
   measurement run; a second fresh tune, whose winners are compared; a
   continuous engine pass with ``CSNNEngine(tune="cached")``, its logits
   ``torch.equal`` to ``snn_apply_batched``; and ``ingest=True`` tunes of
   FULL and SMOKE with 2 polarities (784 and 144 cells), each tuned
   streamed forward held against the CPU plain path; then ``snn_apply_sharded`` on FULL, B=8,
   under the serve plan and ``"fused-handoff"``: one shard on the card,
   two shards on two streams of it (and two cards where there are two),
   under ``no_sync``, logits ``torch.equal`` and stats equal to the
   card's ``snn_apply_batched``; then FULL at ``sat_bits`` 16 and 8
   (``init_params(seed=0)`` normalized on 256 ``synth_digits`` images on
   the CPU, ``quantize_params`` held equal on the card and the CPU,
   ``quantized_threshold``) under the four plans, the serve and
   ``event_par=1`` runs held against the CPU plain path, the fused and
   banked runs exactly against the serve plan's card run; then the
   conversion workflow on the card with cuDNN's TF32 switch at
   PyTorch's default (on): one training step's gradients held at rtol
   1e-5 (SMOKE: the card against the CPU; FULL: the card against the
   card with the switch off), the error of a TF32 backward printed
   beside, ``fit_ann`` (FULL, 150 steps, batch 64, 1000 images;
   the loss every 50 steps, ms per step), the ANN's accuracy (gate:
   90 %), ``normalize_params``, and the SNN's predictions and accuracy at
   float32, int16 and int8 on 100 images, every prediction equal to
   ``snn_apply_batched`` under the serve plan's knobs, the first 8 to the
   CPU plain path's, the float32 ones to two shards' (accuracies printed,
   not gated); with FULL's step also in float64 on both sides (held at
   the same tolerance), each float32 side against the CPU's float64 (the
   card's also with cuDNN off), and the pre-activations that float32 puts
   on other sides of the clamped ReLU's kinks at 0 and 1; each of these
   phases prints its seconds;
   then the LM phase (``chip_smoke.py --lm`` in a child process, which
   keeps PyTorch's TF32 switches as a process starts; this process turns
   them off for its yardsticks): the ten SMOKE LM architectures on the
   card against the CPU plain path (prefill logits and cache, 4 decode
   steps, float32 and bfloat16 caches); gemma3-1b FULL (26 layers, d
   1152, vocab 262144, ~1.0 B float32 parameters from a CPU generator):
   (a) B=2, a 64-token prompt and 8 teacher-forced decode steps, card
   against CPU at float32 and bfloat16 caches, every step's logits held
   and the argmax equal where the CPU's top-2 gap exceeds the tolerance;
   (b) B=4, a 640-token prompt (the 512-slot ring wraps), 32 new tokens
   through ``Engine.generate`` under ``set_sync_debug_mode("error")``
   (d), equal to a manual greedy loop, and prefill of 640 tokens against
   prefill of 639 plus one decode step (JAX's rtol 2e-2, atol 2e-3); (c)
   B=1, 2304 tokens (the query-blocked path with sliding KV slices), the
   same consistency; then the LM training phase (``chip_smoke.py
   --lm-train``, a child process that prints PyTorch's TF32 switches as it
   starts): (a) one gemma3-1b FULL training step at B=2 x 64
   (``TokenStream``), card against the CPU in float32 with matmul TF32
   off, the loss, every gradient leaf and the global norm held to the
   tolerances stated at ``TRAIN_LOSS_RTOL``, then one AdamW update (the
   moments, and each parameter's change outside the gradients' tolerance
   band); (b) ``train.loop.run`` at B=4 x 1024 with a checkpoint after
   step 3 in a temporary directory, ``restore`` onto a ``meta`` template
   equal to the in-memory state bit for bit, steps 4-5 through ``run``
   from the checkpoint against steps 4-5 from the in-memory state, the
   loss of every step printed and the last no higher than the first; (d)
   ms per step (median of the 5), tokens/s, the device's busy share over
   one more step (``torch.profiler``), ``max_memory_allocated`` over it,
   and the memory of the loss and gradients with and without each
   cross-entropy chunk recomputed; then, with the FULL state freed, (c)
   one training step of each of the ten SMOKE architectures, card against
   CPU: the loss and the gradient norm; then the mesh phase
   (``chip_smoke.py --mesh``, a child process: NCCL with a world of one on
   the card, the (1, 1) smoke mesh): ``psum_matmul``,
   ``ring_weight_gather_matmul``, ``pipeline_apply``, ``sparse_psum``,
   ``quantized_pmean`` and ``moe_forward_sharded`` (deepseek-v2 SMOKE's
   MoE layer) each against the card's unsharded result; gemma3-1b FULL two
   training steps at B=2 x 64 with the state placed by the logical-axis
   rules as DTensors, the losses and every state leaf ``torch.equal`` to
   the same two steps without a mesh, under ``set_sync_debug_mode
   ("error")``; ms per step at B=4 x 1024 with and without the mesh, in
   turns, median of 5; the mesh state through a checkpoint and
   ``restore(shardings=)``, bit for bit; two NCCL ranks where the machine
   has two cards (else it says they were not run).  No kernel is on the
   LM path, nor on its training or mesh paths;
5. print the launch counters of each main-path run, each read from
   counters set to 0 just before that run: each run must launch the
   kernels its plan's layers resolve to and no other, each exactly once
   per (channel block, time step) of its layers (``exact_launches``,
   derived from ``LayerPlan.resolve_variant``: at B=8 the fused run 50
   banked convs, 40 emits and 10 base thresholds, every other run 50 +
   50, and the queue runs one builder launch per layer and chunk; the micro-batching engine 2 x (50 + 50); the continuous engine 10
   conv + 10 threshold per chunk, the conv through the single-queue
   kernel at bucket 1; each stream engine run as one forward of its
   plan; the tuned runs by their winners; each sharded run its shards'
   sum of one forward of its slice; the int16/int8 runs as the float32
   ones);
6. run ``python -m repro_torch.launch.serve --arch csnn-paper
   --requests 8`` (batched, ``--engine``, ``--engine --continuous
   --t-chunk 1``, ``--stream``, ``--tune measured`` and ``--tune cached``
   with ``REPRO_TORCH_PLAN_CACHE`` in the temporary directory),
   ``python -m repro_torch.launch.quickstart`` and ``python -m
   repro_torch.launch.train_csnn --steps 150 --n-train 1000 --n-eval
   100`` and print their lines; ``python -m repro_torch.launch.serve
   --arch gemma3-1b --requests 2 --prompt-len 16 --new-tokens 8`` (FULL)
   and ``--smoke`` runs of deepseek-v2-236b, whisper-medium and
   qwen2-vl-7b, with ``python -m repro_torch.launch.train --arch gemma3-1b
   --mesh smoke --steps 3 --batch 4 --seq 1024`` (FULL) and ``--smoke
   --steps 20`` runs of stablelm-3b, deepseek-v2-236b and rwkv6-1.6b,
   ``launch.train --mesh single`` (must exit non-zero: no torchrun world of
   256) and ``python -m repro_torch.launch.dryrun --arch gemma3-1b --mesh
   single`` at train_4k and decode_32k (each cell ``ok``; its roofline terms
   and seconds printed), the eleven at once;
7. time each kernel on the device (a CUDA graph of its launches,
   replayed between CUDA events) and as launched from Python, against its
   bound, its plain version and a library yardstick (each queue conv unit
   per (block 0, t) launch at conv1 over all 32 input channels, beside
   ``F.conv2d`` of the same 32 channels' kept events; the banked conv
   also for one sample and at conv2, the emit kernel at both handoffs, the
   base threshold kernel at conv0, conv1 and conv2 (B=8) and conv1 for one
   sample, beside the launch floor: a one-element ``add_`` in the same
   graph harness);
   then end-to-end samples/s of every path (the five B=8 plans, the
   tuned one included, timed in turns) and a ``torch.profiler``
   breakdown of one forward of the serve, event_par=1, fused, banked-cuda
   and tuned plans and of one single-sample forward under the serve
   plan and event_par=1; then samples/s of the micro-batching,
   continuous and stream engines at B=8 / 8 slots beside
   ``snn_apply_batched`` of the same inputs, and a ``torch.profiler``
   breakdown of one continuous engine pass, per chunk; then the LM
   phase's timings of gemma3-1b FULL at B=4, a 640-token prompt and the
   default bfloat16 cache: prefill tokens/s, decode ms per step and the
   device's busy share over 8 decode steps; and the training phase's
   gemma3-1b FULL ms per step, tokens/s, busy share and peak memory, beside
   the card's name and power limit; last the crossover table of the
   batched interlaced unit (the patch gather against the tile path at the
   offline benchmark's three conv shapes, Q from 8 to 1024, and the tile
   path at conv1, Q=1024, beside its bound, plain version and
   ``F.conv2d``), the event-set builder at the paper cell's conv1 (B=1024)
   and VGG-16's conv1 and conv8 (B=256) beside its byte bound and its plain
   version (the glue it replaced), and the offline benchmark's plan at B=1024 with exact
   launch counts (every batched interlaced launch on the tile path, the
   forward equal to ``event_par=1``'s; one sample never on it); last
   VGG-16 (``csnn_vgg16.FULL``) at B=256 under its pinned plan on the
   offline VGG cell's weights and images (``vgg_phase``): exact launch
   counts, logits bit for bit the benchmark's float64 reference, each
   layer's input density at least 1 %, per layer the host ms of its
   ``.queues`` and ``.launches`` spans, its device ms and its conv path
   (every layer on the tile path), the memory peak, ms a forward,
   samples/s and busy share, and the same forward at channel block 8 on
   the two 32x32 layers (the patch gather) beside it.

The line before last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

B = 8
LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)  # FC float64 sums in another order


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls (CUDA events, after
    one warmup call): host and device time together, since the host
    enqueues while the device runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int = 5) -> float:
    """Device ms per call of ``fn`` with the host taken out: ``fn`` is
    captured once into a CUDA graph and the graph is replayed."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_time_ms(graph.replay, iters)


def device_profile(fn, label: str, wall_s: float) -> None:
    """Print the device time of one call of ``fn`` by kernel
    (``torch.profiler``) and the device's busy share of ``wall_s``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((us, e.count, e.key))
    busy_us = sum(r[0] for r in rows)
    if not busy_us:
        fail(f"profile {label}: the profiler saw no device time")
    print(f"profile {label}: device busy {busy_us / 1e3:.3f} ms of "
          f"{wall_s * 1e3:.3f} ms wall per call "
          f"({100 * busy_us / 1e6 / wall_s:.1f}% busy)")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
    return busy_us / 1e3


# --------------------------------------------------------------- phase 3
def rand_tile(g, shape, dtype, dev):
    import torch
    if dtype == torch.float32:
        return torch.randn(shape, generator=g).to(dev)
    lo, hi = (-100, 100) if dtype == torch.int8 else (-30000, 30000)
    return torch.randint(lo, hi, shape, generator=g).to(dtype).to(dev)


def rand_kernel(g, shape, dtype, dev):
    import torch
    if dtype == torch.float32:
        return torch.randn(shape, generator=g).to(dev)
    hi = 90 if dtype == torch.int8 else 20000  # big enough to saturate
    return torch.randint(-hi, hi, shape, generator=g).to(dtype).to(dev)


def queues_for(g, q, h, w, density, capacity, geom, event_par, dev):
    """Truncated AEQs of random fmaps (segment-padded for event_par > 1)."""
    import torch

    from repro_torch.core.aeq import build_aeq_batched, segment_pad
    fm = torch.rand((q, h, w), generator=g) < density
    qs = build_aeq_batched(fm.to(dev), capacity, geometry=geom)
    if event_par > 1:
        qs = segment_pad(qs, event_par, geom)
    return qs


def check_kernels(dev) -> dict:
    """Phase 3: every kernel against its plain version on the card;
    returns the max abs error per kernel."""
    import torch

    from repro_torch.core.geometry import ConvGeometry
    from repro_torch.kernels.event_conv.kernel import (
        event_conv_cuda_batched, event_conv_cuda_interlaced_batched)
    from repro_torch.kernels.event_conv.ref import (
        event_conv_ref_batched, event_conv_ref_interlaced_batched)
    from repro_torch.kernels.threshold_pool.kernel import \
        threshold_pool_cuda_batched
    from repro_torch.kernels.threshold_pool.ref import threshold_pool_tile_ref

    g = torch.Generator().manual_seed(11)
    worst = {}  # kernel name -> max abs err over its checks

    def same(name, a, b):
        torch.cuda.synchronize()
        err = (a.double() - b.double()).abs().max().item()
        if not torch.equal(a, b):
            fail(f"{name}: kernel != plain version (max abs err {err}; "
                 f"{where_differ(a, b)})")
        kernel = name.split()[0]
        worst[kernel] = max(worst.get(kernel, 0.0), err)

    dtypes = (torch.float32, torch.int16, torch.int8)
    # (k, cb, density, capacity): the FULL-path tile (cb 8), a >48 KB tile
    cases = [(3, 8, 0.6, 256), (1, 8, 0.6, 256), (5, 8, 0.6, 256),
             (3, 32, 0.3, 256), (3, 8, 0.05, 256)]
    for k, cb, density, cap in cases:
        geom = ConvGeometry(k, k)
        hh = k // 2
        for dtype in dtypes:
            if cb == 32 and dtype != torch.float32:
                continue
            kern = rand_kernel(g, (k, k, cb), dtype, dev)
            vm = rand_tile(g, (B, 28 + 2 * hh, 28 + 2 * hh, cb), dtype, dev)
            qs = queues_for(g, B, 28, 28, density, cap, geom, 1, dev)
            tag = f"k={k} cb={cb} {dtype} density={density}"
            same(f"event_conv_seq {tag}",
                 event_conv_cuda_batched(vm, qs.coords, qs.valid, kern),
                 event_conv_ref_batched(vm, qs.coords, qs.valid, kern))
            for ep in (8, 4, 2):
                qp = queues_for(g, B, 28, 28, density, cap, geom, ep, dev)
                same(f"event_conv_interlaced ep={ep} {tag}",
                     event_conv_cuda_interlaced_batched(
                         vm, qp.coords, qp.valid, kern, event_par=ep),
                     event_conv_ref_interlaced_batched(
                         vm, qp.coords, qp.valid, kern, event_par=ep))
            # unpadded interlaced queue: groups straddle column boundaries
            same(f"event_conv_interlaced mixed-groups {tag}",
                 event_conv_cuda_interlaced_batched(
                     vm, qs.coords, qs.valid, kern, event_par=8),
                 event_conv_ref_interlaced_batched(
                     vm, qs.coords, qs.valid, kern, event_par=8))
    # repeated coordinates inside column-homogeneous groups
    coords = torch.tensor([[[4, 4], [4, 4], [7, 4], [4, 4]] * 4] * B,
                          dtype=torch.int32)
    valid = torch.tensor([[1, 1, 1, 0] * 4] * B, dtype=torch.bool)
    vm = rand_tile(g, (B, 30, 30, 8), torch.float32, dev)
    kern = rand_kernel(g, (3, 3, 8), torch.float32, dev)
    same("event_conv_interlaced repeated coords",
         event_conv_cuda_interlaced_batched(vm, coords.to(dev), valid.to(dev),
                                            kern, event_par=4),
         event_conv_ref_interlaced_batched(vm, coords.to(dev), valid.to(dev),
                                           kern, event_par=4))

    check_threshold(g, dev, same)
    check_banked_and_emit(g, dev, same)
    check_single(g, dev, same)
    check_seq_gather(g, dev, same)
    check_interlaced_gather(g, dev, same)
    check_aeq_build(g, dev, same)
    print(f"kernels: every kernel equal to its plain version on the card "
          f"(max abs err {worst})")
    return worst


def where_differ(a, b, n: int = 6) -> str:
    """How many elements of two same-shaped tensors differ, and the first
    few of them as index: got/want."""
    bad = (a != b).nonzero()
    first = ", ".join(f"{tuple(i)}: {a[tuple(i)].item()}/{b[tuple(i)].item()}"
                      for i in bad[:n].tolist())
    return f"{len(bad)} of {a.numel()} differ; index: got/want {first}"


def rail_tile(g, shape, dtype, dev):
    """An int tile (or bias) of values at and next to its dtype's rails."""
    import torch
    info = torch.iinfo(dtype)
    vals = torch.tensor([info.min, info.min + 1, -1, 0, 1, info.max - 1,
                         info.max], dtype=dtype)
    return vals[torch.randint(0, len(vals), shape, generator=g)].to(dev)


def check_threshold(g, dev, same) -> None:
    """Phase 3, the base-mode threshold kernel: the three shapes the FULL
    forward launches (conv0 28x28x8, conv1 28x28x8 with the ragged pool 3,
    conv2 10x10x5) at B=8 and one sample, k in {1, 3, 5} (halo k // 2),
    f32/i16/i8; then tiles, biases and latches that are views at odd
    offsets (the kernel's one-channel path), ``fired_out`` passed as
    ``fired`` itself, and int tiles and biases on their rails.  vm (whole
    tiles: the plain version leaves the halo as it was), spikes and pooled
    equal the plain version."""
    import torch

    from repro_torch.kernels.threshold_pool.kernel import \
        threshold_pool_cuda_batched
    from repro_torch.kernels.threshold_pool.ref import threshold_pool_tile_ref

    def at_offset(t, off):
        """A contiguous copy of ``t`` that starts ``off`` elements into its
        storage."""
        store = torch.empty(t.numel() + off, dtype=t.dtype, device=dev)
        view = store[off:].view(t.shape)
        view.copy_(t)
        return view

    def check(tag, vm, bias, fired, pool, hh, *, off=0, alias=False):
        v_t = 0.5 if vm.dtype == torch.float32 else 20
        vm_r = vm.clone()
        sr, pr = threshold_pool_tile_ref(vm_r, bias, fired.clone(), v_t=v_t,
                                         pool=pool, halo=(hh, hh))
        vm_k, b_k, f_k = (at_offset(t, off) if off else t.clone()
                          for t in (vm, bias, fired))
        sk, pk = threshold_pool_cuda_batched(
            vm_k, b_k, f_k, v_t=v_t, pool=pool, halo=(hh, hh),
            fired_out=f_k if alias else None)
        if alias and sk.data_ptr() != f_k.data_ptr():
            fail(f"threshold_pool {tag}: fired_out is not fired")
        tag = (f"{tag} Q={vm.shape[0]} {tuple(vm.shape[1:])} {vm.dtype} "
               f"pool={pool}")
        same(f"threshold_pool vm {tag}", vm_k, vm_r)
        same(f"threshold_pool spikes {tag}", sk, sr)
        if pool is not None:
            same(f"threshold_pool pooled {tag}", pk, pr)

    dtypes = (torch.float32, torch.int16, torch.int8)
    shapes = (("conv0", 28, 8, None), ("conv1", 28, 8, 3),
              ("conv2", 10, 5, None))
    for k in (1, 3, 5):
        hh = k // 2
        for dtype in dtypes:
            for q in (B, 1):
                for name, side, c, pool in shapes:
                    vm = rand_tile(g, (q, side + 2 * hh, side + 2 * hh, c),
                                   dtype, dev)
                    bias = rand_kernel(g, (c,), dtype, dev)
                    fired = (torch.rand((q, side, side, c), generator=g)
                             < 0.1).to(dev)
                    check(f"{name} k={k}", vm, bias, fired, pool, hh)
    for dtype in dtypes:
        for name, side, c, pool in shapes:
            vm = rand_tile(g, (B, side + 2, side + 2, c), dtype, dev)
            bias = rand_kernel(g, (c,), dtype, dev)
            fired = (torch.rand((B, side, side, c), generator=g) < 0.1).to(dev)
            check(f"{name} at offset 1", vm, bias, fired, pool, 1, off=1)
            check(f"{name} at offset 3", vm, bias, fired, pool, 1, off=3)
            check(f"{name} fired_out=fired", vm, bias, fired, pool, 1,
                  alias=True)
            if dtype != torch.float32:
                check(f"{name} on the rails",
                      rail_tile(g, vm.shape, dtype, dev),
                      rail_tile(g, (c,), dtype, dev), fired, pool, 1,
                      alias=True)


def check_banked_and_emit(g, dev, same) -> None:
    """Phase 3, the fused-handoff kernels: the emit-mode threshold kernel
    at the FULL conv0 -> conv1 tiles (28x28x8) and the conv1 -> conv2
    handoff (pool 3, a 10x10 map), for B=8 and one sample and with C=5, at
    capacities 1, 16, 256, 784, the demand and above the map, relaunched
    into buffers filled with stale bits; the banked conv over carriers of
    32 input channels (truncating, empty, all set, sparse) at the conv1
    tile (30x30x8) for B=8 and one sample and at the conv2 tile (12x12x5),
    fresh and in place."""
    import torch

    from repro_torch.core.aeq import build_fused_handoff
    from repro_torch.core.event_conv import tap_matrix
    from repro_torch.core.geometry import ConvGeometry
    from repro_torch.kernels.event_conv.kernel import event_conv_cuda_banked
    from repro_torch.kernels.event_conv.ref import event_conv_ref_banked
    from repro_torch.kernels.threshold_pool.kernel import \
        threshold_pool_cuda_emit
    from repro_torch.kernels.threshold_pool.ref import threshold_pool_tile_ref

    names = ("spikes", "pooled", "masks", "count", "seg_counts")

    def emit(tag, geom, q, c, pool, caps, dtype):
        hh = geom.kh // 2
        vm = rand_tile(g, (q, 28 + 2 * hh, 28 + 2 * hh, c), dtype, dev)
        bias = rand_kernel(g, (c,), dtype, dev)
        fired = (torch.rand((q, 28, 28, c), generator=g) < 0.1).to(dev)
        v_t = 0.5 if dtype == torch.float32 else 20
        args = dict(v_t=v_t, pool=pool, halo=(hh, hh), emit_geometry=geom)
        demand = int(threshold_pool_tile_ref(vm.clone(), bias, fired, **args,
                                             emit_capacity=1)[3].max())
        for cap in sorted(set(caps) | {max(demand, 1)}):
            vm_k, vm_r = vm.clone(), vm.clone()
            outs = threshold_pool_cuda_emit(vm_k, bias, fired, **args,
                                            emit_capacity=cap)
            # stale bits: relaunch into the same buffers, filled
            for o in outs:
                if o is not None:
                    o.fill_(1)
            vm_k = vm.clone()
            outs = threshold_pool_cuda_emit(
                vm_k, bias, fired, **args, emit_capacity=cap,
                fired_out=outs[0], pooled_out=outs[1], masks_out=outs[2],
                count_out=outs[3], seg_counts_out=outs[4])
            want = threshold_pool_tile_ref(vm_r, bias, fired, **args,
                                           emit_capacity=cap)
            etag = f"{tag} Q={q} C={c} pool={pool} capacity={cap}"
            same(f"threshold_pool_emit vm {etag}", vm_k, vm_r)
            torch.cuda.synchronize()
            # name every output that differs, not only the first: whether
            # count and seg_counts differ too tells a rank from a placement
            wrong = [f"{name}: {where_differ(a, b)}"
                     for name, a, b in zip(names, outs, want)
                     if a is not None and not torch.equal(a, b)]
            if wrong:
                fail(f"threshold_pool_emit {etag}: kernel != plain version "
                     f"({'; '.join(wrong)})")
            for name, a, b in zip(names, outs, want):
                if a is not None:
                    same(f"threshold_pool_emit {name} {etag}", a, b)

    def banked(tag, geom, q, side, c, density, cap, dtype):
        hh = geom.kh // 2
        spikes = (torch.rand((q, 1, side, side, 32), generator=g)
                  < density).to(dev)
        ho = build_fused_handoff(spikes, cap, geom)
        vm = rand_tile(g, (q, side + 2 * hh, side + 2 * hh, c), dtype, dev)
        taps = tap_matrix(rand_kernel(g, (geom.kh, geom.kw, 32, c), dtype,
                                      dev))
        taps = taps.permute(2, 0, 1, 3).contiguous()
        want = event_conv_ref_banked(vm, ho.masks[0], taps, geom)
        btag = (f"{tag} Q={q} {side + 2 * hh}x{side + 2 * hh}x{c} "
                f"density={density} capacity={cap}")
        same(f"event_conv_banked {btag}",
             event_conv_cuda_banked(vm, ho.masks[0], taps, geometry=geom),
             want)
        event_conv_cuda_banked(vm, ho.masks[0], taps, geometry=geom, out=vm)
        same(f"event_conv_banked in place {btag}", vm, want)

    for k in (1, 3, 5):
        geom = ConvGeometry(k, k)
        for dtype in (torch.float32, torch.int16, torch.int8):
            tag = f"k={k} {dtype}"
            for q in (B, 1):
                for pool in (None, 3):
                    emit(tag, geom, q, 8, pool, (1, 16, 256, 784, 785), dtype)
                emit(tag, geom, q, 5, 3, (1, 100), dtype)
                # carriers: truncating, empty, all set, sparse; conv2 tile
                for density, cap in ((0.5, 256), (0.0, 256), (1.0, 784),
                                     (0.05, 256)):
                    banked(tag, geom, q, 28, 8, density, cap, dtype)
                banked(tag, geom, q, 10, 5, 0.9, 100, dtype)


def check_single(g, dev, same) -> None:
    """Phase 3, slice 3: the single-queue conv units (the gather over one
    tile, one input channel) at the FULL single-sample tiles — conv0/conv1 30x30x8 with
    256 slots (320 segment-padded at event_par 8), conv2 12x12x5 with 100
    (128 at event_par 4) — for k in {1, 3, 5} and f32/i16/i8; truncated,
    segment-padded and unpadded (mixed-group) queues; repeated coordinates
    in a group; a 30x30x32 f32 tile (115 KB) over several CTAs; in place."""
    import torch

    from repro_torch.core.aeq import build_aeq, segment_pad
    from repro_torch.core.geometry import ConvGeometry
    from repro_torch.kernels.event_conv.kernel import (
        event_conv_cuda, event_conv_cuda_interlaced)
    from repro_torch.kernels.event_conv.ref import (event_conv_ref,
                                                    event_conv_ref_interlaced)

    # (k, map side, channels, capacity, event_par, density)
    cases = [(3, 28, 8, 256, 8, 0.6), (3, 10, 5, 100, 4, 0.9),
             (1, 28, 8, 256, 8, 0.6), (5, 28, 8, 256, 8, 0.6),
             (3, 28, 32, 256, 8, 0.3), (3, 28, 8, 256, 8, 0.05)]
    for k, hw, c, cap, ep, density in cases:
        geom, hh = ConvGeometry(k, k), k // 2
        for dtype in (torch.float32, torch.int16, torch.int8):
            if c == 32 and dtype != torch.float32:
                continue
            kern = rand_kernel(g, (k, k, c), dtype, dev)
            vm = rand_tile(g, (hw + 2 * hh, hw + 2 * hh, c), dtype, dev)
            fm = (torch.rand((hw, hw), generator=g) < density).to(dev)
            q = build_aeq(fm, cap, geometry=geom)
            qp = segment_pad(q, ep, geom)
            tag = f"k={k} {hw}x{hw}x{c} {dtype} density={density}"
            same(f"event_conv_seq_single {tag}",
                 event_conv_cuda(vm, q.coords, q.valid, kern),
                 event_conv_ref(vm, q.coords, q.valid, kern))
            for name, qq in ((f"ep={ep}", qp), ("mixed-groups", q)):
                same(f"event_conv_interlaced_single {name} {tag}",
                     event_conv_cuda_interlaced(vm, qq.coords, qq.valid,
                                                kern, event_par=ep),
                     event_conv_ref_interlaced(vm, qq.coords, qq.valid, kern,
                                               event_par=ep))
            # in place, as the scheduler launches them
            want = event_conv_ref_interlaced(vm, qp.coords, qp.valid, kern,
                                             event_par=ep)
            got = vm.clone()
            event_conv_cuda_interlaced(got, qp.coords, qp.valid, kern,
                                       event_par=ep, out=got)
            same(f"event_conv_interlaced_single in place {tag}", got, want)
            want = event_conv_ref(vm, q.coords, q.valid, kern)
            got = vm.clone()
            event_conv_cuda(got, q.coords, q.valid, kern, out=got)
            same(f"event_conv_seq_single in place {tag}", got, want)
    # repeated coordinates inside column-homogeneous groups
    coords = torch.tensor([[4, 4], [4, 4], [7, 4], [4, 4]] * 4,
                          dtype=torch.int32, device=dev)
    valid = torch.tensor([1, 1, 1, 0] * 4, dtype=torch.bool, device=dev)
    vm = rand_tile(g, (30, 30, 8), torch.float32, dev)
    kern = rand_kernel(g, (3, 3, 8), torch.float32, dev)
    same("event_conv_interlaced_single repeated coords",
         event_conv_cuda_interlaced(vm, coords, valid, kern, event_par=4),
         event_conv_ref_interlaced(vm, coords, valid, kern, event_par=4))


def check_seq_gather(g, dev, same) -> None:
    """Phase 3, slice 4: the sequential conv unit over every input
    channel's queues of one (block, t) in one launch, batched
    (``event_conv_seq``) and on one tile (``event_conv_seq_single``): the
    FULL shapes (conv0: 1 input channel, 28x28 maps, 30x30x8 tiles,
    capacity 256; conv1: the same with 32; conv2: 32 input channels, 10x10
    maps, 12x12x5 tiles, capacity 100) at B=8 and one sample, f32/i16/i8
    with int weights that clip mid-queue; 4 input channels for k in {1, 3,
    5} on 3 tiles and on one; fresh and in place; repeated coordinates."""
    import torch

    from repro_torch.core.aeq import build_aeq_batched
    from repro_torch.core.geometry import ConvGeometry
    from repro_torch.kernels.event_conv.kernel import (
        event_conv_cuda, event_conv_cuda_batched)
    from repro_torch.kernels.event_conv.ref import (event_conv_ref,
                                                    event_conv_ref_batched)

    def check(tag, vm, coords, valid, kern):
        want = event_conv_ref_batched(vm, coords, valid, kern)
        same(f"event_conv_seq {tag}",
             event_conv_cuda_batched(vm, coords, valid, kern), want)
        got = vm.clone()
        event_conv_cuda_batched(got, coords, valid, kern, out=got)
        same(f"event_conv_seq in place {tag}", got, want)
        c0, v0 = coords[:, 0].contiguous(), valid[:, 0].contiguous()
        want = event_conv_ref(vm[0], c0, v0, kern)
        same(f"event_conv_seq_single {tag}",
             event_conv_cuda(vm[0], c0, v0, kern), want)
        got = vm[0].clone()
        event_conv_cuda(got, c0, v0, kern, out=got)
        same(f"event_conv_seq_single in place {tag}", got, want)

    # (name, k, C_in, map side, channels, capacity, tiles, density)
    cases = [("conv0", 3, 1, 28, 8, 256, B, 0.6),
             ("conv1", 3, 32, 28, 8, 256, B, 0.45),
             ("conv2", 3, 32, 10, 5, 100, B, 0.9)]
    cases += [(f"k={k}", k, 4, 28, 8, 256, q, 0.6) for k in (1, 3, 5)
              for q in (3, 1)]
    for name, k, c_in, side, c, cap, q, density in cases:
        geom, hh = ConvGeometry(k, k), k // 2
        for dtype in (torch.float32, torch.int16, torch.int8):
            fm = torch.rand((c_in, q, side, side), generator=g) < density
            qs = build_aeq_batched(fm.to(dev), cap, geometry=geom)
            hp = side + 2 * hh
            vm = rand_tile(g, (q, hp, hp, c), dtype, dev)
            kern = rand_kernel(g, (c_in, k, k, c), dtype, dev)
            check(f"{name} C_in={c_in} Q={q} {hp}x{hp}x{c} {dtype}", vm,
                  qs.coords, qs.valid, kern)
    # repeated coordinates in every input channel's queue
    coords = torch.tensor([[[[4, 4], [4, 4], [7, 4], [4, 4]]] * B] * 2,
                          dtype=torch.int32, device=dev)
    valid = torch.tensor([[[1, 1, 1, 0]] * B, [[1, 1, 1, 1]] * B],
                         dtype=torch.bool, device=dev)
    check("repeated coords", rand_tile(g, (B, 30, 30, 8), torch.float32, dev),
          coords, valid, rand_kernel(g, (2, 3, 3, 8), torch.float32, dev))


def check_interlaced_gather(g, dev, same) -> None:
    """Phase 3, slice 5: the interlaced conv unit over every input
    channel's queues of one (block, t) in one launch, batched
    (``event_conv_interlaced``) and on one tile
    (``event_conv_interlaced_single``): the FULL serve-plan shapes (conv0:
    1 input channel, 28x28 maps, 30x30x8 tiles, capacity 256 at event_par
    8, depth 320; conv1: the same with 32; conv2: 32 input channels, 10x10
    maps, 12x12x5 tiles, capacity 100 at event_par 4) at B=8 and one
    sample, f32/i16/i8 with int weights that clip mid-queue; 4 input
    channels for k in {1, 3, 5} on 3 tiles and on one at event_par 8, 4,
    2, 16 and 6 (6 does not divide a warp: the kernel re-reads the group);
    segment-padded and unpadded (mixed-group) queues; fresh and in place;
    repeated coordinates in homogeneous and mixed groups that differ per
    input channel."""
    import torch

    from repro_torch.core.aeq import build_aeq_batched, segment_pad
    from repro_torch.core.geometry import ConvGeometry
    from repro_torch.kernels.event_conv.kernel import (
        TILE_MAX_BYTES, TILE_MAX_PAR, event_conv_cuda_interlaced,
        event_conv_cuda_interlaced_batched)
    from repro_torch.kernels.event_conv.ref import (
        event_conv_ref_interlaced, event_conv_ref_interlaced_batched)

    def check(tag, vm, coords, valid, kern, ep):
        want = event_conv_ref_interlaced_batched(vm, coords, valid, kern,
                                                 event_par=ep)
        same(f"event_conv_interlaced {tag}", event_conv_cuda_interlaced_batched(
            vm, coords, valid, kern, event_par=ep), want)
        got = vm.clone()
        event_conv_cuda_interlaced_batched(got, coords, valid, kern,
                                           event_par=ep, out=got)
        same(f"event_conv_interlaced in place {tag}", got, want)
        if ep <= TILE_MAX_PAR and vm[0].numel() * vm.element_size() \
                <= TILE_MAX_BYTES:  # the tile path pinned, below the crossover
            same(f"event_conv_interlaced tile {tag}",
                 pinned(vm, coords, valid, kern, ep, tile=True), want)
            got = vm.clone()
            pinned(got, coords, valid, kern, ep, tile=True, out=got)
            same(f"event_conv_interlaced tile in place {tag}", got, want)
        c0, v0 = coords[:, 0].contiguous(), valid[:, 0].contiguous()
        want = event_conv_ref_interlaced(vm[0], c0, v0, kern, event_par=ep)
        same(f"event_conv_interlaced_single {tag}", event_conv_cuda_interlaced(
            vm[0], c0, v0, kern, event_par=ep), want)
        got = vm[0].clone()
        event_conv_cuda_interlaced(got, c0, v0, kern, event_par=ep, out=got)
        same(f"event_conv_interlaced_single in place {tag}", got, want)

    # (name, k, C_in, map side, channels, capacity, tiles, density, eps)
    cases = [("conv0", 3, 1, 28, 8, 256, B, 0.6, (8,)),
             ("conv1", 3, 32, 28, 8, 256, B, 0.45, (8,)),
             ("conv2", 3, 32, 10, 5, 100, B, 0.9, (4,))]
    cases += [(f"k={k}", k, 4, 28, 8, 256, q, 0.6, (8, 4, 2, 16, 6))
              for k in (1, 3, 5) for q in (3, 1)]
    for name, k, c_in, side, c, cap, q, density, eps in cases:
        geom, hh = ConvGeometry(k, k), k // 2
        for dtype in (torch.float32, torch.int16, torch.int8):
            fm = torch.rand((c_in * q, side, side), generator=g) < density
            qs = build_aeq_batched(fm.to(dev), cap, geometry=geom)
            hp = side + 2 * hh
            vm = rand_tile(g, (q, hp, hp, c), dtype, dev)
            kern = rand_kernel(g, (c_in, k, k, c), dtype, dev)
            tag = f"{name} C_in={c_in} Q={q} {hp}x{hp}x{c} {dtype}"
            for ep in eps:
                qp = segment_pad(qs, ep, geom)
                check(f"{tag} ep={ep}", vm, qp.coords.reshape(c_in, q, -1, 2),
                      qp.valid.reshape(c_in, q, -1), kern, ep)
            check(f"{tag} ep={eps[0]} mixed-groups", vm,
                  qs.coords.reshape(c_in, q, cap, 2),
                  qs.valid.reshape(c_in, q, cap),
                  kern, eps[0])
    # repeated coordinates: in column-homogeneous groups (dropped), in
    # mixed groups (applied every time), behind an invalid first copy
    hom = [[4, 4], [4, 4], [7, 4], [4, 7], [1, 1], [1, 1]]
    mix = [[1, 1], [1, 1], [2, 2], [0, 0], [2, 2], [5, 5]]
    late = [[3, 3], [3, 3], [3, 3], [6, 3], [0, 3], [3, 3]]
    coords = torch.tensor([[hom + mix, mix + late], [late + hom, hom + hom],
                           [mix + mix, late + mix]], dtype=torch.int32,
                          device=dev)
    valid = (torch.rand((3, 2, 12), generator=g) < 0.8).to(dev)
    for ep in (4, 6):
        check(f"repeated coords ep={ep}",
              rand_tile(g, (2, 12, 12, 8), torch.float32, dev), coords,
              valid, rand_kernel(g, (3, 3, 3, 8), torch.float32, dev), ep)
    check_tile_path(g, dev, same)


def pinned(vm, coords, valid, kern, ep, *, tile: bool, out=None):
    """The batched interlaced unit on the path ``tile`` pins, whatever Q:
    the wrapper's launch with its path given (``kernel._launch``)."""
    import torch

    from repro_torch.kernels.event_conv import kernel as ek
    out = torch.empty_like(vm) if out is None else out
    return ek._launch(vm, coords, valid, kern, out, ep, single=False,
                      tile=tile)


#: the offline benchmark plan's conv layers (``bench/configs/csnn_paper``):
#: (name, C_in, map side, tile channels, capacity, event_par, events per
#: sample and step over C_in x side^2 slots, PERF.md section 4)
OFFLINE_CONVS = (("conv0", 1, 28, 8, 784, 8, 221.6 / 784),
                 ("conv1", 32, 28, 8, 784, 8, 3965.6 / (32 * 784)),
                 ("conv2", 32, 10, 5, 100, 4, 860.0 / (32 * 100)))


def offline_queues(g, dev, c_in, side, cap, ep, density, q, *, pad=True):
    """coords (C_in, Q, E, 2), valid (C_in, Q, E) of random maps at a conv
    layer's offline plan: AEQs of capacity ``cap``, segment-padded at
    ``ep`` unless ``pad`` is False (mixed groups)."""
    from repro_torch.core.geometry import GEOM_3X3
    qs = queues_for(g, c_in * q, side, side, density, cap, GEOM_3X3,
                    ep if pad else 1, dev)
    return (qs.coords.reshape(c_in, q, -1, 2).contiguous(),
            qs.valid.reshape(c_in, q, -1).contiguous())


def check_tile_path(g, dev, same) -> None:
    """Phase 3: the tile path of the batched interlaced unit as the wrapper
    chooses it, at the offline plan's shapes (conv0/conv1/conv2:
    capacities 784/784/100, event_par 8/8/4, 30x30x8, 30x30x8 and 12x12x5
    tiles) at the smallest Q the rule sends to it (``tile_min_q``), f32/i16/i8 with int
    weights that clip mid-queue: segment-padded and unpadded (mixed-group)
    queues and repeated coordinates, fresh and in place, each launch
    counted as ``event_conv_interlaced_tile``; then one launch on each
    side of the crossover, each counted on its own path."""
    import torch

    from repro_torch.kernels import runtime
    from repro_torch.kernels.event_conv.kernel import (
        event_conv_cuda_interlaced_batched, sm_count, tile_min_q)
    from repro_torch.kernels.event_conv.ref import \
        event_conv_ref_interlaced_batched

    n_sm = sm_count(dev)

    def check(tag, vm, coords, valid, kern, ep):
        want = event_conv_ref_interlaced_batched(vm, coords, valid, kern,
                                                 event_par=ep)
        runtime.reset_launches()
        got = event_conv_cuda_interlaced_batched(vm, coords, valid, kern,
                                                 event_par=ep)
        same(f"event_conv_interlaced tile path {tag}", got, want)
        got = vm.clone()
        event_conv_cuda_interlaced_batched(got, coords, valid, kern,
                                           event_par=ep, out=got)
        same(f"event_conv_interlaced tile path in place {tag}", got, want)
        if (runtime.LAUNCHES["event_conv_interlaced_tile"],
                runtime.LAUNCHES["event_conv_interlaced"]) != (2, 2):
            fail(f"tile path {tag}: launches {runtime.LAUNCHES}")

    for name, c_in, side, c, cap, ep, density in OFFLINE_CONVS:
        hp = side + 2
        for dtype in (torch.float32, torch.int16, torch.int8):
            q_hi = tile_min_q(hp * hp * c * torch.empty(
                (), dtype=dtype).element_size(), n_sm)
            vm = rand_tile(g, (q_hi, hp, hp, c), dtype, dev)
            kern = rand_kernel(g, (c_in, 3, 3, c), dtype, dev)
            tag = f"{name} C_in={c_in} Q={q_hi} {hp}x{hp}x{c} {dtype} ep={ep}"
            for pad in (True, False):
                check(f"{tag}{'' if pad else ' mixed-groups'}", vm,
                      *offline_queues(g, dev, c_in, side, cap, ep, density,
                                      q_hi, pad=pad), kern, ep)
    # repeated coordinates in homogeneous, mixed and late groups
    hom = [[4, 4], [4, 4], [7, 4], [4, 7], [1, 1], [1, 1], [7, 7], [7, 7]]
    mix = [[1, 1], [1, 1], [2, 2], [0, 0], [2, 2], [5, 5], [1, 1], [8, 8]]
    late = [[3, 3], [3, 3], [3, 3], [6, 3], [0, 3], [3, 3], [9, 3], [3, 3]]
    rows = torch.tensor([hom + mix + late, late + hom + mix], dtype=torch.int32)
    q_hi = tile_min_q(12 * 12 * 8 * 4, n_sm)
    coords = rows[:, None].expand(2, q_hi, 24, 2).contiguous().to(dev)
    valid = (torch.rand((2, q_hi, 24), generator=g) < 0.8).to(dev)
    check("repeated coords", rand_tile(g, (q_hi, 12, 12, 8), torch.float32,
                                       dev),
          coords, valid, rand_kernel(g, (2, 3, 3, 8), torch.float32, dev), 8)
    # one launch on each side of the crossover
    _, c_in, side, c, cap, ep, density = OFFLINE_CONVS[1]
    q_hi = tile_min_q((side + 2) ** 2 * c * 4, n_sm)
    for q, tile in ((q_hi - 1, 0), (q_hi, 1)):
        coords, valid = offline_queues(g, dev, c_in, side, cap, ep, density, q)
        vm = rand_tile(g, (q, side + 2, side + 2, c), torch.float32, dev)
        kern = rand_kernel(g, (c_in, 3, 3, c), torch.float32, dev)
        runtime.reset_launches()
        event_conv_cuda_interlaced_batched(vm, coords, valid, kern,
                                           event_par=ep, out=vm)
        torch.cuda.synchronize()
        if (runtime.LAUNCHES["event_conv_interlaced_tile"],
                runtime.LAUNCHES["event_conv_interlaced"]) != (tile, 1):
            fail(f"conv1 at Q={q}: launches {runtime.LAUNCHES}, want the "
                 f"{'tile' if tile else 'patch'} path")
    print(f"tile path: exact at the offline shapes from the rule's least Q; "
          f"conv1 at Q={q_hi - 1} takes the patch gather, at Q={q_hi} the "
          f"tile path")


#: the batch sizes of the crossover table
CROSSOVER_QS = (8, 16, 32, 64, 128, 256, 1024)


def gather_crossover(dev, card) -> None:
    """The tile path against the patch gather at the offline plan's three
    conv shapes for Q in :data:`CROSSOVER_QS` (random maps at the layer's
    offline event density, f32): device ms of one launch (CUDA graph
    replay, patch, tile, tile, patch), which path the rule takes; then
    conv1 at Q=1024 beside its bound, the plain version and ``F.conv2d``."""
    import torch

    from repro_torch.kernels.event_conv.kernel import sm_count, tile_path
    from repro_torch.kernels.event_conv.ref import \
        event_conv_ref_interlaced_batched

    g = torch.Generator().manual_seed(28)
    tag = f"[{card}]"
    n_sm = sm_count(dev)
    for name, c_in, side, c, cap, ep, density in OFFLINE_CONVS:
        for q in CROSSOVER_QS:
            coords, valid = offline_queues(g, dev, c_in, side, cap, ep,
                                           density, q)
            vm = rand_tile(g, (q, side + 2, side + 2, c), torch.float32, dev)
            kern = rand_kernel(g, (c_in, 3, 3, c), torch.float32, dev)
            if not torch.equal(pinned(vm, coords, valid, kern, ep, tile=True),
                               pinned(vm, coords, valid, kern, ep,
                                      tile=False)):
                fail(f"crossover {name} Q={q}: the two paths differ")
            ms = {}
            for tile in (False, True, True, False):
                t = graph_time_ms(lambda: pinned(vm, coords, valid, kern, ep,
                                                 tile=tile, out=vm))
                ms.setdefault(tile, []).append(t)
            patch, tiled = (statistics.mean(ms[k]) for k in (False, True))
            rule = tile_path(q, vm[0].numel() * 4, n_sm, ep, False)
            print(f"crossover {name} Q={q} (C_in {c_in}, {side + 2}x"
                  f"{side + 2}x{c}, depth {valid.shape[-1]}, event_par {ep}, "
                  f"{int(valid.sum()) / q:.1f} events a tile): patch "
                  f"{patch:.5f} ms, tile {tiled:.5f} ms (tile/patch "
                  f"{tiled / patch:.3f}); rule takes the "
                  f"{'tile' if rule else 'patch'} path {tag}")
            if name == "conv1" and q == CROSSOVER_QS[-1]:
                plain = cuda_time_ms(
                    lambda: event_conv_ref_interlaced_batched(
                        vm, coords, valid, kern, event_par=ep), 1)
                bound, by = conv_bound(vm, [(coords, valid, kern)])
                dense = torch.zeros((c_in, q, side * side), device=dev)
                flat = (coords[..., 0].long() * side
                        + coords[..., 1].long()).clamp(min=0)
                dense.scatter_add_(2, flat, valid.float())
                dense = dense.view(c_in, q, side, side).transpose(0, 1)
                dense = dense.contiguous()
                weight = kern.permute(3, 0, 1, 2).contiguous()
                lib = graph_time_ms(lambda: torch.nn.functional.conv2d(
                    dense, weight, padding=1))
                print(f"timing event_conv_interlaced tile path (conv1, "
                      f"Q={q}, depth {valid.shape[-1]}, event_par {ep}, "
                      f"{c_in} c_in, f32): device {tiled:.5f} ms/launch, "
                      f"patch gather {patch:.5f}, plain {plain:.4f}, bound "
                      f"{bound:.6f} ({by}), conv2d {c_in} c_in {lib:.5f} "
                      f"{tag}")


def offline_launch_share(dev) -> None:
    """The offline benchmark's plan (capacities 784/784/100, channel
    blocks 8/8/5, event_par 8/8/4) on ``csnn_paper.FULL``: at B=1024 every
    batched interlaced launch takes the tile path (exact counts) and the
    forward equals the sequential unit's (``event_par=1``, the patch
    gather) exactly; one sample takes the single-queue units and never the
    tile path."""
    import torch

    from repro_torch.configs import csnn_paper
    from repro_torch.core.csnn import encode_input, init_params
    from repro_torch.core.plan import plan_network

    cfg = csnn_paper.FULL
    params = init_params(cfg, seed=0, device=dev)
    knobs = dict(capacity=[784, 784, 100], channel_block=[8, 8, 5],
                 batch_tile=8)
    plan = plan_network(cfg, event_par=[8, 8, 4], **knobs)
    seq = plan_network(cfg, event_par=1, **knobs)
    imgs = torch.rand((1024, *cfg.input_hw, cfg.input_channels),
                      generator=torch.Generator().manual_seed(28))
    spikes = encode_input(imgs.to(dev), cfg)
    launches = {}
    tiled = counted("offline plan, B=1024", lambda: forward(
        params, spikes, cfg, plan), launches,
        exact_launches(plan, cfg.t_steps, batch=1024))
    patch = counted("offline knobs at event_par=1, B=1024", lambda: forward(
        params, spikes, cfg, seq), launches,
        exact_launches(seq, cfg.t_steps, batch=1024))
    hold_same("offline plan B=1024 (tile path) vs event_par=1 (patch gather)",
              tiled, patch)
    counted("offline plan, one sample", lambda: forward(
        params, spikes[:1], cfg, plan), launches,
        exact_launches(plan, cfg.t_steps, batch=1))
    print(f"offline plan B=1024: the tile path took "
          f"{launches['event_conv_interlaced_tile']} of "
          f"{launches['event_conv_interlaced']} batched interlaced launches")


# ------------------------------------------------- the event-set builder
#: the cells' queue layers as (name, H, W, C_in, capacity, event_par,
#: input density): the paper net's three (densities as OFFLINE_CONVS in
#: tests/test_torch_gpu.py) and VGG-16's by map size (PERF.md §4)
AEQ_CASES = (
    ("paper conv0", 28, 28, 1, 784, 8, 0.28),
    ("paper conv1", 28, 28, 32, 784, 8, 0.16),
    ("paper conv2", 10, 10, 32, 100, 4, 0.27),
    ("vgg conv0", 32, 32, 3, 1024, 8, 0.586),
    ("vgg conv1", 32, 32, 64, 1024, 8, 0.0525),
    ("vgg conv2", 16, 16, 64, 256, 8, 0.0588),
    ("vgg conv4", 8, 8, 128, 64, 4, 0.0654),
    ("vgg conv8", 4, 4, 512, 16, 2, 0.0198),
    ("vgg conv10", 2, 2, 512, 4, 2, 0.0531),
)
#: the timed ones, with their batch: (case name, B)
AEQ_TIMED = (("paper conv1", 1024), ("vgg conv1", 256), ("vgg conv8", 256))


def aeq_spikes(g, kind, shape, density, dev):
    """(B, T, H, W, C) bool maps: random at ``density``, empty, full, or
    a strided view (a (T, C, B, H, W + 2) buffer sliced and permuted)."""
    import torch
    b, t, h, w, c = shape
    if kind == "empty":
        return torch.zeros(shape, dtype=torch.bool, device=dev)
    if kind == "full":
        return torch.ones(shape, dtype=torch.bool, device=dev)
    if kind == "view":
        base = (torch.rand((t, c, b, h, w + 2), generator=g) < density).to(dev)
        return base[..., 1:w + 1].permute(2, 0, 3, 4, 1)
    return (torch.rand(shape, generator=g) < density).to(dev)


def check_aeq_build(g, dev, same) -> None:
    """Phase 3: the event-set builder against its plain version (the
    composition it replaced, run on the card) at every cell's queue
    layer, B=8 and T=5: event_par 1, 2, 4, 8 and the layer's own,
    capacity H*W and half the expected demand (truncating), random maps at
    the layer's density, empty, full and a strided view; the 1x1 and 5x5
    windows at the paper's conv1 map; each call one counted launch."""
    from repro_torch.core.geometry import GEOM_3X3, ConvGeometry
    from repro_torch.kernels import runtime
    from repro_torch.kernels.aeq_build.kernel import aeq_build_cuda
    from repro_torch.kernels.aeq_build.ref import aeq_build_ref

    def check(tag, spikes, capacity, ep, geom):
        before = runtime.LAUNCHES["aeq_build"]
        got = aeq_build_cuda(spikes, capacity, ep, geom)
        if runtime.LAUNCHES["aeq_build"] != before + 1:
            fail(f"aeq_build {tag}: not one counted launch")
        want = aeq_build_ref(spikes, capacity, ep, geom)
        for part, a, b in zip(("coords", "valid", "count"), got, want):
            same(f"aeq_build {tag} {part}", a, b)

    n = 0
    for name, h, w, c, cap, ep0, density in AEQ_CASES:
        for ep in sorted({1, 2, 4, 8, ep0}):
            for kind in ("random", "empty", "full", "view"):
                spikes = aeq_spikes(g, kind, (B, 5, h, w, c), density, dev)
                for capacity in (cap, max(1, int(density * h * w) // 2)):
                    check(f"{name} ep={ep} {kind} cap={capacity}", spikes,
                          capacity, ep, GEOM_3X3)
                    n += 1
    for k in (1, 5):
        spikes = aeq_spikes(g, "random", (B, 5, 28, 28, 32), 0.16, dev)
        for capacity, ep in ((784, 8), (60, 4), (784, 1)):
            check(f"k={k} ep={ep} cap={capacity}", spikes, capacity, ep,
                  ConvGeometry(k, k))
            n += 1
    print(f"aeq_build: {n} launches equal to the plain version")


def aeq_build_timing(dev, card) -> list:
    """Phase 7: device ms of one builder launch (CUDA graph replay) at the
    paper cell's conv1 (B=1024) and VGG's conv1 and conv8 (B=256), T=5, at
    the layers' densities, beside its bound (the spike bytes read and the
    queue bytes written once, at the HBM peak) and its plain version on
    the card, which is the torch glue it replaced (``build_aeq_batched``,
    ``segment_pad``, the permutes); returns the kernel records."""
    import torch

    from repro_torch.core.aeq import interlaced_capacity
    from repro_torch.kernels.aeq_build.kernel import aeq_build_cuda
    from repro_torch.kernels.aeq_build.ref import aeq_build_ref
    from repro_torch.tune.crosscheck import roofline_seconds

    g = torch.Generator().manual_seed(30)
    cases = {case[0]: case for case in AEQ_CASES}
    records = []
    for name, b in AEQ_TIMED:
        _, h, w, c, cap, ep, density = cases[name]
        spikes = aeq_spikes(g, "random", (b, 5, h, w, c), density, dev)
        slots = 5 * c * b * interlaced_capacity(cap, ep)
        nbytes = spikes.numel() + 9 * slots + 4 * 5 * b * c
        bound, by = roofline_seconds(nbytes, 0)
        ms = graph_time_ms(lambda: aeq_build_cuda(spikes, cap, ep), 20)
        plain = cuda_time_ms(lambda: aeq_build_ref(spikes, cap, ep), 3)
        print(f"aeq_build {name} B={b}: {ms:.5f} device ms a launch, bound "
              f"{bound * 1e3:.5f} ms ({by}; {nbytes / 1e6:.1f} MB, "
              f"{100 * bound * 1e3 / ms:.1f} % of it), plain version (the "
              f"replaced glue) {plain:.4f} ms, {plain / ms:.1f}x; {card}")
        records.append(dict(name=f"aeq_build {name} B={b}", route="cuda",
                            source="src/repro_torch/kernels/csrc/aeq_build.cu",
                            replaces=None, ms=ms, plain_ms=plain,
                            bound_ms=bound * 1e3, bound_by=by,
                            library_ms=None))
    return records


def aeq_build_main() -> int:
    """``--aeq-build``: build, phase 3's builder check, its timing, then
    the offline paper plan at B=1024 and the VGG phase with their exact
    launch counts (the builder once per queue layer a forward)."""
    import torch

    from repro_torch.kernels import runtime
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"build: {runtime.build_all():.1f} s")
    for line in runtime.BUILD_LOGS.get("aeq_build", "").splitlines():
        if "Used" in line or "spill" in line:
            print(f"ptxas aeq_build: {line.strip()}")
    g = torch.Generator().manual_seed(12)

    def same(name, a, b):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            fail(f"{name}: kernel != plain version ({where_differ(a, b)})")

    t0 = time.perf_counter()
    check_aeq_build(g, dev, same)
    print(f"aeq_build check: {time.perf_counter() - t0:.1f} s")
    aeq_build_timing(dev, card)
    offline_launch_share(dev)
    vgg_phase(dev, card)
    print(json.dumps({"ok": True}))
    return 0


def crossover_main() -> int:
    """``--crossover``: build, hold the interlaced unit (both paths)
    against its plain version (:func:`check_interlaced_gather`), print the
    crossover table (:func:`gather_crossover`)."""
    import torch

    from repro_torch.kernels import runtime
    # full-float32 yardstick (F.conv2d), as in the whole run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"build: {runtime.build_all():.1f} s")
    for line in runtime.BUILD_LOGS.get("event_conv", "").splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas event_conv: {line.strip()}")

    def same(name, a, b):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            fail(f"{name}: kernel != plain version ({where_differ(a, b)})")

    t0 = time.perf_counter()
    check_interlaced_gather(torch.Generator().manual_seed(11), dev, same)
    print(f"interlaced unit exact on both paths in "
          f"{time.perf_counter() - t0:.1f} s")
    gather_crossover(dev, card)
    offline_launch_share(dev)
    print(json.dumps({"ok": True}))
    return 0


# ------------------------------------------------------------ VGG phase
#: the offline VGG cell's batch (``bench/traffic/offline-cifar-b256.json``)
VGG_BATCH = 256


def bench_config():
    """The benchmark's file finder (``bench/harness/config.py``), with
    ``bench/`` on the path; nothing of it imports JAX."""
    bench = str(ROOT / "bench")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from harness import config
    return config


def layer_trace(events, n_layers: int) -> list:
    """Per conv layer of one profiled forward: host ms of its
    ``csnn.conv<i>.queues`` and ``csnn.conv<i>.launches`` spans, the union
    of device us launched under ``csnn.conv<i>`` (a launch belongs to the
    span its runtime call starts in: the call and the kernel share a
    correlation id) and the conv unit's path: "tile" or "patch" by the
    gather kernels' names."""
    from yardstick import stats

    def device(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    ranges = [(e.name, float(e.time_range.start), float(e.time_range.end))
              for e in events if e.name.startswith("csnn.") and not device(e)]
    calls = {e.id: float(e.time_range.start) for e in events
             if not device(e) and e.name.startswith(("cuda", "cu"))}
    kernels = [(e.id, e.name, float(e.time_range.start),
                float(e.time_range.end)) for e in events if device(e)]
    out = []
    for i in range(n_layers):
        name = f"csnn.conv{i}"
        outer = [(s, e) for n, s, e in ranges if n == name]
        host = {k: sum(e - s for n, s, e in ranges if n == f"{name}.{k}")
                / 1e3 for k in ("queues", "launches")}
        mine = [(n, s, e) for corr, n, s, e in kernels
                if corr in calls and any(a <= calls[corr] <= b
                                         for a, b in outer)]
        gathers = {n for n, _, _ in mine if "event_conv_gather_kernel" in n}
        path = ("tile" if all("_tile" in n for n in gathers) else
                "patch" if not any("_tile" in n for n in gathers) else
                "both") if gathers else "none"
        out.append({"layer": i, "queues_ms": host["queues"],
                    "launches_ms": host["launches"],
                    "device_us": stats.covered([(s, e) for _, s, e in mine]),
                    "path": path})
    return out


def vgg_forward_times(dev, params, spikes, cfg, plan, reps: int = 5):
    """(ms a forward, host ms to enqueue one) over ``reps`` forwards
    back to back after one warm forward."""
    import torch

    from repro_torch.core.csnn import snn_apply_batched
    snn_apply_batched(params, spikes, cfg, plan, collect_stats=False)
    torch.cuda.synchronize(dev)
    enqueue = []
    t0 = time.perf_counter()
    for _ in range(reps):
        t1 = time.perf_counter()
        snn_apply_batched(params, spikes, cfg, plan, collect_stats=False)
        enqueue.append(time.perf_counter() - t1)
    torch.cuda.synchronize(dev)
    return ((time.perf_counter() - t0) / reps * 1e3,
            statistics.median(enqueue) * 1e3)


def vgg_phase(dev, card) -> dict:
    """VGG-16 (``configs.csnn_vgg16.FULL``) at B=256 under its pinned plan,
    on the offline cell's weights (``bench/builders/csnn_gain.py``, seed
    2**31 + 29) and its first 256 pool images: exact launch counts
    (``exact_launches``: 390 conv + 390 threshold, every conv on the tile
    path), the logits bit for bit the benchmark's float64 reference,
    distinct from row to row, each layer's input density; per layer the
    host ms of ``csnn.conv<i>.queues`` and ``.launches``, the device us
    launched under the layer and the conv unit's path; the memory peak,
    ms a forward, host enqueue ms, samples/s and busy share; then the
    same at channel block 8 on the two 32x32 layers (their tiles over the
    tile path's limit: the patch gather), held equal and timed beside."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import csnn_vgg16
    from repro_torch.core.csnn import encode_input, snn_apply_batched
    from repro_torch.core.plan import plan_network

    config = bench_config()
    from yardstick import counts, stats
    conf = json.loads((config.BENCH_DIR / "configs"
                       / "csnn_vgg16_cifar.json").read_text())
    traffic = json.loads((config.BENCH_DIR / "traffic"
                          / "offline-cifar-b256.json").read_text())
    builder = config.load_path(conf["builder"])
    reference = config.load_path(conf["reference"])
    builder.check_program(conf)
    net = conf["network"]
    cfg = csnn_vgg16.FULL
    plan = plan_network(cfg, **csnn_vgg16.PLAN)
    params = builder.weights(conf, 2**31 + 29, dev)
    gen = config.load_module("generators", traffic["inputs"]["generator"])
    imgs = gen.generate(traffic["inputs"], net).data[:VGG_BATCH].to(dev)
    spikes = encode_input(imgs, cfg)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    launches = {}
    logits = counted(f"VGG-16 offline plan, B={VGG_BATCH}",
                     lambda: snn_apply_batched(params, spikes, cfg, plan,
                                               collect_stats=False),
                     launches, exact_launches(plan, cfg.t_steps,
                                              batch=VGG_BATCH))
    peak = torch.cuda.max_memory_allocated(dev)
    want = reference.forward(params, reference.encode(imgs, cfg.t_steps),
                             net)
    if not torch.equal(logits, want.logits):
        fail(f"VGG-16 B={VGG_BATCH}: logits differ from the float64 "
             f"reference ({where_differ(logits, want.logits)})")
    distinct = len({tuple(r) for r in logits.cpu().tolist()})
    if distinct < VGG_BATCH // 2:
        fail(f"VGG-16: only {distinct} distinct logit rows of {VGG_BATCH}")
    shapes = [s for s in counts.layer_shapes(net) if s["kind"] == "conv"]
    density = [float(ev.double().sum()) / (
        VGG_BATCH * cfg.t_steps * s["in_hw"][0] * s["in_hw"][1] * s["c_in"])
        for ev, s in zip(want.conv_events, shapes)]
    adds = float(counts.sample_adds(want.conv_events, want.head_events,
                                    net).mean())
    print(f"VGG-16 B={VGG_BATCH}: logits == float64 reference bit for bit, "
          f"{distinct} distinct rows; {plan.kernel_launches} launches a "
          f"forward; {adds:.0f} synaptic adds a sample; input density per "
          f"layer {[round(100 * d, 3) for d in density]} %")
    if min(density) < 0.01:
        fail(f"VGG-16: a layer receives under 1 % input density: {density}")

    def fwd():
        return snn_apply_batched(params, spikes, cfg, plan,
                                 collect_stats=False)

    fwd()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd()
        torch.cuda.synchronize(dev)
    layers = layer_trace(prof.events(), len(plan.layers))
    for row in layers:
        lp = plan.layers[row["layer"]]
        print(f"VGG-16 conv{row['layer']:<2d} {lp.in_hw[0]:2d}x{lp.in_hw[1]:<2d}"
              f" {lp.c_in:3d}->{lp.c_out:3d} cb {lp.channel_block:3d}: "
              f"queues {row['queues_ms']:8.3f} ms, launches "
              f"{row['launches_ms']:8.3f} ms (host); device "
              f"{row['device_us'] / 1e3:8.3f} ms; path {row['path']}")
    if any(row["path"] != "tile" for row in layers):
        fail("VGG-16: a layer's conv unit left the tile path: "
             f"{[row['path'] for row in layers]}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd()
        fwd()
        torch.cuda.synchronize(dev)
    busy = [(float(e.time_range.start), float(e.time_range.end))
            for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    lo, hi = min(s for s, _ in busy), max(e for _, e in busy)
    busy_share = stats.covered(busy) / (hi - lo)
    ms, enq = vgg_forward_times(dev, params, spikes, cfg, plan)
    print(f"VGG-16 B={VGG_BATCH} ({card}): {ms:.3f} ms a forward, "
          f"{VGG_BATCH / ms * 1e3:.1f} samples/s, host enqueue {enq:.3f} ms, "
          f"busy {100 * busy_share:.2f} % over two forwards, memory peak "
          f"{peak} B")

    knobs = dict(csnn_vgg16.PLAN)
    knobs["channel_block"] = [8, 8] + knobs["channel_block"][2:]
    wide = plan_network(cfg, **knobs)
    got = counted(f"VGG-16 at channel block 8 on the 32x32 layers, "
                  f"B={VGG_BATCH}",
                  lambda: snn_apply_batched(params, spikes, cfg, wide,
                                            collect_stats=False),
                  launches, exact_launches(wide, cfg.t_steps,
                                           batch=VGG_BATCH))
    if not torch.equal(got, logits):
        fail("VGG-16 at channel block 8 differs from the pinned plan")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        snn_apply_batched(params, spikes, cfg, wide, collect_stats=False)
        torch.cuda.synchronize(dev)
    wide_layers = layer_trace(prof.events(), 2)
    wms, wenq = vgg_forward_times(dev, params, spikes, cfg, wide)
    print(f"VGG-16 at channel block 8 on conv0/conv1: {wms:.3f} ms a "
          f"forward (pinned plan {ms:.3f}), host enqueue {wenq:.3f} ms; "
          + "; ".join(f"conv{r['layer']} device {r['device_us'] / 1e3:.3f} "
                      f"ms on the {r['path']} path (pinned "
                      f"{layers[r['layer']]['device_us'] / 1e3:.3f} ms)"
                      for r in wide_layers))
    return {"batch": VGG_BATCH, "launches": plan.kernel_launches,
            "adds_per_sample": adds, "density": density, "layers": layers,
            "ms_per_forward": ms, "enqueue_ms": enq,
            "samples_per_s": VGG_BATCH / ms * 1e3, "busy_share": busy_share,
            "memory_peak_bytes": peak, "cb8_ms_per_forward": wms,
            "cb8_layers": wide_layers, "card": card}


#: the converted VGG's training: synthetic images (seed 0, not the
#: cell's pool), AdamW steps of 64 images and their peak learning rate
#: (``conversion.fit_ann``)
VGG_TRAIN_N, VGG_TRAIN_STEPS, VGG_TRAIN_LR = 4096, 2000, 1e-3


def vgg_converted(dev) -> dict:
    """Activity of a VGG-16 trained and converted by the port's own path
    beside the benchmark's drawn-and-gained one: ``conversion.fit_ann``
    trains the clamped-ReLU ANN of ``csnn_vgg16.FULL`` on ``synth_cifar``
    images (seed 0) and their labels, ``normalize_params`` balances its
    thresholds; on the cell's first 256 pool images, each conv layer's
    input density and fired share at the last step in the float64
    reference (``bench/gains.layer_walk`` at the weights as they are),
    and the synaptic adds a sample, for both networks; the ANN's and the
    converted SNN's accuracy on 512 other images (seed 2)."""
    import torch

    from repro_torch.configs import csnn_vgg16
    from repro_torch.core.conversion import (ann_accuracy, fit_ann,
                                             normalize_params)
    from repro_torch.core.csnn import (encode_input, init_params,
                                       snn_apply_batched)
    from repro_torch.core.plan import plan_network

    config = bench_config()
    from yardstick import cifar, counts
    conf = json.loads((config.BENCH_DIR / "configs"
                       / "csnn_vgg16_cifar.json").read_text())
    traffic = json.loads((config.BENCH_DIR / "traffic"
                          / "offline-cifar-b256.json").read_text())
    gains = config.load_path("gains.py")
    reference = config.load_path(conf["reference"])
    net, cfg = conf["network"], csnn_vgg16.FULL
    gen = config.load_module("generators", traffic["inputs"]["generator"])
    rows = gen.generate(traffic["inputs"], net).data[:VGG_BATCH].to(dev)
    xtr, ytr = cifar.synth_cifar(VGG_TRAIN_N, seed=0)
    xte, yte = cifar.synth_cifar(512, seed=2)
    t0 = time.perf_counter()
    ann = fit_ann(init_params(cfg, seed=0, device=dev), cfg, xtr, ytr,
                  steps=VGG_TRAIN_STEPS, lr=VGG_TRAIN_LR, log_every=500)
    acc_ann = ann_accuracy(ann, cfg, xte, yte)
    train_s = time.perf_counter() - t0
    snn = normalize_params(ann, torch.from_numpy(xtr[:256]).to(dev), cfg)
    plan = plan_network(cfg, **csnn_vgg16.PLAN)
    preds = torch.cat([snn_apply_batched(
        snn, encode_input(torch.from_numpy(xte[i:i + 256]).to(dev), cfg),
        cfg, plan, collect_stats=False).argmax(-1).cpu()
        for i in range(0, len(xte), 256)])
    acc_snn = float((preds == torch.from_numpy(yte).long()).double().mean())
    drawn = config.load_path(conf["builder"]).weights(conf, 2**31 + 29, dev)
    out = {"train_images": VGG_TRAIN_N, "train_steps": VGG_TRAIN_STEPS,
           "train_lr": VGG_TRAIN_LR, "train_s": train_s,
           "ann_accuracy": acc_ann, "snn_accuracy": acc_snn}
    for label, params, bits in (("converted", snn, 40),
                                ("drawn", drawn, conf["init"]["grid_bits"])):
        walk = gains.layer_walk(params, rows, net, [0] * len(cfg.layers[:-1]),
                                bits)
        ref = reference.forward(params, reference.encode(rows, cfg.t_steps),
                                net)
        adds = float(counts.sample_adds(ref.conv_events, ref.head_events,
                                        net).mean())
        out[label] = {"density": walk["density"], "fired": walk["fired"],
                      "adds_per_sample": adds}
        print(f"VGG-16 {label}: input density per layer "
              f"{[round(100 * d, 3) for d in walk['density']]} %; fired "
              f"share at the last step {[round(100 * f, 2) for f in walk['fired']]}"
              f" %; {adds:.0f} synaptic adds a sample")
    print(f"VGG-16 converted: ANN {100 * acc_ann:.1f} %, SNN "
          f"{100 * acc_snn:.1f} % on 512 held-out images ({VGG_TRAIN_STEPS} "
          f"steps at lr {VGG_TRAIN_LR:g} on {VGG_TRAIN_N} images, "
          f"{train_s:.1f} s)")
    return out


def vgg_main() -> int:
    """``--vgg``: build, then the VGG phase alone, and the activity of a
    trained and converted VGG-16 beside it (``vgg_converted``); the
    readings also go to ``results/vgg_smoke.json``."""
    import torch

    from repro_torch.kernels import runtime
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"build: {runtime.build_all():.1f} s")
    t0 = time.perf_counter()
    out = vgg_phase(dev, card)
    out["converted"] = vgg_converted(dev)
    print(f"VGG phase: {time.perf_counter() - t0:.1f} s")
    (ROOT / "results").mkdir(exist_ok=True)
    (ROOT / "results" / "vgg_smoke.json").write_text(json.dumps(out))
    print(json.dumps({"ok": True}))
    return 0


# -------------------------------------------------------------- phase 3b
SANITIZER_TIMEOUT_S = 600


def audit_phase(card: str) -> None:
    """Phase 3b: the port's auditor (``repro_torch.analysis``) in process,
    the kernel audit launching every CUDA kernel under red zones; then the
    kernel pass again under ``compute-sanitizer --tool memcheck`` in a
    subprocess (``PYTORCH_NO_CUDA_MEMORY_CACHING=1``, so an overrun cannot
    land unseen inside another block of PyTorch's caching allocator).

    Fails on any finding, on a kernel the audit never launched, on a
    ``compute-sanitizer`` missing beside ``nvcc`` or on memcheck errors.
    Where the sanitizer reports that it does not support the card (it
    cannot attach through some container runtimes), the phase prints
    that line and the red-zone audit above stands in for memcheck.
    """
    from repro_torch.analysis.contracts import run_contracts
    from repro_torch.analysis.hazards import run_hazards
    from repro_torch.analysis.kernel_audit import KERNELS, run_kernel_audit
    from repro_torch.analysis.lint import run_lint
    from repro_torch.analysis.selftest import run_selftest
    from repro_torch.kernels import runtime

    for name, run in (("contracts", run_contracts), ("hazards", run_hazards),
                      ("kernels", lambda: run_kernel_audit(device="cuda")),
                      ("lint", run_lint), ("selftest", run_selftest)):
        runtime.reset_launches()
        t0 = time.perf_counter()
        rep = run()
        seconds = time.perf_counter() - t0
        rules = ", ".join(f"{r} {n}" for r, n in sorted(rep.checked.items()))
        print(f"audit {name}: {len(rep.findings)} finding(s) in "
              f"{seconds:.2f} s [{card}]: {rules}")
        if not rep.ok:
            fail(f"audit {name}:\n{rep.summary()}")
        if name == "kernels":
            print("audit kernels: launches " + ", ".join(
                f"{k} {runtime.LAUNCHES[k]}" for k in KERNELS))
            idle = [k for k in KERNELS if runtime.LAUNCHES[k] == 0]
            if idle:
                fail(f"audit kernels: no launch of {idle}")
    sanitizer = Path(runtime._nvcc()).parent / "compute-sanitizer"
    if not sanitizer.exists():
        fail(f"compute-sanitizer not found beside nvcc ({sanitizer})")
    cmd = [str(sanitizer), "--tool", "memcheck", "--leak-check", "no",
           "--error-exitcode", "1", sys.executable, "-m",
           "repro_torch.analysis", "--only", "kernels", "--device", "cuda"]
    env = dict(os.environ, PYTHONPATH=str(SRC),
               PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=SANITIZER_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    summary = [ln.strip() for ln in out.splitlines() if "ERROR SUMMARY" in ln]
    refused = [ln.strip() for ln in out.splitlines()
               if "Device not supported" in ln]
    print(f"memcheck: {summary[-1] if summary else 'no ERROR SUMMARY line'}, "
          f"exit {proc.returncode}, {seconds:.1f} s wall [{card}]")
    if refused:
        print(f"memcheck: {refused[0]} -- compute-sanitizer cannot attach to "
              f"this card here; the red-zone kernel audit above stands in")
    elif (proc.returncode != 0 or not summary
          or "ERROR SUMMARY: 0 errors" not in summary[-1]):
        fail(f"memcheck of the kernel audit:\n{out[-4000:]}")


# --------------------------------------------------------------- phase 4
def forward(params, spikes, cfg, plan):
    """``snn_apply_batched``'s steps in one chunk, keeping the state;
    ``spikes`` may be a ``StreamState`` of ingested events."""
    from repro_torch.core.aeq import StreamState
    from repro_torch.core.csnn import init_state, snn_readout, snn_step_chunk
    batch = (spikes.banks if isinstance(spikes, StreamState)
             else spikes).shape[0]
    state = init_state(params, cfg, plan, batch)
    state, stats = snn_step_chunk(params, state, spikes, cfg, plan,
                                  collect_stats=True)
    return snn_readout(params, state, cfg, plan), stats, state


def hold(name, got, want) -> None:
    """Card run vs the CPU plain path: spikes, counts, state exact."""
    import torch
    (lg, sg, stg), (lw, sw, stw) = got, want
    lg = lg.cpu()
    for i, (a, b) in enumerate(zip(sg, sw)):
        for f in ("in_spike_counts", "out_spike_counts"):
            if not torch.equal(getattr(a, f).cpu(), getattr(b, f)):
                fail(f"{name}: layer {i} {f} differ from the CPU plain path")
        if not torch.allclose(a.in_sparsity.cpu(), b.in_sparsity):
            fail(f"{name}: layer {i} in_sparsity differs")
    for i, (a, b) in enumerate(zip(stg.convs, stw.convs)):
        if not (torch.equal(a.vm.cpu(), b.vm) and torch.equal(a.fired.cpu(), b.fired)):
            fail(f"{name}: layer {i} carried vm/fired differ")
    if not torch.equal(stg.fc_drive.cpu(), stw.fc_drive):
        fail(f"{name}: FC drive (output spike counts) differs")
    if not torch.allclose(lg, lw, **LOGIT_TOL):
        fail(f"{name}: logits differ by {(lg - lw).abs().max().item()}")
    if not torch.equal(lg.argmax(-1), lw.argmax(-1)):
        fail(f"{name}: argmax differs")
    if not torch.isfinite(lg).all() or lg.shape != lw.shape:
        fail(f"{name}: logits not finite or misshapen")
    print(f"{name}: card == CPU plain path (spikes, counts, state exact; "
          f"logit max diff {(lg - lw).abs().max().item():.3g}); "
          f"classes {lg.argmax(-1).tolist()}")


def hold_same(name, got, want) -> None:
    """Two card runs of one network: spikes, counts, carried state and FC
    drive exact."""
    import torch
    (_, sg, stg), (_, sw, stw) = got, want
    for i, (a, b) in enumerate(zip(sg, sw)):
        for f in ("in_spike_counts", "out_spike_counts"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                fail(f"{name}: layer {i} {f} differ")
    for i, (a, b) in enumerate(zip(stg.convs, stw.convs)):
        if not (torch.equal(a.vm, b.vm) and torch.equal(a.fired, b.fired)):
            fail(f"{name}: layer {i} carried vm/fired differ")
    if not torch.equal(stg.fc_drive, stw.fc_drive):
        fail(f"{name}: FC drive differs")
    print(f"{name}: equal (spikes, counts, state, FC drive exact)")


# The conv unit each resolved variant launches (a batch of one takes the
# single-queue kernels of the queue variants).
CONV_KERNEL = {"sequential": "event_conv_seq",
               "interlaced-cuda": "event_conv_interlaced",
               "banked-cuda": "event_conv_banked",
               "fused-handoff": "event_conv_banked"}
BATCHED_PATHS = ("serve plan (interlaced)", "event_par=1 (sequential)",
                 "fused-handoff", "banked-cuda")


def exact_launches(plan, steps, *, batch=B, emit=True, buckets=(),
                   chunk=None) -> dict:
    """Launches of each kernel in ``steps`` time steps under ``plan``,
    derived from its layers' resolved variants: each conv layer launches
    its conv unit and its threshold unit once per (channel block, time
    step) over all input channels, and a queue layer (sequential or
    interlaced) the event-set builder once per chunk of ``chunk`` steps
    (``plan.chunk_steps`` by default; ``snn_apply`` runs whole-T),
    streamed input layers included.  A batch of one
    takes the single-queue kernels of the queue variants.  With ``emit``
    (the batched runners; ``snn_apply`` emits nothing), a layer whose
    consumer resolves to ``"fused-handoff"`` thresholds through the emit
    kernel, every other layer through the base mode.  With ``buckets``
    (the continuous engine at one time step per chunk: each chunk's
    occupancy bucket), the sum of one step per chunk at that bucket."""
    if buckets:
        out = {}
        for b in buckets:
            for k, n in exact_launches(plan, 1, batch=b, emit=emit).items():
                out[k] = out.get(k, 0) + n
        return out
    import torch

    from repro_torch.kernels.event_conv.kernel import sm_count, tile_path
    out = {}
    chunks = -(-steps // (chunk or plan.chunk_steps))
    nxt = [lp.resolve_variant() for lp in plan.layers[1:]] + [None]
    for lp, consumer in zip(plan.layers, nxt):
        n = steps * lp.c_out // lp.channel_block
        variant = lp.resolve_variant()
        conv = CONV_KERNEL[variant]
        if variant in ("sequential", "interlaced-cuda"):
            out["aeq_build"] = out.get("aeq_build", 0) + chunks
        if batch == 1 and variant in ("sequential", "interlaced-cuda"):
            conv += "_single"
        thr = ("threshold_pool_emit" if emit and consumer == "fused-handoff"
               else "threshold_pool")
        keys = [conv, thr]
        tile_bytes = math.prod(lp.vm_tile) * torch.empty(
            (), dtype=lp.vm_dtype).element_size()
        if variant == "interlaced-cuda" and tile_path(
                batch, tile_bytes, sm_count(torch.device("cuda", 0)),
                lp.event_par, batch == 1):
            keys.append("event_conv_interlaced_tile")
        for k in keys:
            out[k] = out.get(k, 0) + n
    return out


def counted(path, fn, launches, exact):
    """Run ``fn`` from launch counters set to 0 and return its result;
    fail unless it launched every kernel of ``exact`` exactly ``exact[k]``
    times and no other kernel (``exact``: a dict, or a function giving it
    after the run).  The JSON line reports each kernel's count from the
    first run that launched it."""
    import torch

    from repro_torch.kernels import runtime
    runtime.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(runtime.LAUNCHES)
    if callable(exact):
        exact = exact()
    print(f"launches, {path}: {counts}")
    kernels = {k for k, n in exact.items() if n}
    if not kernels or kernels - counts.keys():
        fail(f"the {path} path expects kernels {sorted(kernels)}")
    for k, n in counts.items():
        if k not in kernels and n:
            fail(f"kernel {k} was launched {n}x on the {path} path")
        if k in kernels and n != exact[k]:
            fail(f"kernel {k} was launched {n}x on the {path} path, not "
                 f"{exact[k]}x (once per (channel block, time step))")
        if k in kernels:
            launches.setdefault(k, n)
    return out


def to_cpu(p):
    return {k: {n: t.cpu() for n, t in v.items()} for k, v in p.items()}


def to_card(p, dev):
    return {k: {n: t.to(dev) for n, t in v.items()} for k, v in p.items()}


def main_path(dev, cfg, wcfg):
    """Phases 4-5: the batched main paths on the card, each held against
    the CPU plain path.  Returns (launch counts per kernel, params,
    images, plans by path name, the serve plan's card run)."""
    import torch

    from repro_torch.core.csnn import ConvSpec, encode_input, init_params
    from repro_torch.core.plan import plan_network

    params = init_params(cfg, seed=0, device=dev)
    h, w = cfg.input_hw
    imgs = torch.rand((B, h, w, cfg.input_channels),
                      generator=torch.Generator().manual_seed(1))
    spikes = encode_input(imgs.to(dev), cfg)
    knobs = dict(capacity=256, channel_block=8, batch_tile=8)
    n_conv = sum(isinstance(s, ConvSpec) for s in cfg.layers)
    plans = dict(zip(BATCHED_PATHS, (
        plan_network(cfg, event_par=None, **knobs),
        plan_network(cfg, event_par=1, **knobs),
        plan_network(cfg, variant=["fused-handoff"] * n_conv, **knobs),
        plan_network(cfg, variant=["banked-cuda"] * n_conv, **knobs))))
    print(f"serve plan:\n{plans['serve plan (interlaced)']}")
    got, launches, cpu = {}, {}, {}
    for path in BATCHED_PATHS:
        got[path] = counted(path, lambda p=plans[path]: forward(
            params, spikes, cfg, p), launches,
            exact_launches(plans[path], cfg.t_steps))
    for path, plan in plans.items():
        cpu[path] = forward(to_cpu(params), spikes.cpu(), cfg, plan)
        hold(f"csnn_paper.FULL {path}", got[path], cpu[path])
    serve = got["serve plan (interlaced)"]
    for path in ("fused-handoff", "banked-cuda"):
        hold_same(f"csnn_paper.FULL {path} vs serve plan (card)", got[path],
                  serve)
    # again: the caching allocator hands the first run's freed carrier
    # blocks back, so bits left stale by the emit kernel would show here
    hold_same("csnn_paper.FULL fused-handoff, second run",
              forward(params, spikes, cfg, plans["fused-handoff"]),
              got["fused-handoff"])
    check_fc_capacity(params, spikes, cfg, plans["serve plan (interlaced)"],
                      got["serve plan (interlaced)"],
                      cpu["serve plan (interlaced)"])
    wparams = init_params(wcfg, seed=0, device=dev)
    wspikes = encode_input(imgs.to(dev), wcfg)
    for name, variant, ep in (("serve plan", None, None),
                              ("fused-handoff", "fused-handoff", 1)):
        wplan = plan_network(wcfg, capacity=256, channel_block=8,
                             event_par=ep, variant=variant)
        hold(f"csnn_wide.FULL {name}", forward(wparams, wspikes, wcfg, wplan),
             forward(to_cpu(wparams), wspikes.cpu(), wcfg, wplan))
    return launches, params, imgs, plans, serve


def check_fc_capacity(params, spikes, cfg, plan, card, cpu) -> None:
    """The event-driven sparse FC head on the serve plan's run: a queue
    sized by ``calibrate_capacity(drive_active_counts(...))`` and a
    truncating one over tied counts, each through ``snn_apply_batched`` on
    the card and held against the CPU plain path's readout of the same
    (already held equal) state.  The kept drive entries are compared
    exactly (the head with W = I returns its compacted operand); the
    calibrated queue's logits equal the dense head's exactly."""
    import dataclasses

    import torch

    from repro_torch.core.aeq import calibrate_capacity
    from repro_torch.core.csnn import snn_apply_batched, snn_readout
    from repro_torch.core.sparse_ffn import (drive_active_counts,
                                             event_readout)
    state_g, state_c = card[2], cpu[2]
    active = drive_active_counts(state_g.fc_drive)
    d = state_g.fc_drive.shape[-1]
    calibrated = min(calibrate_capacity(active), d)
    truncating = max(1, int(active.min()) // 2)
    eye = torch.eye(d)
    for name, cap in (("calibrated", calibrated), ("truncating", truncating)):
        fplan = dataclasses.replace(plan, fc_capacity=cap)
        got = snn_apply_batched(params, spikes, cfg, fplan,
                                collect_stats=False).cpu()
        want = snn_readout(to_cpu(params), state_c, cfg, fplan)
        kept_g = event_readout(state_g.fc_drive, eye.to(state_g.fc_drive.device),
                               capacity=cap).cpu()
        kept_c = event_readout(state_c.fc_drive, eye, capacity=cap)
        if not torch.equal(kept_g, kept_c):
            fail(f"fc_capacity {name} ({cap}): the card keeps other drive "
                 f"entries than the CPU plain path")
        if not (torch.allclose(got, want, **LOGIT_TOL)
                and torch.equal(got.argmax(-1), want.argmax(-1))):
            fail(f"fc_capacity {name} ({cap}): logits differ from the CPU "
                 f"plain path by {(got - want).abs().max().item()}")
        if name == "calibrated" and not torch.equal(got, card[0].cpu()):
            fail(f"fc_capacity {cap} covers every drive entry "
                 f"(max {int(active.max())}) but differs from the dense head")
        print(f"fc_capacity {name} = {cap} (active drive entries "
              f"{active.tolist()}): card == CPU plain path (kept entries "
              f"exact, logit max diff {(got - want).abs().max().item():.3g})")


def single_path(dev, cfg, params, plans, launches):
    """Phases 4-5, slice 3: ``snn_apply`` (one sample) on 8
    ``synth_digits`` images under the serve plan, event_par=1 and the
    fused-handoff and banked-cuda pins; each run held against the CPU
    plain path (stats exact, logits within tolerance, argmax equal) and
    the card's ``snn_apply_batched`` on the same 8 images (stats exact,
    logits within tolerance).  ``snn_apply_dense`` on the card holds
    the argmax of runs at a covering capacity.  Returns the encoded images
    (B, T, H, W, 1) on the card."""
    import torch

    from repro_torch.core.csnn import (encode_input, snn_apply,
                                       snn_apply_batched, snn_apply_dense)
    from repro_torch.core.plan import plan_network
    from repro_torch.data.synthetic import synth_digits

    h, w = cfg.input_hw
    images, labels = synth_digits(B, seed=42)
    spikes = encode_input(torch.from_numpy(images).to(dev), cfg)
    dense = torch.stack([snn_apply_dense(params, spikes[b], cfg)
                         for b in range(B)]).cpu()
    cparams, cspikes = to_cpu(params), spikes.cpu()
    for path in BATCHED_PATHS:
        plan, name = plans[path], f"single, {path}"
        runs = [counted(name, lambda: snn_apply(params, spikes[0], cfg, plan),
                        launches, exact_launches(plan, cfg.t_steps, batch=1,
                                                 emit=False))]
        runs += [snn_apply(params, spikes[b], cfg, plan) for b in range(1, B)]
        logits = torch.stack([r[0] for r in runs]).cpu()
        blogits, bstats = snn_apply_batched(params, spikes, cfg, plan)
        for b, (lg, st) in enumerate(runs):
            lc, sc = snn_apply(cparams, cspikes[b], cfg, plan)
            for i, (a, c, bs) in enumerate(zip(st, sc, bstats)):
                for f in ("in_spike_counts", "out_spike_counts"):
                    if not torch.equal(getattr(a, f).cpu(), getattr(c, f)):
                        fail(f"{name} image {b}: layer {i} {f} differ from "
                             f"the CPU plain path")
                    if not torch.equal(getattr(a, f), getattr(bs, f)[b]):
                        fail(f"{name} image {b}: layer {i} {f} differ from "
                             f"snn_apply_batched on the card")
            if not (torch.allclose(lg.cpu(), lc, **LOGIT_TOL)
                    and lg.argmax().item() == lc.argmax().item()):
                fail(f"{name} image {b}: logits differ from the CPU plain "
                     f"path by {(lg.cpu() - lc).abs().max().item()}")
        if not torch.isfinite(logits).all() or logits.shape != (B, 10):
            fail(f"{name}: logits not finite or misshapen")
        if not torch.allclose(logits, blogits.cpu(), **LOGIT_TOL):
            fail(f"{name}: logits differ from snn_apply_batched by "
                 f"{(logits - blogits.cpu()).abs().max().item()}")
        agree = int((logits.argmax(-1) == dense.argmax(-1)).sum())
        print(f"csnn_paper.FULL {name}: 8 synth_digits images == CPU plain "
              f"path (stats exact) == snn_apply_batched on the card (stats "
              f"exact, logit max diff "
              f"{(logits - blogits.cpu()).abs().max().item():.3g}); argmax "
              f"{logits.argmax(-1).tolist()}, snn_apply_dense's on "
              f"{agree}/{B} ({truncated(runs, plan)} queues truncated)")
    # The dense oracle equals the event path only where every queue holds
    # all its events: at capacity 256 conv1's queues truncate (a 28x28 map
    # of 32 channels fires above 256 cells), and the event path drops what
    # the oracle keeps.  So the oracle is held at a covering capacity.
    for ep in (None, 1):
        plan = plan_network(cfg, capacity=h * w, channel_block=8,
                            event_par=ep)
        runs = [snn_apply(params, spikes[b], cfg, plan) for b in range(B)]
        logits = torch.stack([r[0] for r in runs]).cpu()
        if truncated(runs, plan):
            fail(f"capacity {h * w} truncated a queue")
        if not torch.equal(logits.argmax(-1), dense.argmax(-1)):
            fail(f"covering capacity, event_par={ep}: argmax "
                 f"{logits.argmax(-1).tolist()} differs from "
                 f"snn_apply_dense's {dense.argmax(-1).tolist()}")
        print(f"csnn_paper.FULL single, capacity {h * w} (no queue "
              f"truncated), event_par={ep}: argmax "
              f"{logits.argmax(-1).tolist()} == snn_apply_dense's (logit max "
              f"diff {(logits - dense).abs().max().item():.3g}; labels "
              f"{labels.tolist()}, random weights)")
    return spikes


def truncated(runs, plan) -> int:
    """Queues of these single-sample runs whose demand exceeded their
    layer's capacity."""
    return sum(int((st.in_spike_counts > lp.capacity).sum())
               for _, stats in runs for st, lp in zip(stats, plan.layers))


# ---------------------------------------- phase 4, sharding, int, conversion
def stats_equal(got, want) -> bool:
    """Two runs' LayerStats lists: every field equal."""
    import torch
    return len(got) == len(want) and all(
        all(torch.equal(getattr(a, f), getattr(b, f))
            for f in ("in_spike_counts", "out_spike_counts", "in_sparsity"))
        and (a.event_block, a.event_par) == (b.event_block, b.event_par)
        for a, b in zip(got, want))


def sharded_path(dev, cfg, params, imgs, plans, launches) -> None:
    """``snn_apply_sharded`` on FULL, B=8, under the serve plan and the
    ``"fused-handoff"`` pin: one shard on the card, two shards on two
    streams of the card, and two cards when there are two; each run under
    ``no_sync``, its logits ``torch.equal`` and its stats equal to the
    card's ``snn_apply_batched``, and each shard launching what one
    forward of its slice launches."""
    import torch

    from repro_torch.core.csnn import (encode_input, snn_apply_batched,
                                       snn_apply_sharded)
    spikes = encode_input(imgs.to(dev), cfg)
    layouts = [("1 shard", [dev]), ("2 shards on 2 streams", [dev, dev])]
    if torch.cuda.device_count() > 1:
        layouts.append(("2 devices", [torch.device("cuda", 0),
                                      torch.device("cuda", 1)]))
    for path in ("serve plan (interlaced)", "fused-handoff"):
        plan = plans[path]
        want, wstats = snn_apply_batched(params, spikes, cfg, plan)
        for name, devices in layouts:
            n = len(devices)
            per_shard = exact_launches(plan, cfg.t_steps, batch=B // n)
            t0 = time.perf_counter()
            got, stats = counted(
                f"sharded {path}, {name}",
                lambda d=devices, p=plan: no_sync(lambda: snn_apply_sharded(
                    params, spikes, cfg, p, devices=d, collect_stats=True)),
                launches, {k: n * v for k, v in per_shard.items()})
            wall = time.perf_counter() - t0
            if not (torch.equal(got, want) and stats_equal(stats, wstats)):
                fail(f"sharded {path}, {name}: differs from "
                     f"snn_apply_batched on the card (logit max diff "
                     f"{(got - want).abs().max().item()})")
            print(f"csnn_paper.FULL sharded {path}, {name} (B={B}): logits "
                  f"torch.equal snn_apply_batched, stats equal; "
                  f"{wall * 1e3:.1f} ms wall with the first-run costs")


def int_path(dev, cfg, launches) -> None:
    """FULL at ``sat_bits`` 16 and 8: parameters from ``init_params(seed=0)``
    normalized on 256 ``synth_digits`` images on the CPU, then
    ``quantize_params`` (card == CPU on the same float parameters) and
    ``quantized_threshold``.  B=8 forwards under the serve plan,
    ``event_par=1``, ``"fused-handoff"`` and ``"banked-cuda"``: the first
    two held against the CPU plain path, the other two exactly against
    the serve plan's card run; each launching exactly its path's
    kernels."""
    import dataclasses

    import torch

    from repro_torch.core.conversion import (normalize_params,
                                             quantize_params,
                                             quantized_threshold)
    from repro_torch.core.csnn import ConvSpec, encode_input, init_params
    from repro_torch.core.plan import plan_network
    from repro_torch.data.synthetic import synth_digits

    calib, _ = synth_digits(256, seed=0)
    norm = normalize_params(init_params(cfg, seed=0, device="cpu"),
                            torch.from_numpy(calib), cfg)
    images, _ = synth_digits(B, seed=1)
    spikes = encode_input(torch.from_numpy(images).to(dev), cfg)
    n_conv = sum(isinstance(s, ConvSpec) for s in cfg.layers)
    conv = {k: v for k, v in norm.items() if k.startswith("conv")}
    for bits in (16, 8):
        q_cpu, spec = quantize_params(conv, bits, v_t=cfg.v_t)
        q_card, spec_card = quantize_params(
            {k: {n: t.to(dev) for n, t in p.items()} for k, p in conv.items()},
            bits, v_t=cfg.v_t)
        if spec_card != spec or any(
                not torch.equal(q_card[k][n].cpu(), q_cpu[k][n])
                for k in q_cpu for n in ("w", "b")):
            fail(f"int{bits}: quantize_params on the card differs from the "
                 f"CPU")
        qcfg = dataclasses.replace(cfg, v_t=quantized_threshold(cfg.v_t,
                                                                spec))
        cpu_params = {**norm, **q_cpu}
        card_params = {k: {n: t.to(dev) for n, t in p.items()}
                       for k, p in cpu_params.items()}
        print(f"int{bits}: quantize_params card == CPU (scale "
              f"{spec.scale!r}, integer V_t {qcfg.v_t}, conv weights "
              f"{q_cpu['conv0']['w'].dtype})")
        knobs = dict(capacity=256, channel_block=8, batch_tile=8,
                     sat_bits=bits)
        iplans = dict(zip(BATCHED_PATHS, (
            plan_network(qcfg, event_par=None, **knobs),
            plan_network(qcfg, event_par=1, **knobs),
            plan_network(qcfg, variant=["fused-handoff"] * n_conv, **knobs),
            plan_network(qcfg, variant=["banked-cuda"] * n_conv, **knobs))))
        got = {path: counted(f"int{bits} {path}", lambda p=plan: forward(
            card_params, spikes, qcfg, p), launches,
            exact_launches(plan, cfg.t_steps)) for path, plan in
            iplans.items()}
        serve = got["serve plan (interlaced)"]
        if not serve[2].fc_drive.any():
            fail(f"int{bits}: no spike reached the FC head")
        for path in BATCHED_PATHS[:2]:
            hold(f"csnn_paper.FULL int{bits} {path}", got[path],
                 forward(cpu_params, spikes.cpu(), qcfg, iplans[path]))
        for path in BATCHED_PATHS[2:]:
            hold_same(f"csnn_paper.FULL int{bits} {path} vs serve plan "
                      f"(card)", got[path], serve)


@contextlib.contextmanager
def tf32(on: bool):
    """cuDNN's TF32 switch set to ``on`` inside the block (on is
    PyTorch's default, what a user's process runs ``fit_ann`` under)."""
    import torch
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def step_grads(params, x, y, cfg, *, guarded=True) -> dict:
    """One ``fit_ann`` step's gradients: through ``_loss_and_grads`` (the
    whole step under the float32 guard), or with the backward outside the
    guard, as ``fit_ann`` ran before (a TF32 backward under TF32 on)."""
    import torch

    from repro_torch.core.conversion import _loss, _loss_and_grads
    if guarded:
        return _loss_and_grads(params, x, y, cfg)[1]
    leaves = {k: {n: t.detach().requires_grad_() for n, t in p.items()}
              for k, p in params.items()}
    grads = iter(torch.autograd.grad(
        _loss(leaves, x, y, cfg),
        [t for p in leaves.values() for t in p.values()]))
    return {k: {n: next(grads) for n in p} for k, p in leaves.items()}


def over_tolerance(got, want) -> float:
    """The largest |got - want| over what rtol 1e-5 and atol 1e-5 x the
    tensor's largest |want| allow (tests/test_torch_conversion.py holds
    the CPU's gradients to JAX's so): at most 1 passes."""
    return max(float(((got[k][n].cpu() - w.cpu()).abs()
                      / (1e-5 * (w.abs() + w.abs().max())).cpu().clamp_min(
                          1e-30)).max())
               for k, p in want.items() for n, w in p.items())


def check_gradients(dev, smoke, full, xtr, ytr) -> None:
    """``fit_ann``'s step gradients with cuDNN's TF32 switch on (the
    caller's ``tf32(True)``).  SMOKE, 64 ``synth_digits``: the card
    against the CPU.  FULL, ``fit_ann``'s first batch: the card against
    the card with the switch off, so that only the switch differs (the
    card against the CPU is printed: float32 near a kink of the clamped
    ReLU puts whole terms of the sum on one side there and not the
    other).  Each gated at :func:`over_tolerance` <= 1; the same step
    with a TF32 backward is measured beside each."""
    import numpy as np
    import torch

    from repro_torch.core.csnn import init_params
    from repro_torch.data.synthetic import synth_digits

    images, labels = synth_digits(64, seed=0, hw=smoke.input_hw)
    x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
    params = init_params(smoke, seed=0, device="cpu")
    want = step_grads(params, x, y, smoke)
    card = to_card(params, dev)
    cases = [("SMOKE, card vs CPU", want, card, x.to(dev), y.to(dev),
              smoke)]
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, len(xtr),
                                                             64))
    x = torch.from_numpy(xtr)[idx].to(dev)
    y = torch.from_numpy(ytr).long()[idx].to(dev)
    card = init_params(full, seed=0, device=dev)
    with tf32(False):
        want = step_grads(card, x, y, full)
    cases.append(("FULL, card vs card with the switch off", want, card, x,
                  y, full))
    for name, want, card, x, y, cfg in cases:
        ratio = over_tolerance(step_grads(card, x, y, cfg), want)
        loose = over_tolerance(step_grads(card, x, y, cfg, guarded=False),
                               want)
        print(f"fit_ann step gradients, {name} (TF32 switch on): "
              f"{ratio:.3g} of the tolerance (rtol 1e-5, atol 1e-5 x max); "
              f"with a TF32 backward: {loose:.3g}")
        if ratio > 1.0:
            fail(f"fit_ann's gradients ({name}) differ by {ratio:.3g} x "
                 f"the tolerance")
    cpu = step_grads(to_cpu(card), x.cpu(), y.cpu(), full)
    ratio, loose = (over_tolerance(step_grads(card, x, y, full, guarded=g),
                                   cpu) for g in (True, False))
    print(f"fit_ann step gradients, FULL, card vs CPU in float32 (printed, "
          f"not held): {ratio:.3g} of the tolerance; with a TF32 backward: "
          f"{loose:.3g}")
    full_float64(card, x, y, full, cpu)
    pool_flip_sweep(card, xtr, ytr, full)


def as_float64(p):
    return {k: {n: t.double() for n, t in v.items()} for k, v in p.items()}


def preactivations(params, x, cfg) -> list:
    """``ann_apply``'s conv pre-activations (before the clamped ReLU) and
    each pooled layer's max-pool indices, in the parameters' dtype."""
    import torch

    from repro_torch.core.csnn import ConvSpec, clamped_relu
    from repro_torch.core.event_conv import conv2d_same
    out = []
    with torch.no_grad():
        for idx, spec in enumerate(cfg.layers):
            if not isinstance(spec, ConvSpec):
                continue
            p = params[f"conv{idx}"]
            z = conv2d_same(x, p["w"]) + p["b"]
            x = clamped_relu(z, cfg.relu_clamp)
            pool = None
            if spec.pool:   # csnn._max_pool, with the windows' indices
                w = spec.pool
                xp = torch.nn.functional.pad(
                    x.permute(0, 3, 1, 2), (0, -x.shape[2] % w, 0, -x.shape[1] % w),
                    value=float("-inf"))
                x, pool = torch.nn.functional.max_pool2d(xp, w,
                                                         return_indices=True)
                x = x.permute(0, 2, 3, 1)
            out.append((z, pool, x))
    return out


def kink_census(a, b, ceiling: float) -> list[dict]:
    """Per conv layer, between two forwards: the pre-activations on other
    sides of the clamped ReLU's kinks at 0 and at ``ceiling``, the
    max-pool windows whose chosen input differs while its value is
    strictly between the kinks on both sides (where a gradient flows),
    and the largest pre-activation difference over the largest |z|."""
    out = []
    for (za, pa, xa), (zb, pb, xb) in zip(a, b):
        za, zb = za.cpu().double(), zb.cpu().double()
        row = dict(n=za.numel(), at0=int(((za > 0) != (zb > 0)).sum()),
                   at1=int(((za > ceiling) != (zb > ceiling)).sum()),
                   err=float((za - zb).abs().max() / zb.abs().max()),
                   pool=None)
        if pa is not None:
            xa, xb = xa.cpu().double(), xb.cpu().double()
            live = (xa > 0) & (xa < ceiling) & (xb > 0) & (xb < ceiling)
            moved = (pa.cpu() != pb.cpu()).permute(0, 2, 3, 1) & live
            row.update(pool=int(moved.sum()), windows=pa.numel())
        out.append(row)
    return out


def census_text(rows, ceiling: float) -> str:
    return "; ".join(
        f"conv{i}: {r['at0']} at 0, {r['at1']} at {ceiling:g} of {r['n']} "
        f"(max |dz| {r['err']:.3g} of max |z|)"
        + ("" if r["pool"] is None else
           f", pool argmax {r['pool']} of {r['windows']}")
        for i, r in enumerate(rows))


def full_float64(card, x, y, cfg, cpu) -> None:
    """FULL's card-against-CPU gradient gap, settled: the same step in
    float64 on both sides (held: the gate on FULL), each float32 side
    against the CPU's float64, and the pre-activations that float32 puts
    on other sides of the clamped ReLU's kinks than float64 or the other
    device does."""
    cpu64 = step_grads(as_float64(to_cpu(card)), x.cpu().double(), y.cpu(),
                       cfg)
    r64 = over_tolerance(step_grads(as_float64(card), x.double(), y, cfg),
                         cpu64)
    print(f"fit_ann step gradients, FULL, card vs CPU in float64 (held): "
          f"{r64:.3g} of the tolerance")
    if r64 > 1.0:
        fail(f"fit_ann's FULL gradients in float64 differ between the card "
             f"and the CPU by {r64:.3g} x the tolerance")
    import torch
    card32 = step_grads(card, x, y, cfg)
    with torch.backends.cudnn.flags(enabled=False):
        direct = step_grads(card, x, y, cfg)
    print(f"fit_ann step gradients, FULL, float32 against the CPU's float64: "
          f"card {over_tolerance(card32, cpu64):.3g} (with cuDNN off, "
          f"PyTorch's own convolutions: {over_tolerance(direct, cpu64):.3g}), "
          f"CPU {over_tolerance(cpu, cpu64):.3g} of the tolerance")
    z = {"card float32": preactivations(card, x, cfg),
         "CPU float32": preactivations(to_cpu(card), x.cpu(), cfg),
         "CPU float64": preactivations(as_float64(to_cpu(card)),
                                       x.cpu().double(), cfg)}
    for a, b in (("card float32", "CPU float32"),
                 ("card float32", "CPU float64"),
                 ("CPU float32", "CPU float64")):
        print(f"fit_ann FULL step 1 kinks, {a} vs {b}: "
              f"{census_text(kink_census(z[a], z[b], cfg.relu_clamp), cfg.relu_clamp)}")


def pool_flip_sweep(card, xtr, ytr, cfg, n: int = 8) -> None:
    """``fit_ann``'s first ``n`` FULL batches: per batch, the card's
    float32 step gradients against the CPU's, beside the kink crossings
    and max-pool choices that differ between the two forwards."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    cpu_p = to_cpu(card)
    rows = []
    for _ in range(n):
        idx = torch.from_numpy(rng.integers(0, len(xtr), 64))
        x = torch.from_numpy(xtr)[idx]
        y = torch.from_numpy(ytr).long()[idx]
        ratio = over_tolerance(step_grads(card, x.to(card_device(card)),
                                          y.to(card_device(card)), cfg),
                               step_grads(cpu_p, x, y, cfg))
        c = kink_census(preactivations(card, x.to(card_device(card)), cfg),
                        preactivations(cpu_p, x, cfg), cfg.relu_clamp)
        kinks = sum(r["at0"] + r["at1"] for r in c)
        flips = sum(r["pool"] or 0 for r in c)
        rows.append(f"{ratio:.3g} ({kinks} kinks, {flips} pool)")
    print(f"fit_ann FULL step gradients card vs CPU in float32 over fit_ann's "
          f"first {n} batches, ratio to the tolerance (kink crossings, "
          f"max-pool choices that differ): {'; '.join(rows)}")


def card_device(params):
    return next(iter(params.values()))["w"].device


def conversion_path(dev, cfg) -> None:
    """The paper's Sec. VII workflow on the card, with cuDNN's TF32
    switch left on as in a user's process: one training step's gradients
    against the CPU's (:func:`check_gradients`), ``fit_ann`` on FULL (150
    steps, batch 64, 1000 ``synth_digits`` of seed 0), ``ann_accuracy``,
    ``normalize_params`` (256 training images), then ``snn_predictions``
    at float32, int16 and int8 on 100 images of seed 1 (capacity 400),
    the accuracy taken from them.  Every card prediction equals the
    card's ``snn_apply_batched`` under the serve plan's knobs at the same
    capacity; the first 8 at each dtype equal the CPU plain path's; the
    float32 predictions sharded over two streams equal the unsharded
    ones.  Gates on the gradients, those equalities and on the ANN
    reaching 90 %; the accuracies are printed."""
    import dataclasses

    import torch

    from repro_torch.configs import csnn_paper
    from repro_torch.core.conversion import (ann_accuracy, fit_ann,
                                             normalize_params,
                                             quantize_params,
                                             quantized_threshold,
                                             snn_predictions)
    from repro_torch.core.csnn import (encode_input, init_params,
                                       snn_apply_batched)
    from repro_torch.core.plan import plan_network
    from repro_torch.data.synthetic import synth_digits

    xtr, ytr = synth_digits(1000, seed=0)
    xte, yte = synth_digits(100, seed=1)
    steps = 150
    params = init_params(cfg, seed=0, device=dev)
    with tf32(True):
        check_gradients(dev, csnn_paper.SMOKE, cfg, xtr, ytr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = fit_ann(params, cfg, xtr, ytr, steps=steps, batch=64,
                         log_every=50)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        acc_ann = ann_accuracy(params, cfg, xte, yte)
    print(f"fit_ann: {steps} steps in {train_s:.3f} s "
          f"({1e3 * train_s / steps:.3f} ms/step, the first step's "
          f"compilation included); ANN accuracy {100 * acc_ann:.1f}%")
    if acc_ann < 0.9:
        fail(f"the ANN did not learn: accuracy {acc_ann}")
    params = normalize_params(params, torch.from_numpy(xtr[:256]).to(dev),
                              cfg)
    conv = {k: v for k, v in params.items() if k.startswith("conv")}
    for bits in (None, 16, 8):
        bparams, bcfg, label = params, cfg, "float32"
        if bits:
            q, spec = quantize_params(conv, bits, v_t=cfg.v_t)
            bparams = {**params, **q}
            bcfg = dataclasses.replace(cfg, v_t=quantized_threshold(cfg.v_t,
                                                                    spec))
            label = f"int{bits} (scale {spec.scale:.5g}, V_t {bcfg.v_t})"
        kw = dict(capacity=400, sat_bits=bits)
        t0 = time.perf_counter()
        preds = snn_predictions(bparams, bcfg, xte, **kw)
        eval_s = time.perf_counter() - t0
        acc = float((preds == torch.from_numpy(yte)).float().mean())
        serve = plan_network(bcfg, capacity=400, channel_block=8,
                             event_par=None, sat_bits=bits)
        served = torch.cat([snn_apply_batched(
            bparams, encode_input(torch.from_numpy(xte[i:i + 32]).to(dev),
                                  bcfg), bcfg, serve,
            collect_stats=False).argmax(-1).cpu() for i in range(0, 100, 32)])
        if not torch.equal(served, preds):
            fail(f"conversion {label}: snn_predictions differ from "
                 f"snn_apply_batched under the serve plan on "
                 f"{int((served != preds).sum())} images")
        cpu = snn_predictions(to_cpu(bparams), bcfg, xte[:8],
                              channel_block=8, **kw)
        if not torch.equal(cpu, preds[:8]):
            fail(f"conversion {label}: the first 8 predictions "
                 f"{preds[:8].tolist()} differ from the CPU plain path's "
                 f"{cpu.tolist()}")
        also = ""
        if bits is None:
            sharded = snn_predictions(bparams, bcfg, xte, devices=[dev, dev],
                                      **kw)
            if not torch.equal(sharded, preds):
                fail("conversion float32: sharded predictions differ")
            also = " == sharded over 2 streams (100/100)"
        print(f"conversion {label}: SNN accuracy {100 * acc:.1f}% on 100 "
              f"images (T={cfg.t_steps}, {eval_s:.3f} s); predictions == "
              f"snn_apply_batched under the serve plan (100/100) == the CPU "
              f"plain path (first 8){also}")


# --------------------------------------------------------- phase 4, LM
# Card against the CPU plain path: float32 sums in another order (cuBLAS
# against the CPU's BLAS); atol is of the compared tensor's largest
# magnitude (at least 1), as in tests/torch_lm_ref.py.  The models with
# one or two KV heads have a sharp softmax (their wk/wv fan-in is the
# KV-head axis) and amplify float32 noise through the layers.
LM_F32 = dict(rtol=1e-4, atol=1e-4)
LM_F32_SHARP = dict(rtol=1e-3, atol=1e-4)
LM_BF16 = dict(rtol=2e-2, atol=2e-3)      # JAX's own (tests/test_models_smoke.py)
LM_SHARP = {"granite-34b", "llama4-maverick-400b-a17b", "zamba2-1.2b",
            "phi3-medium-14b", "qwen2-vl-7b"}
# gemma3-1b FULL, 26 layers, card against CPU in float32 (stated before
# the first card run): 10x the SMOKE float32 bounds
LM_FULL_F32 = dict(rtol=1e-3, atol=1e-3)


def lm_ratio(got, want, rtol: float, atol: float) -> float:
    """The largest |got - want| / (rtol |want| + atol x max(1, max|want|)):
    at most 1 passes."""
    g = got.detach().cpu().double()
    w = want.detach().cpu().double()
    scale = max(1.0, float(w.abs().max()))
    return float(((g - w).abs() / (rtol * w.abs() + atol * scale)).max())


def hold_lm(name: str, got, want, tol: dict) -> float:
    """Hold a tensor, or a tree of them (integer leaves equal), to
    ``tol``; returns the worst :func:`lm_ratio`."""
    import torch

    from repro_torch.models.common import tree_leaves
    g = tree_leaves(got, is_leaf=torch.is_tensor)
    w = tree_leaves(want, is_leaf=torch.is_tensor)
    if len(g) != len(w):
        fail(f"{name}: {len(g)} leaves against {len(w)}")
    worst = 0.0
    for a, b in zip(g, w):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{name}: {a.dtype}{tuple(a.shape)} against "
                 f"{b.dtype}{tuple(b.shape)}")
        if not a.is_floating_point():
            if not torch.equal(a.cpu(), b.cpu()):
                fail(f"{name}: integer leaves differ")
            continue
        worst = max(worst, lm_ratio(a, b, **tol))
    if worst > 1.0:
        fail(f"{name}: {worst:.3g} x the tolerance {tol}")
    return worst


def lm_tree_to(tree, dev):
    import torch

    from repro_torch.models.common import tree_map
    return tree_map(lambda t: t.to(dev, copy=True), tree, is_leaf=torch.is_tensor)


def lm_smoke_vs_cpu(dev, arch: str, dtype: str) -> str:
    """One SMOKE architecture, card against the CPU plain path, the same
    parameters (a CPU generator, copied): prefill logits and cache, then 4
    decode steps, each card step from a copy of the CPU's cache of the
    step before (so float32 noise does not compound in the sharp models);
    each step's logits and the cache it writes are held."""
    import torch

    from repro_torch.configs import LM_ARCHS
    from repro_torch.launch.serve import lm_inputs
    from repro_torch.models.registry import build_model
    cfg = LM_ARCHS[arch].SMOKE
    model = build_model(cfg)
    cpu_p = model.init_params(torch.Generator().manual_seed(0), "cpu")
    card_p = lm_tree_to(cpu_p, dev)
    g = torch.Generator().manual_seed(1)
    b, s = 2, 24
    tokens, extra = lm_inputs(cfg, b, s, g)
    off = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    max_seq = s + 4 + off
    cd = getattr(torch, dtype)
    f32 = LM_F32_SHARP if arch in LM_SHARP else LM_F32
    cache_tol = f32 if dtype == "float32" else LM_BF16
    want, cpu_c = model.prefill(cpu_p, {"tokens": tokens, **extra}, max_seq, cd)
    got, card_c = model.prefill(card_p, lm_tree_to({"tokens": tokens, **extra}, dev),
                                max_seq, cd)
    worst = [hold_lm(f"{arch} {dtype} prefill logits", got, want, f32),
             hold_lm(f"{arch} {dtype} prefill cache", card_c, cpu_c, cache_tol)]
    for i in range(4):
        tok = torch.randint(0, cfg.vocab, (b, 1), generator=g, dtype=torch.int32)
        card_c = lm_tree_to(cpu_c, dev)
        want, cpu_c = model.decode(cpu_p, cpu_c, {"tokens": tok, "pos": s + off + i})
        got, card_c = model.decode(card_p, card_c, {"tokens": tok.to(dev),
                                                    "pos": s + off + i})
        step_tol = LM_F32 if dtype == "float32" else LM_BF16
        worst += [hold_lm(f"{arch} {dtype} decode step {i} logits", got, want,
                          step_tol),
                  hold_lm(f"{arch} {dtype} decode step {i} cache", card_c, cpu_c,
                          step_tol)]
    return f"{max(worst):.4g}"


def top2_gap(logits):
    import torch
    top = torch.topk(logits.double(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def lm_full_teacher_forced(dev, model, cpu_p, card_p) -> None:
    """(a) gemma3-1b FULL, B=2, a 64-token prompt and 8 teacher-forced
    decode steps (the same tokens fed to both), card against the CPU plain
    path at float32 and at the default bfloat16 cache: every step's
    logits held, the argmax equal wherever the CPU's top-2 gap exceeds the
    tolerance there."""
    import torch
    g = torch.Generator().manual_seed(1)
    b, s, n = 2, 64, 8
    tokens = torch.randint(0, model.cfg.vocab, (b, s + n), generator=g,
                           dtype=torch.int32)
    for dtype, tol in (("float32", LM_FULL_F32), ("bfloat16", LM_BF16)):
        cd = getattr(torch, dtype)
        want, cpu_c = model.prefill(cpu_p, {"tokens": tokens[:, :s]}, s + n, cd)
        got, card_c = model.prefill(card_p, {"tokens": tokens[:, :s].to(dev)},
                                    s + n, cd)
        ratios, flips = [], 0
        for i in range(n + 1):
            ratios.append(hold_lm(f"gemma3-1b FULL {dtype} step {i}", got, want,
                                  tol))
            scale = max(1.0, float(want.abs().max()))
            # either of the top two may move by the tolerance
            clear = top2_gap(want) > 2 * (tol["rtol"] * want.abs().max(-1).values
                                          + tol["atol"] * scale)
            same = got.argmax(-1).cpu() == want.argmax(-1)
            if not bool(same[clear].all()):
                fail(f"gemma3-1b FULL {dtype} step {i}: argmax differs where "
                     f"the CPU's top-2 gap exceeds the tolerance")
            flips += int((~same).sum())
            if i == n:
                break
            tok = tokens[:, s + i:s + i + 1]
            want, cpu_c = model.decode(cpu_p, cpu_c, {"tokens": tok, "pos": s + i})
            got, card_c = model.decode(card_p, card_c, {"tokens": tok.to(dev),
                                                        "pos": s + i})
        print(f"lm gemma3-1b FULL (a) B=2 prompt 64 + 8 teacher-forced steps, "
              f"{dtype} cache: card vs CPU worst {max(ratios):.3g} of the "
              f"tolerance {tol} (per step {', '.join(f'{r:.3g}' for r in ratios)}); "
              f"argmax equal on {2 * (n + 1) - flips}/{2 * (n + 1)} "
              f"(every differing one inside the tolerance)")


def lm_consistency(model, params, tokens, label: str) -> float:
    """Prefill S tokens against prefill S-1 then one decode step, float32
    caches, JAX's tolerance (its TestDecodeConsistency)."""
    import torch
    s = tokens.shape[1]
    want, _ = model.prefill(params, {"tokens": tokens}, s, torch.float32)
    _, cache = model.prefill(params, {"tokens": tokens[:, :-1]}, s, torch.float32)
    got, _ = model.decode(params, cache, {"tokens": tokens[:, -1:], "pos": s - 1})
    r = hold_lm(f"{label}: prefill {s} vs prefill {s - 1} + decode", got, want,
                LM_BF16)
    print(f"lm {label}: prefill {s} tokens == prefill {s - 1} + one decode step "
          f"within {LM_BF16} (worst {r:.3g} of it)")
    return r


def lm_full_card(dev, model, card_p) -> list[str]:
    """(b) B=4, a 640-token prompt (past the 512-token window: the ring
    wraps), 32 new tokens through ``Engine.generate`` under
    ``set_sync_debug_mode("error")`` (d), held to a manual greedy loop and
    to the prefill-versus-decode consistency; (c) B=1, 2304 tokens (the
    query-blocked path with sliding KV slices), the same consistency.
    Returns the timing lines for phase 7."""
    import torch

    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = model.cfg
    g = torch.Generator().manual_seed(2)
    b, s, n = 4, 640, 32
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=g,
                            dtype=torch.int32).to(dev)
    engine = Engine(model, card_p, s + n, ServeConfig(max_new_tokens=n))
    engine.generate(prompts)                              # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = no_sync(lambda: engine.generate(prompts))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if out.shape != (b, s + n) or not torch.equal(out[:, :s], prompts):
        fail(f"gemma3-1b FULL generate: output {tuple(out.shape)}")
    if not bool(((out >= 0) & (out < cfg.vocab)).all()):
        fail("gemma3-1b FULL generate: a token outside the vocabulary")
    logits, cache = model.prefill(card_p, {"tokens": prompts}, s + n)
    toks = [logits.argmax(-1)]
    for i in range(n - 1):
        logits, cache = model.decode(card_p, cache, {"tokens": toks[-1][:, None].to(
            torch.int32), "pos": s + i})
        toks.append(logits.argmax(-1))
    manual = torch.stack(toks, 1).to(out.dtype)
    if not torch.equal(manual, out[:, s:]):
        fail("gemma3-1b FULL generate differs from a manual greedy loop")
    print(f"lm gemma3-1b FULL (b, d) B=4 prompt 640 (ring of 512 wrapped) + "
          f"32 new tokens: Engine.generate under set_sync_debug_mode('error') "
          f"in {gen_s:.3f} s, == a manual prefill + argmax decode loop "
          f"(128/128 tokens)")
    lm_consistency(model, card_p, prompts[:, :s], "gemma3-1b FULL (b) B=4")
    lm_consistency(model, card_p, torch.randint(
        0, cfg.vocab, (1, 2304), generator=g, dtype=torch.int32).to(dev),
        "gemma3-1b FULL (c) B=1, blocked path")
    return lm_timing(dev, model, card_p, prompts, n)


def lm_timing(dev, model, card_p, prompts, n: int) -> list[str]:
    """Prefill tokens/s (median of 3) and decode ms per step (32 steps
    after a prefill, host clock around the loop, synchronized), default
    bfloat16 cache, and the device's busy share over 8 decode steps
    (``torch.profiler``)."""
    import torch
    b, s = prompts.shape
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = model.prefill(card_p, {"tokens": prompts}, s + n + 8)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    pre_s = statistics.median(times)
    tok = prompts[:, -1:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        model.decode(card_p, cache, {"tokens": tok, "pos": s + i})
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n

    def steps8():
        for i in range(8):
            model.decode(card_p, cache, {"tokens": tok, "pos": s + n + i % 8})
    busy_ms = device_profile(steps8, "gemma3-1b FULL, 8 decode steps (B=4)",
                             8 * step_ms / 1e3)
    card = card_line()
    return [f"timing lm gemma3-1b FULL prefill B={b} x {s} tokens: "
            f"{b * s / pre_s:.1f} tokens/s ({pre_s * 1e3:.3f} ms, median of 3) "
            f"[{card}]",
            f"timing lm gemma3-1b FULL decode B={b} at position {s}: "
            f"{step_ms:.3f} ms per step (mean of {n}), device busy "
            f"{busy_ms / 8:.3f} ms per step "
            f"({100 * busy_ms / (8 * step_ms):.1f}% busy) [{card}]"]


def lm_main() -> int:
    """The LM phase, in a process of its own with PyTorch's TF32 switches
    as a process starts (the parent turns them off for its yardsticks)."""
    import torch

    from repro_torch.configs import LM_ARCHS, gemma3_1b
    from repro_torch.models.registry import build_model
    print(f"lm: TF32 switches as the process started: "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    for arch in LM_ARCHS:
        worst = [lm_smoke_vs_cpu(dev, arch, dt) for dt in ("float32", "bfloat16")]
        print(f"lm {arch} SMOKE card vs CPU: prefill logits + cache, 4 decode "
              f"steps; worst ratio to the tolerance float32 {worst[0]}, "
              f"bfloat16 cache {worst[1]}")
    print(f"lm ten SMOKE architectures: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    model = build_model(gemma3_1b.FULL)
    cpu_p = model.init_params(torch.Generator().manual_seed(0), "cpu")
    card_p = lm_tree_to(cpu_p, dev)
    torch.cuda.synchronize()
    print(f"lm gemma3-1b FULL: {model.n_params() / 1e9:.3f} B parameters, "
          f"{26} layers, d_model {model.cfg.d_model}, vocab {model.cfg.vocab}; "
          f"initialized on the CPU and copied in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_full_teacher_forced(dev, model, cpu_p, card_p)
    print(f"lm gemma3-1b FULL (a): {time.perf_counter() - t0:.1f} s")
    del cpu_p
    t0 = time.perf_counter()
    for line in lm_full_card(dev, model, card_p):
        print(line)
    print(f"lm gemma3-1b FULL (b-d) and timing: {time.perf_counter() - t0:.1f} s")
    return 0


def lm_phase() -> list[str]:
    """Run :func:`lm_main` in a child process (``chip_smoke.py --lm``),
    print its lines and return its timing lines for phase 7."""
    child = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--lm"],
                           capture_output=True, text=True, cwd=ROOT, timeout=900)
    timing_lines = []
    for line in child.stdout.splitlines():
        if line.startswith("timing lm"):
            timing_lines.append(line)
        else:
            print(line)
    if child.returncode != 0:
        fail(f"the LM phase exited {child.returncode}:\n{child.stderr[-4000:]}")
    return timing_lines


LM_CLI = (("gemma3-1b", ["--requests", "2", "--prompt-len", "16",
                         "--new-tokens", "8"], 2),
          ("deepseek-v2-236b", ["--smoke"], 4),
          ("whisper-medium", ["--smoke"], 4),
          ("qwen2-vl-7b", ["--smoke"], 4))
# python -m repro_torch.launch.train: (arch, flags, logged steps); the loop
# logs the first step and every 10th
# python -m repro_torch.launch.dryrun --arch gemma3-1b --mesh single: shapes
DRYRUN_SHAPES = ("train_4k", "decode_32k")
TRAIN_CLI = (("gemma3-1b", ["--mesh", "smoke", "--steps", "3", "--batch", "4",
                           "--seq", "1024"], 1),
             ("stablelm-3b", ["--smoke", "--steps", "20"], 3),
             ("deepseek-v2-236b", ["--smoke", "--steps", "20"], 3),
             ("rwkv6-1.6b", ["--smoke", "--steps", "20"], 3))


def lm_cli(env, tmp: Path) -> None:
    """Phase 6, LM: ``python -m repro_torch.launch.serve --arch <lm>`` on
    the card (gemma3-1b FULL; three SMOKE families), ``python -m
    repro_torch.launch.train --arch <lm>`` (gemma3-1b FULL on the smoke
    mesh, 3 steps at B=4 x 1024; 20 SMOKE steps of stablelm-3b,
    deepseek-v2-236b and rwkv6-1.6b), ``--mesh single`` without torchrun
    (must exit non-zero, naming the world it found) and ``python -m
    repro_torch.launch.dryrun --arch gemma3-1b --mesh single`` at
    train_4k and decode_32k (each cell ``ok``), all at once."""
    def start(module, arch, flags):
        return subprocess.Popen(
            [sys.executable, "-m", module, "--arch", arch, *flags],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            cwd=ROOT)

    runs = [("serve", arch, n, start("repro_torch.launch.serve", arch, flags))
            for arch, flags, n in LM_CLI]
    runs += [("train", arch, n, start("repro_torch.launch.train", arch, flags))
             for arch, flags, n in TRAIN_CLI]
    runs.append(("refused", "gemma3-1b", 0, start(
        "repro_torch.launch.train", "gemma3-1b", ["--mesh", "single"])))
    runs += [("dryrun", shape, 0, start(
        "repro_torch.launch.dryrun", "gemma3-1b",
        ["--mesh", "single", "--shape", shape, "--out", str(tmp / "dryrun")]))
        for shape in DRYRUN_SHAPES]
    try:
        for kind, arch, n, proc in runs:
            out, err = proc.communicate(timeout=600)
            print(out, end="")
            if kind == "serve":
                ok = (len([ln for ln in out.splitlines() if ln.startswith("req ")])
                      == n and "device=" in out)
            elif kind == "refused":
                print(f"train --mesh single without torchrun: exit "
                      f"{proc.returncode}: {err.strip()}")
                ok = proc.returncode != 0 and "found a world of 1" in err
            elif kind == "dryrun":
                cell = json.loads((tmp / "dryrun" / f"gemma3-1b__{arch}__single__"
                                   f"baseline.json").read_text())
                ok = proc.returncode == 0 and cell["status"] == "ok"
                if ok:
                    r = cell["roofline"]
                    sites: dict = {}
                    for x in cell["redistributions"]:
                        sites[x["rule"]] = sites.get(x["rule"], 0) + x["count"]
                    print(f"dryrun gemma3-1b x {arch} x single (16x16, fake "
                          f"group, meta; H100 SXM data-sheet peaks): "
                          f"{r['flops_per_device']:.4g} FLOP, "
                          f"{r['bytes_per_device']:.4g} B, "
                          f"{r['wire_bytes_per_device']:.4g} wire B per device; "
                          f"t_compute {r['t_compute'] * 1e3:.2f} ms, t_memory "
                          f"{r['t_memory'] * 1e3:.2f} ms, t_collective "
                          f"{r['t_collective'] * 1e3:.2f} ms, bottleneck "
                          f"{r['bottleneck']}; collectives "
                          f"{r['collectives']['counts']}; explicit "
                          f"redistributions by rule {sites}; built in "
                          f"{cell['seconds_lower']} s, step counted in "
                          f"{cell['seconds_compile']} s")
            else:
                steps = [ln.split() for ln in out.splitlines()
                         if ln.startswith("  step ")]
                ok = (len(steps) == n and "M params" in out.splitlines()[0]
                      and all(math.isfinite(float(t[3])) for t in steps))
            if not ok or (kind != "refused" and proc.returncode != 0):
                fail(f"{kind} --arch {arch} exited {proc.returncode}:\n"
                     f"{err[-4000:]}")
    finally:
        for *_, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


# ------------------------------------------------- phase 4, LM training
# Stated before the first card run of the training phase (PERF.md §6,
# PR 23).  gemma3-1b FULL, one training step at B=2 x 64, card against the
# CPU in float32 with matmul TF32 off: the loss and ce at rtol 1e-5, each
# gradient leaf within 1e-3 of its largest CPU entry (the tests' bound
# against JAX), the global gradient norm at rtol 1e-4; one AdamW update:
# the moments as the gradient (nu, a square, at twice the bound) and each
# parameter's change within 1e-3 of the leaf's largest CPU change wherever
# the CPU gradient lies outside its own tolerance band (inside it the sign
# of the update may flip: counted, not held).  The ten SMOKE models, one
# step: the loss and gradient norm at the LM phase's float32 rtol (1e-4,
# the sharp models 1e-3).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_ATOL = 1e-3
TRAIN_NORM_RTOL = 1e-4
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 5
TRAIN_CKPT_STEP = 3


def leaf_ratio(got, want, atol: float, where=None) -> float:
    """max |got - want| / (atol x max |want|) over ``where`` (all entries
    by default); 0 where both are 0 everywhere.  Computed in float32 on
    ``got``'s device (``want`` is copied there): a 1 B-entry tree is too
    large to widen to float64 on the host in time."""
    import torch
    w = want.to(got.device)
    scale = float(w.abs().max()) if w.numel() else 0.0
    err = (got - w).abs()
    if where is not None:
        err = torch.where(where.to(got.device), err, 0.0)
    err = float(err.max()) if err.numel() else 0.0
    if scale == 0.0:
        return 0.0 if err == 0.0 else float("inf")
    return err / (atol * scale)


def hold_leaves(name: str, got, want, atol: float) -> float:
    """Every leaf of two trees within ``atol`` x its largest ``want`` entry;
    returns the worst :func:`leaf_ratio`."""
    from repro_torch.train.optimizer import tree_leaves
    g, w = tree_leaves(got), tree_leaves(want)
    if len(g) != len(w):
        fail(f"{name}: {len(g)} leaves against {len(w)}")
    worst = 0.0
    for a, b in zip(g, w):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{name}: {a.dtype}{tuple(a.shape)} against "
                 f"{b.dtype}{tuple(b.shape)}")
        worst = max(worst, leaf_ratio(a, b, atol))
    if worst > 1.0:
        fail(f"{name}: {worst:.3g} x the tolerance ({atol} of each leaf's "
             f"largest entry)")
    return worst


def hold_rel(name: str, got, want, rtol: float) -> float:
    r = abs(float(got) - float(want)) / (rtol * abs(float(want)))
    if r > 1.0:
        fail(f"{name}: {float(got)!r} against {float(want)!r}, {r:.3g} x "
             f"rtol {rtol}")
    return r


def train_batch(cfg, b: int, s: int, step: int, dev):
    from repro_torch.data.synthetic import ShardedBatcher, TokenStream
    return ShardedBatcher(TokenStream(cfg.vocab, seed=0), b, s, device=dev)(step)


def train_full_card_vs_cpu(dev, model, cpu_p, card_p) -> None:
    """(a) gemma3-1b FULL, one step at B=2 x 64 (``TokenStream``), card
    against the CPU, float32 with matmul TF32 off: the loss, every
    gradient leaf, the global norm; then one AdamW update."""
    import torch

    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    (cl, cm), cg = value_and_grad(model, cpu_p, train_batch(model.cfg, 2, 64, 0, "cpu"))
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (gl, gm), gg = value_and_grad(model, card_p, train_batch(model.cfg, 2, 64, 0, dev))
    r_loss = max(hold_rel("train gemma3-1b FULL (a) loss", gl, cl, TRAIN_LOSS_RTOL),
                 hold_rel("train gemma3-1b FULL (a) ce", gm["ce"], cm["ce"],
                          TRAIN_LOSS_RTOL))
    r_grad = hold_leaves("train gemma3-1b FULL (a) gradients", gg, cg,
                         TRAIN_GRAD_ATOL)
    cn, gn = opt.global_norm(cg), opt.global_norm(gg)
    r_norm = hold_rel("train gemma3-1b FULL (a) global norm", gn, cn,
                      TRAIN_NORM_RTOL)
    n_leaves = len(opt.tree_leaves(cg))
    check_s = time.perf_counter() - t0
    print(f"train gemma3-1b FULL (a) one step B=2 x 64, card vs CPU (float32, "
          f"matmul TF32 off): loss {float(gl):.6f} vs {float(cl):.6f} "
          f"({r_loss:.3g} of rtol {TRAIN_LOSS_RTOL}); {n_leaves} gradient "
          f"leaves, worst {r_grad:.3g} of {TRAIN_GRAD_ATOL} x the leaf's "
          f"largest entry; global norm {float(gn):.6f} vs {float(cn):.6f} "
          f"({r_norm:.3g} of rtol {TRAIN_NORM_RTOL}); the CPU's step "
          f"{cpu_s:.1f} s, the card's and the checks {check_s:.1f} s")
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    t0 = time.perf_counter()
    c1 = opt.adamw_update(opt.init_state(cpu_p, cfg), cg, cfg)
    cpu_update_s = time.perf_counter() - t0
    g1 = opt.adamw_update(opt.init_state(card_p, cfg), gg, cfg)
    r_mu = hold_leaves("train gemma3-1b FULL (a) AdamW mu", g1.mu, c1.mu,
                       TRAIN_GRAD_ATOL)
    r_nu = hold_leaves("train gemma3-1b FULL (a) AdamW nu", g1.nu, c1.nu,
                       2 * TRAIN_GRAD_ATOL)
    worst, flips, band_n, total = 0.0, 0, 0, 0
    for p0c, p1c, p0g, p1g, g in zip(*(opt.tree_leaves(t) for t in (
            cpu_p, c1.params, card_p, g1.params, cg))):
        dc, dg = (p1c - p0c).to(dev), p1g - p0g
        g = g.to(dev)
        outside = g.abs() > TRAIN_GRAD_ATOL * g.abs().max()
        worst = max(worst, leaf_ratio(dg, dc, TRAIN_GRAD_ATOL, outside))
        flips += int(((dg.sign() != dc.sign()) & ~outside).sum())
        band_n += int((~outside).sum())
        total += dc.numel()
    if worst > 1.0:
        fail(f"train gemma3-1b FULL (a) AdamW parameter change: {worst:.3g} x "
             f"the tolerance")
    print(f"train gemma3-1b FULL (a) one AdamW update (lr 1e-3), card vs CPU: "
          f"mu worst {r_mu:.3g}, nu {r_nu:.3g} of their bounds; parameter "
          f"change worst {worst:.3g} of {TRAIN_GRAD_ATOL} x the leaf's largest "
          f"change outside the gradients' tolerance band; inside it "
          f"({band_n} of {total} entries) {flips} changes of other sign; "
          f"the CPU's update {cpu_update_s:.1f} s")


def states_equal(a, b) -> bool:
    import torch

    from repro_torch.train.optimizer import tree_leaves
    la = tree_leaves([a.params, a.mu, a.nu])
    lb = tree_leaves([b.params, b.mu, b.nu])
    return a.step == b.step and len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def train_full_run(dev, model, tmp: Path) -> list[str]:
    """(b) ``run`` at B=4 x 1024 with a checkpoint after step 3 in a
    temporary directory; ``restore`` against the in-memory state (bit for
    bit); steps 4-5 through ``run`` from the checkpoint against steps 4-5
    from the in-memory state (the uninterrupted chain); the loss of every
    step printed, the last no higher than the first.  (d) ms per step
    (median of the 5, synchronized), tokens/s, the device's busy share
    over one step and the peak memory.  Returns the timing lines."""
    import shutil

    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.models import common
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import LoopConfig, make_train_step, run, value_and_grad
    cfg = model.cfg
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    stamps = []

    def data(step):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return train_batch(cfg, TRAIN_B, TRAIN_S, step, dev)

    ckdir = tmp / "train_ckpt"
    free = shutil.disk_usage(tmp).free
    t0 = time.perf_counter()
    state3, hist = run(model, data, LoopConfig(TRAIN_CKPT_STEP, TRAIN_CKPT_STEP,
                                               str(ckdir), 1), ocfg,
                       torch.Generator().manual_seed(0), device=dev)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    run3_s = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    files = list((ckdir / f"ckpt_{TRAIN_CKPT_STEP:09d}").iterdir())
    ck_bytes = sum(f.stat().st_size for f in files)
    t0 = time.perf_counter()
    restored, at = ckpt.restore(opt.abstract_state(
        model.abstract_params(torch.float32), ocfg), ckdir, device=dev)
    restore_s = time.perf_counter() - t0
    if at != TRAIN_CKPT_STEP or not states_equal(restored, state3):
        fail("train gemma3-1b FULL (b): the restored state differs from the "
             "in-memory state after step 3")
    del restored
    print(f"train gemma3-1b FULL (b) run to step {TRAIN_CKPT_STEP} at B={TRAIN_B} "
          f"x {TRAIN_S} ({run3_s:.1f} s, parameters drawn on the CPU and the "
          f"checkpoint included): checkpoint of {len(files)} files, "
          f"{ck_bytes / 1e9:.2f} GB ({free / 1e9:.0f} GB free before); "
          f"restore onto a meta template in {restore_s:.1f} s == the in-memory "
          f"state bit for bit")
    resumed, rhist = run(model, lambda s: train_batch(cfg, TRAIN_B, TRAIN_S, s, dev),
                         LoopConfig(TRAIN_STEPS, TRAIN_CKPT_STEP, str(ckdir), 1),
                         ocfg, torch.Generator().manual_seed(0), device=dev)
    step_fn = make_train_step(model, ocfg)
    state, rlosses = state3, []
    del state3
    for step in range(TRAIN_CKPT_STEP, TRAIN_STEPS):
        batch = data(step)
        state, m = step_fn(state, batch)
        rlosses.append(m["loss"].item())
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    step_s += [b - a for a, b in zip(stamps[-3:], stamps[-2:])]
    losses += rlosses
    bitwise = states_equal(resumed, state)
    for i, (a, b) in enumerate(zip([h["loss"] for h in rhist], rlosses)):
        hold_rel(f"train gemma3-1b FULL (b) step {TRAIN_CKPT_STEP + i + 1} loss "
                 f"resumed vs uninterrupted", a, b, TRAIN_LOSS_RTOL)
    r_mu = hold_leaves("train (b) mu resumed vs uninterrupted", resumed.mu,
                       state.mu, TRAIN_GRAD_ATOL)
    r_nu = hold_leaves("train (b) nu resumed vs uninterrupted", resumed.nu,
                       state.nu, 2 * TRAIN_GRAD_ATOL)
    r_p = hold_leaves("train (b) parameters resumed vs uninterrupted",
                      resumed.params, state.params, TRAIN_GRAD_ATOL)
    print(f"train gemma3-1b FULL (b) loss per step: "
          f"{', '.join(f'{x:.6f}' for x in losses)}")
    if not losses[-1] <= losses[0]:
        fail(f"train gemma3-1b FULL (b): the loss rose from {losses[0]} to "
             f"{losses[-1]}")
    print(f"train gemma3-1b FULL (b) steps {TRAIN_CKPT_STEP + 1}-{TRAIN_STEPS} "
          f"resumed from the checkpoint vs from the in-memory state: "
          f"{'bit for bit equal' if bitwise else 'not bitwise equal'}; losses "
          f"within rtol {TRAIN_LOSS_RTOL}, mu {r_mu:.3g}, nu {r_nu:.3g}, "
          f"parameters {r_p:.3g} of their bounds")
    del resumed
    ms = statistics.median(step_s) * 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    busy_ms = device_profile(lambda: step_fn(state, data(TRAIN_STEPS)),
                             "gemma3-1b FULL, one training step (B=4 x 1024)",
                             ms / 1e3)
    peak_step = torch.cuda.max_memory_allocated()
    peaks = {}
    params = state.params
    del state
    for label in ("with", "without"):
        saved = common.checkpoint
        if label == "without":
            common.checkpoint = lambda fn, *a, **k: fn(*a)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            value_and_grad(model, params, train_batch(cfg, TRAIN_B, TRAIN_S, 0, dev))
            torch.cuda.synchronize()
            peaks[label] = (torch.cuda.max_memory_allocated() - base) / 1e9
        finally:
            common.checkpoint = saved
    card = card_line()
    return [f"timing lm train gemma3-1b FULL B={TRAIN_B} x {TRAIN_S}: "
            f"{ms:.1f} ms per step (median of {len(step_s)}: "
            f"{', '.join(f'{1e3 * x:.1f}' for x in step_s)}; the first warms "
            f"up, the third writes the checkpoint), "
            f"{TRAIN_B * TRAIN_S / (ms / 1e3):.1f} tokens/s, device busy "
            f"{busy_ms:.1f} ms of one step ({100 * busy_ms / ms:.1f}%) [{card}]",
            f"timing lm train gemma3-1b FULL memory: max_memory_allocated "
            f"{peak_step / 1e9:.2f} GB over one step (state, gradients, "
            f"update); "
            f"loss + gradients alone above the parameters: {peaks['with']:.2f} GB "
            f"with each cross-entropy chunk recomputed, {peaks['without']:.2f} GB "
            f"without [{card}]"]


def train_smoke_vs_cpu(dev, arch: str) -> float:
    """(c) One SMOKE architecture, one training step card against CPU in
    float32 from the same parameters and ``TokenStream`` batch (the
    family's extra inputs from ``lm_inputs``): the loss and the gradient
    norm.  Returns the worst ratio to the bound."""
    import torch

    from repro_torch.configs import LM_ARCHS
    from repro_torch.launch.serve import lm_inputs
    from repro_torch.models.registry import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import value_and_grad
    cfg = LM_ARCHS[arch].SMOKE
    model = build_model(cfg)
    cpu_p = model.init_params(torch.Generator().manual_seed(0), "cpu")
    card_p = lm_tree_to(cpu_p, dev)
    batch = train_batch(cfg, 2, 24, 0, "cpu")
    _, extra = lm_inputs(cfg, 2, 24, torch.Generator().manual_seed(1))
    batch.update(extra)
    rtol = LM_F32_SHARP["rtol"] if arch in LM_SHARP else LM_F32["rtol"]
    (cl, _), cg = value_and_grad(model, cpu_p, batch)
    (gl, _), gg = value_and_grad(model, card_p, lm_tree_to(batch, dev))
    return max(hold_rel(f"train {arch} SMOKE loss", gl, cl, rtol),
               hold_rel(f"train {arch} SMOKE gradient norm", opt.global_norm(gg),
                        opt.global_norm(cg), rtol))


def lm_train_main() -> int:
    """The LM training phase, in a process of its own with PyTorch's TF32
    switches as a process starts."""
    import torch

    from repro_torch.configs import LM_ARCHS, gemma3_1b
    from repro_torch.models.registry import build_model
    print(f"train: TF32 switches as the process started: "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    model = build_model(gemma3_1b.FULL)
    cpu_p = model.init_params(torch.Generator().manual_seed(0), "cpu")
    card_p = lm_tree_to(cpu_p, dev)
    torch.cuda.synchronize()
    print(f"train gemma3-1b FULL: {model.n_params() / 1e9:.4f} B float32 "
          f"parameters from a CPU generator (seed 0), copied in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_full_card_vs_cpu(dev, model, cpu_p, card_p)
    del cpu_p, card_p
    print(f"train gemma3-1b FULL (a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        timing_lines = train_full_run(dev, model, Path(tmp))
    print(f"train gemma3-1b FULL (b, d): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    worst = {arch: train_smoke_vs_cpu(dev, arch) for arch in LM_ARCHS}
    print(f"train (c) ten SMOKE architectures, one step card vs CPU (float32): "
          f"loss and gradient norm, worst ratio to the bound "
          + ", ".join(f"{a} {r:.3g}" for a, r in worst.items())
          + f" ({time.perf_counter() - t0:.1f} s)")
    for line in timing_lines:
        print(line)
    return 0


def lm_train_phase() -> list[str]:
    """Run :func:`lm_train_main` in a child process (``chip_smoke.py
    --lm-train``), print its lines and return its timing lines."""
    child = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--lm-train"], capture_output=True, text=True,
                           cwd=ROOT, timeout=900)
    timing_lines = []
    for line in child.stdout.splitlines():
        if line.startswith("timing lm train"):
            timing_lines.append(line)
        else:
            print(line)
    if child.returncode != 0:
        fail(f"the LM training phase exited {child.returncode}:\n"
             f"{child.stderr[-4000:]}")
    return timing_lines


# --------------------------------------------------------- phase 4, mesh
# Stated before the first card run of the mesh phase (PERF.md §6, PR 24):
# on the (1, 1) mesh every shard is the whole tensor and every collective
# a group of one, so gemma3-1b FULL's two steps at B=2 x 64 equal the two
# steps without a mesh bit for bit, and each collective function equals
# its unsharded product.
MESH_B, MESH_S = 2, 64
MESH_TIME_B, MESH_TIME_S, MESH_TURNS = 4, 1024, 5


def hold_mesh(name: str, got, want, rtol: float = 0.0) -> None:
    """``torch.equal``, or with ``rtol`` within it (atol rtol x max |want|)."""
    import torch
    err = (got - want).abs().max().item()
    ok = (torch.equal(got, want) if not rtol else
          err <= rtol * max(want.abs().max().item(), 1.0))
    if not ok or got.shape != want.shape:
        fail(f"{name}: differs from the unsharded result by {err:.3g}")
    print(f"{name}: {'equal' if not rtol else f'max |diff| {err:.3g}'}")


def mesh_collectives(dev, mesh) -> None:
    """The five collective functions and ``moe_forward_sharded``
    (deepseek-v2 SMOKE's MoE layer) on the (1, 1) card mesh, each against
    the card's unsharded result."""
    import torch

    from repro_torch.configs import deepseek_v2
    from repro_torch.models import ffn
    from repro_torch.models.common import init_tree
    from repro_torch.sharding.compression import (compress_topk, decompress,
                                                  dequantize_grad, quantize_grad,
                                                  quantized_pmean, sparse_psum)
    from repro_torch.sharding.collectives import shard_map
    from repro_torch.sharding.overlap import psum_matmul, ring_weight_gather_matmul
    from repro_torch.sharding.pipeline import pipeline_apply
    from repro_torch.sharding.specs import PartitionSpec as P
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(256, 1152, generator=g, device=dev)
    w = torch.randn(1152, 512, generator=g, device=dev)
    want = x @ w
    hold_mesh("mesh psum_matmul", psum_matmul(x, w, mesh, "model").to_local(), want)
    hold_mesh("mesh ring_weight_gather_matmul",
              ring_weight_gather_matmul(x, w, mesh, "data").to_local(), want)
    ws = torch.randn(1, 512, 512, generator=g, device=dev) * 0.05
    xp = torch.randn(64, 512, generator=g, device=dev)
    got = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), {"w": ws}, xp,
                         mesh=mesh, axis="data", n_microbatches=4).to_local()
    want = torch.cat([torch.tanh(m @ ws[0]) for m in xp.chunk(4)])
    hold_mesh("mesh pipeline_apply (1 stage, 4 microbatches)", got, want)
    gr = torch.randn(1 << 20, generator=g, device=dev)
    c = compress_topk(gr, 1 << 10)
    hold_mesh("mesh sparse_psum", sparse_psum(c, mesh, "data").to_local(),
              decompress(c))

    def qbody(gl):
        return quantized_pmean(gl, torch.Generator(device=dev).manual_seed(3),
                               mesh, "data")
    got = shard_map(qbody, mesh=mesh, in_specs=(P(),), out_specs=P())(gr).to_local()
    want = dequantize_grad(quantize_grad(gr, torch.Generator(device=dev).manual_seed(3)))
    hold_mesh("mesh quantized_pmean", got, want)
    cfg = deepseek_v2.SMOKE
    p = init_tree(ffn.moe_specs(cfg.d_model, cfg.d_ff_expert or cfg.d_ff,
                                cfg.n_experts, cfg.n_shared_experts),
                  torch.Generator().manual_seed(0), dev)
    xm = torch.randn(MESH_B, MESH_S, cfg.d_model, generator=g, device=dev)
    out, aux = ffn.moe_forward_sharded(p, xm, top_k=cfg.top_k,
                                       n_experts=cfg.n_experts, mesh=mesh)
    want, want_aux = ffn.moe_forward(p, xm, top_k=cfg.top_k)
    hold_mesh("mesh moe_forward_sharded (deepseek-v2 SMOKE)", out, want, rtol=1e-5)
    hold_mesh("mesh moe_forward_sharded aux", aux, want_aux, rtol=1e-5)
    print("mesh: psum_matmul, ring_weight_gather_matmul, pipeline_apply, "
          "sparse_psum, quantized_pmean and moe_forward_sharded on the (1, 1) "
          "card mesh equal their unsharded results")


def mesh_two_ranks() -> None:
    """Two NCCL ranks (where the machine has two cards): ``psum_matmul``
    over a 2-rank axis against the unsharded product."""
    import socket

    import torch
    if torch.cuda.device_count() < 2:
        print(f"mesh: 2 NCCL ranks not run ({torch.cuda.device_count()} card)")
        return
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = ("import os, sys, torch; sys.path.insert(0, 'src')\n"
            "from repro_torch.launch.mesh import init_distributed, make_custom_mesh\n"
            "from repro_torch.sharding.overlap import psum_matmul\n"
            "init_distributed('cuda'); mesh = make_custom_mesh((2,), ('model',))\n"
            "g = torch.Generator(device='cuda').manual_seed(0)\n"
            "x = torch.randn(64, 256, generator=g, device='cuda')\n"
            "w = torch.randn(256, 128, generator=g, device='cuda')\n"
            "y = psum_matmul(x, w, mesh, 'model').to_local()\n"
            "assert torch.allclose(y, x @ w, rtol=1e-4, atol=1e-3)\n"
            "torch.distributed.destroy_process_group()\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="localhost", MASTER_PORT=str(port)))
        for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            if p.returncode:
                fail(f"mesh: a 2-rank NCCL psum_matmul exited {p.returncode}:\n"
                     f"{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print("mesh: psum_matmul over 2 NCCL ranks (2 cards) equals x @ w")


def mesh_train(dev, mesh, card: str, tmp: Path) -> None:
    """gemma3-1b FULL on the (1, 1) mesh: two steps at B=2 x 64 with the
    state placed by the rules against the same two steps without a mesh,
    the losses and every state leaf ``torch.equal``, under
    ``set_sync_debug_mode("error")``; ms per step at B=4 x 1024 with and
    without the mesh, in turns, median of 5; the mesh state through a
    checkpoint and ``restore(shardings=)``, bit for bit."""
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import gemma3_1b
    from repro_torch.data.synthetic import ShardedBatcher, TokenStream
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.specs import (default_rules, set_constraint_mesh,
                                            shard_tree)
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import make_train_step, state_shardings
    model = build_model(gemma3_1b.FULL)
    rules = default_rules()
    ocfg = opt.AdamWConfig()
    t0 = time.perf_counter()
    params = lm_tree_to(model.init_params(torch.Generator().manual_seed(0), "cpu"), dev)
    plain = opt.init_state(params, ocfg)
    shardings = state_shardings(model, mesh, rules)
    meshed = shard_tree(plain, shardings)
    print(f"mesh gemma3-1b FULL: state placed on the (1, 1) mesh in "
          f"{time.perf_counter() - t0:.1f} s")
    step_p = make_train_step(model, ocfg)
    sharded = make_train_step(model, ocfg, shardings=shardings)

    def step_m(state, batch):  # the launcher's registration, step by step
        set_constraint_mesh(mesh, rules)
        try:
            return sharded(state, batch)
        finally:
            set_constraint_mesh(None)
    ts = TokenStream(gemma3_1b.FULL.vocab, seed=0)
    feed_p = ShardedBatcher(ts, MESH_B, MESH_S, device=dev)
    feed_m = ShardedBatcher(ts, MESH_B, MESH_S, device=dev, mesh=mesh)
    t0 = time.perf_counter()
    losses = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for s in range(2):
            plain, mp = step_p(plain, feed_p(s))
            meshed, mm = step_m(meshed, feed_m(s))
            losses.append((mp["loss"], mm["loss"]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for s, (lp, lm) in enumerate(losses):
        if not torch.equal(lp, lm):
            fail(f"mesh step {s + 1}: loss {float(lm)!r} against {float(lp)!r} "
                 f"without the mesh")
    local = opt.TrainState(step=meshed.step, **{
        f: opt.tree_map(lambda t: t.to_local(), getattr(meshed, f))
        for f in ("params", "mu", "nu")})
    if not states_equal(local, plain):
        fail("mesh: the state after 2 steps on the (1, 1) mesh differs from "
             "the 2 steps without a mesh")
    print(f"mesh gemma3-1b FULL: 2 steps at B={MESH_B} x {MESH_S} on the (1, 1) "
          f"mesh equal the 2 steps without a mesh bit for bit (losses "
          f"{float(mp['loss']):.6f}; every state leaf), no host sync "
          f"({time.perf_counter() - t0:.1f} s)")
    feed_p = ShardedBatcher(ts, MESH_TIME_B, MESH_TIME_S, device=dev)
    feed_m = ShardedBatcher(ts, MESH_TIME_B, MESH_TIME_S, device=dev, mesh=mesh)
    times = {"mesh": [], "no mesh": []}
    for s in range(MESH_TURNS + 1):  # the first turn warms both up
        for name in ("no mesh", "mesh"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if name == "mesh":
                meshed, _ = step_m(meshed, feed_m(2 + s))
            else:
                plain, _ = step_p(plain, feed_p(2 + s))
            torch.cuda.synchronize()
            if s:
                times[name].append((time.perf_counter() - t) * 1e3)
    for name, ts_ in times.items():
        print(f"timing mesh gemma3-1b FULL train step B={MESH_TIME_B} x "
              f"{MESH_TIME_S} {name}: {statistics.median(ts_):.1f} ms "
              f"(median of {MESH_TURNS}, in turns; "
              + ", ".join(f"{v:.1f}" for v in ts_) + f") on {card}")
    del plain
    torch.cuda.empty_cache()
    wall = statistics.median(times["mesh"])
    busy = device_profile(lambda: step_m(meshed, feed_m(99)),
                          "mesh gemma3-1b FULL train step", wall / 1e3)
    print(f"timing mesh gemma3-1b FULL train step B={MESH_TIME_B} x "
          f"{MESH_TIME_S} mesh: device busy {busy:.1f} ms of the "
          f"{wall:.1f} ms median ({100 * busy / wall:.1f}%) on {card}")
    t0 = time.perf_counter()
    ckpt.save(meshed, tmp / "mesh_ckpt", meshed.step)
    t_save = time.perf_counter() - t0
    template = opt.abstract_state(model.abstract_params(torch.float32), ocfg)
    back, _ = ckpt.restore(template, tmp / "mesh_ckpt", shardings=shardings)
    la = opt.tree_leaves([meshed.params, meshed.mu, meshed.nu])
    lb = opt.tree_leaves([back.params, back.mu, back.nu])
    if back.step != meshed.step or not all(
            a.placements == b.placements and torch.equal(a.to_local(), b.to_local())
            for a, b in zip(la, lb, strict=True)):
        fail("mesh: restore(shardings=) differs from the saved mesh state")
    print(f"mesh gemma3-1b FULL: checkpoint of the mesh state saved in "
          f"{t_save:.1f} s, restored onto the mesh with shardings= bit for bit "
          f"({time.perf_counter() - t0 - t_save:.1f} s)")


def mesh_main() -> int:
    """The mesh phase, in a process of its own: NCCL with a world of one on
    the card."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_smoke_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    t0 = time.perf_counter()
    print(f"mesh: world {init_distributed('cuda')} ({dist.get_backend()}) on {card}")
    try:
        mesh = make_smoke_mesh("cuda")
        mesh_collectives(dev, mesh)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
            mesh_train(dev, mesh, card, Path(tmp))
    finally:
        dist.destroy_process_group()
    mesh_two_ranks()
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    return 0


def mesh_phase() -> list[str]:
    """Run :func:`mesh_main` in a child process (``chip_smoke.py --mesh``),
    print its lines and return its timing lines."""
    child = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--mesh"], capture_output=True, text=True,
                           cwd=ROOT, timeout=600)
    timing_lines = []
    for line in child.stdout.splitlines():
        (timing_lines.append if line.startswith("timing mesh") else print)(line)
    if child.returncode != 0:
        fail(f"the mesh phase exited {child.returncode}:\n{child.stderr[-4000:]}")
    return timing_lines


# ------------------------------------------------------- phase 4, engine
ENGINE_TIMEOUT_S = 300.0


def no_sync(fn):
    """Run ``fn`` with every synchronizing CUDA call made an error
    (``torch.cuda.set_sync_debug_mode``): the engine waits on the device
    only through a ``torch.cuda.Event`` from a worker thread, which the
    mode does not count."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def serve_all(engine, requests, *, stagger=False):
    """Serve ``requests`` through ``engine`` in one context, bounded by
    ``asyncio.wait_for``; with ``stagger`` the others are submitted once
    the first request's first chunk is on its way.  Returns the stacked
    logits (CPU)."""
    import asyncio

    import torch

    async def drive():
        async with engine:
            first = engine.submit_nowait(requests[0])
            while stagger and engine.stats["chunks"] == 0:
                await asyncio.sleep(0)
            rest = [engine.submit_nowait(r) for r in requests[1:]]
            return await asyncio.gather(first, *rest)

    return torch.stack(asyncio.run(asyncio.wait_for(drive(),
                                                    ENGINE_TIMEOUT_S)))


def record_buckets(engine) -> list:
    """The occupancy bucket of every chunk ``engine`` steps from now on
    (a wrapper around its chunk step, for the launch count)."""
    buckets, step = [], engine._step

    def recording(state, act, bucket, *args, **kwargs):
        buckets.append(bucket)
        return step(state, act, bucket, *args, **kwargs)

    engine._step = recording
    return buckets


def stream_case(dev, cfg, n):
    """The 2-polarity variant of ``cfg``, its params (seed 0) and ``n``
    ``dvs_moving_edges`` traces (seed 1) with their banks and binned
    frames on ``dev``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.csnn import init_params
    from repro_torch.data.dvs import (dvs_moving_edges, events_to_banks,
                                      events_to_frames)

    scfg = dataclasses.replace(cfg, input_channels=2)
    traces, _ = dvs_moving_edges(n, scfg.t_steps, scfg.input_hw, seed=1)
    banks = np.stack([events_to_banks(tr, scfg.t_steps, scfg.input_hw)
                      for tr in traces])
    frames = np.stack([events_to_frames(tr, scfg.t_steps, scfg.input_hw)
                       for tr in traces])
    return (scfg, init_params(scfg, seed=0, device=dev), traces,
            torch.from_numpy(banks).to(dev), torch.from_numpy(frames).to(dev))


def engine_path(dev, cfg, params, plan, launches):
    """Phases 4-5, the serving engine on ``cfg`` under the serve plan,
    each run with synchronizing CUDA calls made errors and its launches
    counted from 0:

    * micro-batching (max_batch 8): 8 requests (one size flush), then 3
      (a deadline flush padded to the tile of 8);
    * continuous (8 slots, one time step per chunk): 12 requests, the
      first alone and the rest once its first chunk is on its way, so
      later ones join mid-flight (refills) and the lone first steps at
      bucket 1;
    * streaming: 8 ``dvs_moving_edges`` traces (28x28, 2 polarities),
      under the serve plan and under ``"fused-handoff"``.

    Every request's logits must equal the card's ``snn_apply_batched``
    on the same inputs (streams: the binned frames of the same events),
    and each run must launch its path's kernels exactly once per
    (channel block, time step) of each batch or chunk.  The streamed
    forwards are also held against the CPU plain path (stats, state).
    Returns the stream case (config, params, traces, banks, frames) and
    its plans."""
    import dataclasses

    import torch

    from repro_torch.core.aeq import StreamState
    from repro_torch.core.csnn import encode_input, snn_apply_batched
    from repro_torch.core.plan import plan_network
    from repro_torch.serve.csnn_engine import CSNNEngine, CSNNServeConfig

    h, w = cfg.input_hw
    imgs = torch.rand((12, h, w, cfg.input_channels),
                      generator=torch.Generator().manual_seed(2))
    want = snn_apply_batched(params, encode_input(imgs.to(dev), cfg), cfg,
                             plan, collect_stats=False).cpu()

    def check(name, got, ref, engine):
        if got.shape != ref.shape or not torch.isfinite(got).all():
            fail(f"{name}: logits not finite or misshapen")
        if not torch.equal(got, ref):
            fail(f"{name}: logits differ from snn_apply_batched on the "
                 f"card by {(got - ref).abs().max().item()}")
        print(f"{name}: every request == snn_apply_batched on the card "
              f"(torch.equal); classes {got.argmax(-1).tolist()}; stats "
              f"{ {k: v for k, v in engine.stats.items() if v} }")

    # micro-batching
    micro = CSNNEngine(params, cfg, plan, CSNNServeConfig(max_batch=8))
    micro.warmup()

    def two_waves():
        return torch.cat([serve_all(micro, list(imgs[:8])),
                          serve_all(micro, list(imgs[8:11]))])

    name = "engine, micro-batching"  # two B=8 forwards
    got = counted(name, lambda: no_sync(two_waves), launches,
                  {k: 2 * n for k, n in exact_launches(
                      plan, cfg.t_steps).items()})
    st = micro.stats
    if (st["flushes_full"], st["flushes_deadline"], st["padded_slots"],
            st["batches"]) != (1, 1, 5, 2):
        fail(f"{name}: flushes {st} (want one size flush, one deadline "
             f"flush padded by 5)")
    check(f"csnn_paper.FULL {name}", got, want[:11], micro)

    # continuous refill
    cont = CSNNEngine(params, cfg, plan, CSNNServeConfig(
        max_batch=8, continuous=True, slots=8, t_chunk=1))
    cont.warmup()
    buckets = record_buckets(cont)
    name = "engine, continuous"
    got = counted(name, lambda: no_sync(lambda: serve_all(
        cont, list(imgs), stagger=True)), launches,
        lambda: exact_launches(plan, 1, buckets=buckets))
    st = cont.stats
    if not (st["refills"] > 0 and st["admitted"] == st["retired"] == 12):
        fail(f"{name}: stats {st} (want refills and 12 admitted and "
             f"retired)")
    print(f"{name}: buckets per chunk {buckets}")
    check(f"csnn_paper.FULL {name}", got, want, cont)

    # streaming, serve plan and fused-handoff
    scfg, sparams, traces, banks, frames = stream_case(dev, cfg, B)
    knobs = dict(capacity=256, channel_block=8, batch_tile=8, ingest=True)
    n_conv = len(plan.layers)
    splans = {"engine, stream": plan_network(scfg, event_par=None, **knobs),
              "engine, stream fused-handoff": plan_network(
                  scfg, variant=["fused-handoff"] * n_conv, **knobs)}
    for name, splan in splans.items():
        swant = snn_apply_batched(sparams, frames, scfg, splan,
                                  collect_stats=False).cpu()
        eng = CSNNEngine(sparams, scfg, splan, CSNNServeConfig(
            max_batch=8, continuous=True, stream=True, t_chunk=1))
        eng.warmup()
        got = counted(name, lambda e=eng: no_sync(
            lambda: serve_all(e, traces)), launches,
            exact_launches(splan, scfg.t_steps, chunk=1))
        check(f"csnn_paper.FULL 2-polarity {name}", got, swant, eng)
        hold(f"csnn_paper.FULL 2-polarity streamed forward, {name[8:]}",
             forward(sparams, StreamState(banks), scfg, splan),
             forward(to_cpu(sparams), StreamState(banks.cpu()), scfg, splan))
    return (scfg, sparams, traces, banks, frames), splans


# ------------------------------------------------- phase 4, tuned plan
TUNE_KNOBS = dict(capacity=256, channel_block=8, event_par=None, batch_tile=8)


def tune_entry(path) -> dict:
    """The one entry of a plan cache file that one tune wrote."""
    (entry,) = json.loads(Path(path).read_text())["entries"].values()
    return entry


def print_tune(name, entry, seconds, runs) -> None:
    """Every candidate's measured and modelled time, then the winners."""
    print(f"tune {name}: {runs} measurement runs in {seconds:.2f} s wall")
    for key, us in entry["measured_us"].items():
        model = entry["model_us"].get(key)
        print(f"  {key}: measured {us} us"
              + ("" if model is None else f", roofline {model} us"))
    w = entry["winners"]
    print(f"  winners: {[(la['variant'], la['event_par'], la['block_e']) for la in w['layers']]}"
          f", per_layer={w['per_layer']}, t_chunk={w['t_chunk']}")


def winners_key(entry) -> tuple:
    w = entry["winners"]
    return (tuple((la["variant"], la["event_par"], la["block_e"])
                  for la in w["layers"]),
            w["per_layer"], w["t_chunk"])


def tuned_path(dev, cfg, params, imgs, serve_run, launches, tmp):
    """Phase 4, the measured tuner on FULL (B=8): a measured tune of the
    serve knobs (every candidate's time and roofline, the winners, the
    tuning wall time); one forward under the tuned plan, launching
    exactly the kernels its layers' variants name, held against the serve
    plan's card run (spikes, counts, state and FC drive exact; logits
    ``torch.equal``); a ``tune="cached"`` reload that must measure
    nothing and rebuild the same plan; a second fresh measured tune, whose
    winners are compared (printed, not held); then a continuous engine
    pass with ``CSNNEngine(tune="cached")`` over the engine's own plan
    knobs (tuned first into the same cache), under ``no_sync``, whose
    logits must equal ``snn_apply_batched`` of its plan and of the tuned
    plan.  Returns the tuned plan."""
    import torch

    from repro_torch.core.csnn import encode_input, snn_apply_batched
    from repro_torch.core.plan import plan_network
    from repro_torch.serve.csnn_engine import CSNNEngine, CSNNServeConfig
    from repro_torch.tune import TuneConfig, measurement_runs

    config = TuneConfig(device=str(dev))

    def tune(path, mode="measured", **knobs):
        t0, n0 = time.perf_counter(), measurement_runs()
        plan = plan_network(cfg, **knobs, tune=mode, tune_config=config,
                            cache_path=path)
        return plan, time.perf_counter() - t0, measurement_runs() - n0

    first = tmp / "tune_full.json"
    tuned, secs, runs = tune(first, **TUNE_KNOBS)
    entry = tune_entry(first)
    print_tune("csnn_paper.FULL serve knobs, B=8", entry, secs, runs)
    print(f"tuned plan:\n{tuned}")
    spikes = encode_input(imgs.to(dev), cfg)
    name = "tuned plan"
    got = counted(name, lambda: forward(params, spikes, cfg, tuned),
                  launches, exact_launches(tuned, cfg.t_steps))
    hold_same("csnn_paper.FULL tuned plan vs serve plan (card)", got,
              serve_run)
    if not torch.equal(got[0], serve_run[0]):
        fail("tuned plan: logits differ from the serve plan's card run")
    cached, secs, runs = tune(first, "cached", **TUNE_KNOBS)
    if runs or cached != tuned:
        fail(f"tune='cached' made {runs} measurement runs or rebuilt "
             f"another plan")
    print(f"tune cached: 0 measurement runs, the same plan, in {secs:.3f} s")
    second = tmp / "tune_full_again.json"
    _, secs, runs = tune(second, **TUNE_KNOBS)
    again = tune_entry(second)
    print(f"tune again: {runs} measurement runs in {secs:.2f} s; winners "
          f"{'match' if winners_key(again) == winners_key(entry) else 'differ'}"
          f": {winners_key(again)} vs {winners_key(entry)}")
    print_tune("csnn_paper.FULL serve knobs, second run", again, secs, runs)

    # the engine plans with its own knobs (batch_tile = max_batch): warm
    # that key, then the engine's cached tune must measure nothing
    engine_cache = tmp / "tune_engine.json"
    _, secs, runs = tune(engine_cache, batch_tile=B)
    print_tune("csnn_paper.FULL engine knobs (batch_tile 8)",
               tune_entry(engine_cache), secs, runs)
    n0 = measurement_runs()
    engine = CSNNEngine(params, cfg, None, CSNNServeConfig(
        max_batch=B, continuous=True, slots=B, t_chunk=1), tune="cached",
        cache_path=engine_cache)
    if measurement_runs() != n0:
        fail("CSNNEngine(tune='cached') measured on a warm cache")
    engine.warmup()
    buckets = record_buckets(engine)
    name = "engine, continuous, tuned"
    logits = counted(name, lambda: no_sync(lambda: serve_all(
        engine, list(imgs))), launches,
        lambda: exact_launches(engine.plan, 1, buckets=buckets))
    for what, plan in (("its plan", engine.plan), ("the tuned plan", tuned)):
        want = snn_apply_batched(params, spikes, cfg, plan,
                                 collect_stats=False).cpu()
        if not torch.equal(logits, want):
            fail(f"{name}: logits differ from snn_apply_batched of {what}")
    print(f"csnn_paper.FULL {name}: plan {[lp.resolve_variant() for lp in engine.plan.layers]}, "
          f"buckets {buckets}; every request == snn_apply_batched of its "
          f"plan and of the tuned plan (torch.equal)")
    return tuned


def tuned_ingest(dev, tmp) -> None:
    """Phase 4, measured tunes of ``ingest=True`` plans of FULL and SMOKE
    with 2 input channels (784 and 144 cells); each tuned streamed forward
    of ``dvs_moving_edges`` traces held against the CPU plain path."""
    from repro_torch.configs import csnn_paper
    from repro_torch.core.aeq import StreamState
    from repro_torch.core.plan import plan_network
    from repro_torch.tune import TuneConfig, measurement_runs

    knobs = dict(capacity=256, channel_block=8, batch_tile=B,
                 event_par=None, ingest=True)
    for cname, cfg in (("FULL", csnn_paper.FULL),
                       ("SMOKE", csnn_paper.SMOKE)):
        scfg, sparams, _, banks, _ = stream_case(dev, cfg, B)
        path = tmp / f"tune_ingest_{cname}.json"
        t0, n0 = time.perf_counter(), measurement_runs()
        plan = plan_network(scfg, **knobs, tune="measured",
                            tune_config=TuneConfig(device=str(dev)),
                            cache_path=path)
        secs, runs = time.perf_counter() - t0, measurement_runs() - n0
        print_tune(f"csnn_paper.{cname} ingest", tune_entry(path), secs,
                   runs)
        hold(f"csnn_paper.{cname} 2-polarity tuned streamed forward",
             forward(sparams, StreamState(banks), scfg, plan),
             forward(to_cpu(sparams), StreamState(banks.cpu()), scfg, plan))


def conv_bound(vm, slab_list) -> tuple[float, str]:
    """Least ms per launch of queue conv launches on the f32 tile ``vm``
    over ``slab_list`` [(coords, valid, kernel), ...]: each launch's bytes
    and adds (``crosscheck.conv_launch_cost``, the tuner's roofline) over
    the card's peaks, and which of the two bounds it."""
    from repro_torch.tune.crosscheck import conv_launch_cost, roofline_seconds
    nbytes = nops = 0
    for c, v, k in slab_list:
        b, a = conv_launch_cost(
            tile_elems=vm.numel(), vm_bytes=4,
            event_bytes=c.numel() * 4 + v.numel(), kernel_elems=k.numel(),
            kept=int(v.sum()), taps=k.shape[-3:].numel())
        nbytes, nops = nbytes + b, nops + a
    secs, by = roofline_seconds(nbytes, nops)
    return secs * 1e3 / len(slab_list), by


def timing(dev, cfg, params, imgs, plans, card):
    """Phase 7: each kernel at the conv1 shapes of this run's data (CUDA
    events, mean per launch over the launches of channel block 0: one per
    t over all input channels for the queue conv units), its plain version
    on the card, its bound and a library yardstick; then end-to-end
    samples/s.  Returns the kernel records."""
    import torch

    from repro_torch.core.aeq import build_aeq_batched, segment_pad
    from repro_torch.core.csnn import encode_input, snn_apply_batched
    from repro_torch.core.scheduler import (init_conv_carry,
                                            run_conv_layer_batched_chunk)
    from repro_torch.kernels.event_conv.kernel import (
        event_conv_cuda_batched, event_conv_cuda_interlaced_batched)
    from repro_torch.kernels.event_conv.ref import (
        event_conv_ref_batched, event_conv_ref_interlaced_batched)

    serve_plan = plans["serve plan (interlaced)"]
    seq_plan = plans["event_par=1 (sequential)"]
    spikes = encode_input(imgs.to(dev), cfg)
    lp0, lp1, lp1s = serve_plan.layers[0], serve_plan.layers[1], seq_plan.layers[1]
    x1, _, _ = run_conv_layer_batched_chunk(
        spikes, params["conv0"]["w"], params["conv0"]["b"], cfg.v_t, lp0,
        init_conv_carry(lp0, B, device=dev))
    fm = x1.permute(1, 0, 4, 2, 3)                  # (T, B, C_in, H, W)
    q_seq = build_aeq_batched(fm, lp1s.capacity, geometry=lp1s.geometry)
    q_int = segment_pad(build_aeq_batched(fm, lp1.capacity,
                                          geometry=lp1.geometry),
                        lp1.event_par, lp1.geometry)
    t_steps, c_in, h, w = fm.shape[0], fm.shape[2], fm.shape[3], fm.shape[4]
    cb, (hp, wp, _) = lp1.channel_block, lp1.vm_tile
    kern = params["conv1"]["w"][:, :, :, :cb].permute(2, 0, 1, 3).contiguous()
    vm = torch.zeros((B, hp, wp, cb), device=dev)

    def slabs(qs):  # (C_in, B, depth[, 2]) per t; kernel (C_in, kh, kw, cb)
        c = qs.coords.permute(0, 2, 1, 3, 4).contiguous()
        v = qs.valid.permute(0, 2, 1, 3).contiguous()
        return [(c[t], v[t], kern) for t in range(t_steps)]

    def loop(fn, slab_list):
        def run():
            for c, v, k in slab_list:
                fn(c, v, k)
        return run

    seq_slabs, int_slabs = slabs(q_seq), slabs(q_int)
    ep = lp1.event_par

    def seq_k(c, v, k):
        event_conv_cuda_batched(vm, c, v, k, out=vm)

    def int_k(c, v, k):
        event_conv_cuda_interlaced_batched(vm, c, v, k, event_par=ep, out=vm)

    # device time (graph replay) and host-bound time per launch
    t_seq = graph_time_ms(loop(seq_k, seq_slabs)) / len(seq_slabs)
    t_int = graph_time_ms(loop(int_k, int_slabs)) / len(int_slabs)
    h_seq = cuda_time_ms(loop(seq_k, seq_slabs), 3) / len(seq_slabs)
    h_int = cuda_time_ms(loop(int_k, int_slabs), 3) / len(int_slabs)
    p_seq = cuda_time_ms(loop(lambda c, v, k: event_conv_ref_batched(
        vm, c, v, k), seq_slabs), 1) / len(seq_slabs)
    p_int = cuda_time_ms(loop(lambda c, v, k: event_conv_ref_interlaced_batched(
        vm, c, v, k, event_par=ep), int_slabs), 1) / len(int_slabs)
    # yardstick of both: fp32 conv2d (TF32 off) of the dense maps of the
    # kept events of all 32 input channels (the same events in both queues)
    dense = []
    weight = kern.permute(3, 0, 1, 2).contiguous()   # (cb, C_in, kh, kw)
    for c, v, _ in seq_slabs:
        d = torch.zeros((c_in, B, h * w), device=dev)
        flat = (c[..., 0].long() * w + c[..., 1].long()).clamp(min=0)
        d.scatter_add_(2, flat, v.float())
        d = d.view(c_in, B, h, w).transpose(0, 1).contiguous()
        dense.append((d, weight, None))
    t_lib32 = graph_time_ms(loop(lambda d, k, _: torch.nn.functional.conv2d(
        d, k, padding=lp1.geometry.halo), dense)) / len(dense)
    b_seq, by_seq = conv_bound(vm, seq_slabs)
    b_int, by_int = conv_bound(vm, int_slabs)

    def forward_fn(plan):
        def run():
            snn_apply_batched(params, encode_input(imgs.to(dev), cfg), cfg,
                              plan, collect_stats=False)
        return run

    def samples_per_s(names, rounds=3, iters=5):
        """B / the median forward time of each plan, the plans timed in
        turns (``rounds`` x ``iters`` forwards each), so drift between
        them spreads over all."""
        runs = {n: forward_fn(plans[n]) for n in names}
        ts = {n: [] for n in names}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        for _ in range(rounds):
            for n, run in runs.items():
                for _ in range(iters):
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    ts[n].append(time.perf_counter() - t0)
        return [B / statistics.median(ts[n]) for n in names]

    sps_int, sps_seq, sps_fused, sps_banked, sps_tuned = samples_per_s(
        BATCHED_PATHS + ("tuned plan",))
    device_profile(forward_fn(serve_plan), "serve plan forward", B / sps_int)
    device_profile(forward_fn(seq_plan), "event_par=1 forward", B / sps_seq)
    device_profile(forward_fn(plans["fused-handoff"]), "fused-handoff forward",
                   B / sps_fused)
    device_profile(forward_fn(plans["banked-cuda"]), "banked-cuda forward",
                   B / sps_banked)
    device_profile(forward_fn(plans["tuned plan"]), "tuned plan forward",
                   B / sps_tuned)
    fused = timing_fused(dev, cfg, params, spikes, plans["fused-handoff"],
                         card)
    tag = f"[{card}]"
    print(f"timing event_conv_interlaced (conv1, B={B}, depth "
          f"{lp1.queue_depth}, event_par {ep}, {c_in} c_in per (block 0, t) "
          f"launch, f32): device {t_int:.5f} ms/launch, host-bound "
          f"{h_int:.5f}, plain {p_int:.4f}, bound {b_int:.6f} ({by_int}), "
          f"conv2d {c_in} c_in {t_lib32:.5f} {tag}")
    print(f"timing event_conv_seq (conv1, B={B}, capacity {lp1s.capacity}, "
          f"{c_in} c_in per (block 0, t) launch, f32): device {t_seq:.5f} "
          f"ms/launch, host-bound {h_seq:.5f}, plain {p_seq:.4f}, bound "
          f"{b_seq:.6f} ({by_seq}), conv2d {c_in} c_in {t_lib32:.5f} {tag}")
    print(f"timing end-to-end csnn_paper.FULL B={B}: serve plan "
          f"{sps_int:.1f} samples/s, event_par=1 {sps_seq:.1f} samples/s, "
          f"fused-handoff {sps_fused:.1f} samples/s, banked-cuda "
          f"{sps_banked:.1f} samples/s, tuned plan {sps_tuned:.1f} "
          f"samples/s {tag}")
    src = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/"
    return [
        dict(name="event_conv_interlaced", route="cuda",
             source=src + "event_conv.cu",
             replaces=ref + "event_conv/kernel.py:367", ms=t_int,
             plain_ms=p_int, bound_ms=b_int, bound_by=by_int,
             library_ms=t_lib32),
        dict(name="event_conv_seq", route="cuda",
             source=src + "event_conv.cu",
             replaces=ref + "event_conv/kernel.py:241", ms=t_seq,
             plain_ms=p_seq, bound_ms=b_seq, bound_by=by_seq,
             library_ms=t_lib32),
    ] + time_threshold(dev, card) + fused


def timing_engine(dev, cfg, params, plan, stream, splans, card) -> None:
    """Phase 7, the serving engine on the serve plan: samples/s (median of
    5 passes of 8 requests, each pass one ``run_requests``) of the
    micro-batching engine (one size flush), the continuous engine (8
    slots, one time step per chunk: 5 chunks of 8 rows) and the stream
    engine (8 traces, 5 chunks of 8 rows), beside ``snn_apply_batched``
    of the same 8 images and of the binned frames of the same 8 traces;
    then a ``torch.profiler`` breakdown of one continuous pass, per
    chunk."""
    import torch

    from repro_torch.core.csnn import encode_input, snn_apply_batched
    from repro_torch.serve.csnn_engine import CSNNEngine, CSNNServeConfig

    h, w = cfg.input_hw
    imgs = torch.rand((B, h, w, cfg.input_channels),
                      generator=torch.Generator().manual_seed(3))
    reqs = list(imgs)
    scfg, sparams, traces, _, frames = stream
    splan = splans["engine, stream"]
    micro = CSNNEngine(params, cfg, plan, CSNNServeConfig(max_batch=B))
    cont = CSNNEngine(params, cfg, plan, CSNNServeConfig(
        max_batch=B, continuous=True, t_chunk=1))
    strm = CSNNEngine(sparams, scfg, splan, CSNNServeConfig(
        max_batch=B, continuous=True, stream=True, t_chunk=1))
    for engine in (micro, cont, strm):
        engine.warmup()

    def samples_per_s(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return B / statistics.median(ts)

    def serve(engine, requests):
        return lambda: engine.run_requests(requests,
                                           timeout=ENGINE_TIMEOUT_S)

    sps = {
        "snn_apply_batched": samples_per_s(lambda: snn_apply_batched(
            params, encode_input(imgs.to(dev), cfg), cfg, plan,
            collect_stats=False)),
        "micro-batching engine": samples_per_s(serve(micro, reqs)),
        "continuous engine": samples_per_s(serve(cont, reqs)),
        "stream engine": samples_per_s(serve(strm, traces)),
        "snn_apply_batched of the binned traces": samples_per_s(
            lambda: snn_apply_batched(sparams, frames, scfg, splan,
                                      collect_stats=False)),
    }
    tag = f"[{card}]"
    print("timing engine csnn_paper.FULL, serve plan, 8 requests per pass: "
          + ", ".join(f"{k} {v:.1f} samples/s" for k, v in sps.items())
          + f" {tag}")
    before = cont.stats["chunks"]
    wall_s = B / sps["continuous engine"]
    busy_ms = device_profile(serve(cont, reqs),
                             "continuous engine pass (8 requests)", wall_s)
    n = cont.stats["chunks"] - before
    print(f"profile continuous engine chunk (8 slots, one time step): "
          f"device busy {busy_ms / n:.4f} ms, wall {wall_s * 1e3 / n:.4f} "
          f"ms per chunk ({n} chunks per pass; "
          f"{100 * busy_ms / (wall_s * 1e3):.1f}% busy) {tag}")


# The base threshold kernel's launches in a FULL forward: (label, Q, map
# side, channels, pool); tiles with a halo of 1 (3x3 convs).
THRESHOLD_SHAPES = (("conv1, B=8", B, 28, 8, 3), ("conv0, B=8", B, 28, 8, None),
                    ("conv2, B=8", B, 10, 5, None),
                    ("conv1, one sample", 1, 28, 8, 3))


def threshold_launch(dev, q, side, c, pool):
    """One base threshold launch at a FULL shape (f32 tile and bias from
    seed 3, an empty latch, outputs preallocated as the scheduler does);
    returns (launch, plain version, bound ms)."""
    import torch

    from repro_torch.kernels.threshold_pool.kernel import \
        threshold_pool_cuda_batched
    from repro_torch.kernels.threshold_pool.ref import threshold_pool_tile_ref
    from repro_torch.tune.crosscheck import roofline_seconds

    g = torch.Generator().manual_seed(3)
    vm = torch.randn((q, side + 2, side + 2, c), generator=g).to(dev)
    bias = torch.randn((c,), generator=g).to(dev)
    fired = torch.zeros((q, side, side, c), dtype=torch.bool, device=dev)
    oh = -(-side // (pool or 1))
    spikes = torch.empty_like(fired)
    pooled = (None if pool is None else
              torch.empty((q, oh, oh, c), dtype=torch.bool, device=dev))
    args = dict(v_t=0.5, pool=pool, halo=(1, 1))

    def launch():
        threshold_pool_cuda_batched(vm, bias, fired, **args,
                                    fired_out=spikes, pooled_out=pooled)

    def plain():
        threshold_pool_tile_ref(vm, bias, fired, **args)

    # each neuron's vm read and written, its latch read and spike written;
    # the bias and the pooled map; bias add, compare and latch OR each
    cells = q * side * side * c
    nbytes = cells * (2 * 4 + 2) + c * 4 + (0 if pooled is None
                                            else pooled.numel())
    bound = roofline_seconds(nbytes, 3 * cells)[0] * 1e3
    return launch, plain, bound


def launch_floor_ms() -> float:
    """Device ms per launch of a one-element ``add_`` in the same graph
    harness: the floor a small kernel's time is read against."""
    import torch
    x = torch.zeros(1, device="cuda")
    return graph_time_ms(lambda: [x.add_(1) for _ in range(50)]) / 50


def time_threshold(dev, card) -> list:
    """Phase 7, the base threshold kernel at each shape of
    ``THRESHOLD_SHAPES``: device ms per launch (a CUDA graph of 50
    launches), host-bound and plain ms, the bound; and the launch floor.
    Returns one kernel record per shape."""
    tag = f"[{card}]"
    floor = launch_floor_ms()
    print(f"timing launch floor (one-element add_, CUDA graph of 50): "
          f"device {floor:.5f} ms/launch {tag}")
    records = []
    for label, q, side, c, pool in THRESHOLD_SHAPES:
        launch, plain, bound = threshold_launch(dev, q, side, c, pool)
        t = graph_time_ms(lambda: [launch() for _ in range(50)]) / 50
        h_t = cuda_time_ms(launch, 200)
        p_t = cuda_time_ms(plain, 20)
        print(f"timing threshold_pool ({label}, {side}x{side}x{c}, pool "
              f"{pool}, f32): device {t:.5f} ms/launch, host-bound "
              f"{h_t:.5f}, plain {p_t:.4f}, bound {bound:.6f} (bytes), "
              f"floor {floor:.5f} {tag}")
        name = "threshold_pool" + ("" if label == "conv1, B=8"
                                   else f" ({label})")
        records.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/threshold_pool.cu",
            replaces="src/repro/kernels/threshold_pool/kernel.py:68", ms=t,
            plain_ms=p_t, bound_ms=bound, bound_by="bytes", library_ms=None))
    return records


EMIT_CASES = [(k, dtype, q, c, pool, caps)
              for k in (1, 3, 5) for dtype in ("float32", "int16", "int8")
              for q in (B, 1)
              for c, pool, caps in ((8, None, (1, 16, 256, 784)),
                                    (8, 3, (1, 16, 100, 256)),
                                    (5, 3, (1, 100)))]


def stress_emit(seconds: float) -> int:
    """Relaunch the emit kernel at every configuration of phase 3 for about
    ``seconds``: half of them back to back into the same stale buffers,
    half one launch at a time with the card idle in between (as phase 3
    launches it).  Prints launches and differing outputs per case; exits
    1 on any difference."""
    import torch

    from repro_torch.core.geometry import ConvGeometry
    from repro_torch.kernels import runtime
    from repro_torch.kernels.threshold_pool.kernel import \
        threshold_pool_cuda_emit
    from repro_torch.kernels.threshold_pool.ref import threshold_pool_tile_ref

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    runtime.build_all()
    g = torch.Generator().manual_seed(11)
    tally = {}  # case -> [launches, differing launches]

    def burst(case, idle: bool, reps: int) -> None:
        k, dt, q, c, pool, caps = case
        dtype = getattr(torch, dt)
        hh = k // 2
        vm = rand_tile(g, (q, 28 + 2 * hh, 28 + 2 * hh, c), dtype, dev)
        bias = rand_kernel(g, (c,), dtype, dev)
        fired = (torch.rand((q, 28, 28, c), generator=g) < 0.1).to(dev)
        args = dict(v_t=0.5 if dtype == torch.float32 else 20, pool=pool,
                    halo=(hh, hh), emit_geometry=ConvGeometry(k, k))
        for cap in caps:
            want = threshold_pool_tile_ref(vm.clone(), bias, fired, **args,
                                           emit_capacity=cap)
            outs = threshold_pool_cuda_emit(vm.clone(), bias, fired, **args,
                                            emit_capacity=cap)
            bad = torch.zeros((), dtype=torch.int64, device=dev)
            for _ in range(reps):
                for o in outs:
                    if o is not None:
                        o.fill_(1)
                if idle:
                    torch.cuda.synchronize()
                    time.sleep(0.002)
                outs = threshold_pool_cuda_emit(
                    vm.clone(), bias, fired, **args, emit_capacity=cap,
                    fired_out=outs[0], pooled_out=outs[1],
                    masks_out=outs[2], count_out=outs[3],
                    seg_counts_out=outs[4])
                diff = torch.zeros((), dtype=torch.bool, device=dev)
                for a, b in zip(outs, want):
                    if a is not None:
                        diff |= (a != b).any()
                bad += diff
            key = f"k={k} {dt} Q={q} C={c} pool={pool} capacity={cap}"
            t = tally.setdefault(key, [0, 0])
            t[0] += reps
            t[1] += int(bad)

    t0 = time.perf_counter()
    rounds = 0
    while time.perf_counter() - t0 < seconds:
        idle = rounds % 2 == 1
        for case in EMIT_CASES:
            burst(case, idle, 10 if idle else 100)
        rounds += 1
    launches = sum(t[0] for t in tally.values())
    differing = sum(t[1] for t in tally.values())
    for key, (n, bad) in tally.items():
        if bad:
            print(f"stress-emit {key}: {bad} of {n} launches differ")
    print(f"stress-emit: {launches} launches over {len(tally)} cases in "
          f"{rounds} rounds ({time.perf_counter() - t0:.1f} s), {differing} "
          f"differ from the plain version [{card}]")
    return 1 if differing else 0


def compare_threshold(sources: list[str]) -> int:
    """``--compare-threshold A.cu [B.cu ...]``: build each given
    ``threshold_pool.cu`` (another checkout's, or a probe build) beside
    this checkout's, hold each against the plain version as phase 3 does,
    and time them in turns through the same wrapper at every shape of
    ``THRESHOLD_SHAPES``, given sources first and then this checkout's,
    forward and back (A, ..., this, this, ..., A)."""
    import ctypes

    import torch

    from repro_torch.kernels import runtime

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    out = runtime.build_dir() / "compare"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, src in enumerate(sources):
        so = out / f"libthreshold_pool_{i}.so"
        subprocess.run([runtime._nvcc(), *runtime.NVCC_FLAGS, "-o", str(so),
                        src], check=True, capture_output=True, text=True)
        # other builds of the threshold kernel, each timed through the
        # same wrapper as this checkout's
        # analysis: ignore[lint-kernel-launch-outside-kernels]
        libs[src] = ctypes.CDLL(str(so))
    # analysis: ignore[lint-kernel-launch-outside-kernels]
    libs["this checkout"] = runtime.load("threshold_pool")
    for name, lib in libs.items():
        runtime._LIBS["threshold_pool"] = lib

        def same(what, a, b):
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                fail(f"{name}: {what}: kernel != plain version")
        check_threshold(torch.Generator().manual_seed(11), dev, same)
    print("compare: every build equal to the plain version (phase 3's "
          "threshold checks)")
    order = list(libs) + list(libs)[::-1]
    tag = f"[{card}]"
    print(f"timing launch floor (one-element add_, CUDA graph of 50): "
          f"device {launch_floor_ms():.5f} ms/launch {tag}")
    for label, q, side, c, pool in THRESHOLD_SHAPES:
        times = {name: [] for name in libs}
        for name in order:
            runtime._LIBS["threshold_pool"] = libs[name]
            launch, _, bound = threshold_launch(dev, q, side, c, pool)
            times[name].append(graph_time_ms(
                lambda: [launch() for _ in range(50)]) / 50)
        for name, ts in times.items():
            print(f"compare threshold_pool ({label}, {side}x{side}x{c}, pool "
                  f"{pool}, f32) {name}: device {statistics.mean(ts):.5f} "
                  f"ms/launch (runs {', '.join(f'{t:.5f}' for t in ts)}), "
                  f"bound {bound:.6f} {tag}")
    return 0


def timing_fused(dev, cfg, params, spikes, fplan, card) -> list:
    """Phase 7, the fused-handoff kernels: on this run's data (conv0 of the
    fused plan emits the carrier conv1 consumes, conv1 the one conv2
    consumes), the emit kernel at the conv0 -> conv1 and conv1 -> conv2
    handoffs and the banked conv at conv1 (B=8, and sample 0 alone: the
    single-sample pins' Q=1 launch) and at conv2 (C=5).  Returns their
    kernel records."""
    from repro_torch.core.scheduler import (init_conv_carry,
                                            run_conv_layer_batched_chunk)

    lp0, lp1, lp2 = fplan.layers[:3]
    ho1, carry0, _ = run_conv_layer_batched_chunk(
        spikes, params["conv0"]["w"], params["conv0"]["b"], cfg.v_t, lp0,
        init_conv_carry(lp0, B, device=dev),
        emit=(lp1.capacity, lp1.geometry))
    ho2, carry1, _ = run_conv_layer_batched_chunk(
        ho1, params["conv1"]["w"], params["conv1"]["b"], cfg.v_t, lp1,
        init_conv_carry(lp1, B, device=dev),
        emit=(lp2.capacity, lp2.geometry))
    tag = f"[{card}]"
    e1 = time_emit(dev, cfg, params["conv0"]["b"], carry0, lp0, lp1,
                   "conv0 -> conv1", tag)
    e2 = time_emit(dev, cfg, params["conv1"]["b"], carry1, lp1, lp2,
                   "conv1 -> conv2", tag)
    slabs1 = [ho1.masks[t] for t in range(ho1.masks.shape[0])]
    one = [m[:, :1].contiguous() for m in slabs1]
    slabs2 = [ho2.masks[t] for t in range(ho2.masks.shape[0])]
    c1 = time_banked(dev, params["conv1"]["w"], lp1, slabs1, "conv1, B=8",
                     tag)
    c1s = time_banked(dev, params["conv1"]["w"], lp1, one,
                      "conv1, one sample", tag)
    c2 = time_banked(dev, params["conv2"]["w"], lp2, slabs2, "conv2, B=8",
                     tag)
    src = "src/repro_torch/kernels/csrc/"
    conv = dict(name="event_conv_banked", route="cuda",
                source=src + "event_conv_banked.cu",
                replaces="src/repro/core/event_conv.py:393")
    emit = dict(name="threshold_pool_emit", route="cuda",
                source=src + "threshold_pool.cu",
                replaces="src/repro/kernels/threshold_pool/kernel.py:68",
                library_ms=None)
    return [
        dict(conv, **c1),
        dict(emit, **e1),
        dict(conv, **c1s, name="event_conv_banked (conv1, one sample)"),
        dict(conv, **c2, name="event_conv_banked (conv2, C=5)"),
        dict(emit, **e2, name="threshold_pool_emit (conv1 -> conv2)"),
    ]


def time_emit(dev, cfg, bias, carry, lp, nxt, label, tag) -> dict:
    """The emit kernel on channel block 0 of a producer's tile and latch
    after its run, into the consumer's carrier: device, host-bound and
    plain ms per launch and the bound."""
    from repro_torch.kernels.threshold_pool.kernel import \
        threshold_pool_cuda_emit
    from repro_torch.kernels.threshold_pool.ref import threshold_pool_tile_ref
    from repro_torch.tune.crosscheck import roofline_seconds

    cb = lp.channel_block
    vm = carry.vm[..., :cb].contiguous()
    fired = carry.fired[..., :cb].contiguous()
    b = bias[:cb].contiguous()
    args = dict(v_t=cfg.v_t, pool=lp.pool, halo=lp.geometry.halo,
                emit_capacity=nxt.capacity, emit_geometry=nxt.geometry)
    outs = threshold_pool_cuda_emit(vm.clone(), b, fired, **args)
    names = ("fired_out", "pooled_out", "masks_out", "count_out",
             "seg_counts_out")
    bufs = dict(zip(names, outs))

    def emit_k():
        threshold_pool_cuda_emit(vm, b, fired, **args, **bufs)

    t = graph_time_ms(lambda: [emit_k() for _ in range(50)]) / 50
    h_t = cuda_time_ms(emit_k, 200)
    p_t = cuda_time_ms(lambda: threshold_pool_tile_ref(vm, b, fired, **args),
                       20)
    h, w = lp.in_hw
    cells = B * h * w * cb
    out_bytes = sum(o.numel() * o.element_size() for o in outs
                    if o is not None)
    nbytes = cells * (2 * vm.element_size() + 1) + cb * 4 + out_bytes
    # bias add, compare, latch OR per neuron; scan add and rank compare
    # per emitted cell
    nops = 3 * cells + 2 * outs[1 if lp.pool else 0].numel()
    bound, by = roofline_seconds(nbytes, nops)
    bound *= 1e3
    print(f"timing threshold_pool_emit ({label}, B={B}, {h}x{w}x{cb}, pool "
          f"{lp.pool}, capacity {nxt.capacity}, f32): device {t:.5f} "
          f"ms/launch, host-bound {h_t:.5f}, plain {p_t:.4f}, bound "
          f"{bound:.6f} ({by}) {tag}")
    return dict(ms=t, plain_ms=p_t, bound_ms=bound, bound_by=by)


def time_banked(dev, weight, lp, slabs, label, tag) -> dict:
    """The banked conv on channel block 0 of a layer, one launch per t
    over the carrier slabs (C_in, Q, ...) of this run: device, host-bound
    and plain ms per launch, the bound, and ``F.conv2d`` (TF32 off) of the
    dense maps of the same kept events as the library yardstick."""
    import torch

    from repro_torch.core.aeq import deinterlace
    from repro_torch.core.event_conv import tap_matrix
    from repro_torch.kernels.event_conv.kernel import event_conv_cuda_banked
    from repro_torch.kernels.event_conv.ref import event_conv_ref_banked
    from repro_torch.tune.crosscheck import roofline_seconds

    cb, geom = lp.channel_block, lp.geometry
    hp, wp, _ = lp.vm_tile
    hh, hw = geom.halo
    q = slabs[0].shape[1]
    kern = weight[..., :cb]
    taps = tap_matrix(kern).permute(2, 0, 1, 3).contiguous()
    vm = torch.zeros((q, hp, wp, cb), device=dev)

    def conv_k():
        for m in slabs:
            event_conv_cuda_banked(vm, m, taps, geometry=geom, out=vm)

    t = graph_time_ms(conv_k) / len(slabs)
    h_t = cuda_time_ms(conv_k, 5) / len(slabs)
    p_t = cuda_time_ms(lambda: [event_conv_ref_banked(vm, m, taps, geom)
                                for m in slabs], 1) / len(slabs)
    dense = [deinterlace(m[..., 1:-1, 1:-1], (hp, wp), geom)
             [..., hh:hp - hh, hw:wp - hw].permute(1, 0, 2, 3).float()
             .contiguous() for m in slabs]
    wt = kern.permute(3, 2, 0, 1).contiguous()
    lib = graph_time_ms(lambda: [torch.nn.functional.conv2d(
        d, wt, padding=geom.halo) for d in dense]) / len(dense)
    nbytes = (2 * vm.numel() * 4 + taps.numel() * 4
              + sum(m.numel() for m in slabs) / len(slabs))
    nops = (sum(int(m.sum()) for m in slabs) / len(slabs) * geom.n_banks
            * cb)
    bound, by = roofline_seconds(nbytes, nops)
    bound *= 1e3
    print(f"timing event_conv_banked ({label}, tile {hp}x{wp}x{cb}, "
          f"{lp.c_in} c_in per launch, capacity {lp.capacity}, f32): device "
          f"{t:.5f} ms/launch, host-bound {h_t:.5f}, plain {p_t:.4f}, bound "
          f"{bound:.6f} ({by}), conv2d {lp.c_in} c_in {lib:.5f} {tag}")
    return dict(ms=t, plain_ms=p_t, bound_ms=bound, bound_by=by,
                library_ms=lib)


def timing_single(dev, cfg, params, plans, spikes, card) -> list:
    """Phase 7, slice 3: the single-queue conv units at conv1 of one
    sample (image 0 of the single-sample phase; mean per launch over the
    launches of channel block 0: one per t over all input channels),
    against their bound, plain versions and ``F.conv2d`` of the same 32
    input channels' kept events; then single-sample samples/s and a profile
    under the serve plan and event_par=1.  Returns the kernel records."""
    import torch

    from repro_torch.core.aeq import build_aeq_batched, segment_pad
    from repro_torch.core.csnn import snn_apply
    from repro_torch.core.scheduler import run_conv_layer_planned
    from repro_torch.kernels.event_conv.kernel import (
        event_conv_cuda, event_conv_cuda_interlaced)
    from repro_torch.kernels.event_conv.ref import (event_conv_ref,
                                                    event_conv_ref_interlaced)

    serve_plan = plans["serve plan (interlaced)"]
    seq_plan = plans["event_par=1 (sequential)"]
    lp0, lp1, lp1s = serve_plan.layers[0], serve_plan.layers[1], seq_plan.layers[1]
    x1, _ = run_conv_layer_planned(spikes[0], params["conv0"]["w"],
                                   params["conv0"]["b"], cfg.v_t, lp0)
    fm = x1.permute(0, 3, 1, 2)                      # (T, C_in, H, W)
    q_seq = build_aeq_batched(fm, lp1s.capacity, geometry=lp1s.geometry)
    q_int = segment_pad(build_aeq_batched(fm, lp1.capacity,
                                          geometry=lp1.geometry),
                        lp1.event_par, lp1.geometry)
    t_steps, c_in, h, w = fm.shape
    cb, (hp, wp, _) = lp1.channel_block, lp1.vm_tile
    kern = params["conv1"]["w"][:, :, :, :cb].permute(2, 0, 1, 3).contiguous()
    vm = torch.zeros((hp, wp, cb), device=dev)
    ep = lp1.event_par

    def slabs(qs):  # (C_in, depth[, 2]) per t; kernel (C_in, kh, kw, cb)
        return [(qs.coords[t], qs.valid[t], kern) for t in range(t_steps)]

    def loop(fn, slab_list):
        def run():
            for c, v, k in slab_list:
                fn(c, v, k)
        return run

    seq_slabs, int_slabs = slabs(q_seq), slabs(q_int)

    def seq_k(c, v, k):
        event_conv_cuda(vm, c, v, k, out=vm)

    def int_k(c, v, k):
        event_conv_cuda_interlaced(vm, c, v, k, event_par=ep, out=vm)

    t_seq = graph_time_ms(loop(seq_k, seq_slabs)) / len(seq_slabs)
    t_int = graph_time_ms(loop(int_k, int_slabs)) / len(int_slabs)
    h_seq = cuda_time_ms(loop(seq_k, seq_slabs), 3) / len(seq_slabs)
    h_int = cuda_time_ms(loop(int_k, int_slabs), 3) / len(int_slabs)
    p_seq = cuda_time_ms(loop(lambda c, v, k: event_conv_ref(vm, c, v, k),
                              seq_slabs), 1) / len(seq_slabs)
    p_int = cuda_time_ms(loop(lambda c, v, k: event_conv_ref_interlaced(
        vm, c, v, k, event_par=ep), int_slabs), 1) / len(int_slabs)
    # yardstick of both: fp32 conv2d (TF32 off) of the dense maps of the
    # kept events of all 32 input channels (the same events in both queues)
    dense = []
    weight = kern.permute(3, 0, 1, 2).contiguous()   # (cb, C_in, kh, kw)
    for c, v, _ in seq_slabs:
        d = torch.zeros((c_in, h * w), device=dev)
        d.scatter_add_(1, (c[..., 0].long() * w + c[..., 1].long()).clamp(
            min=0), v.float())
        d = d.view(1, c_in, h, w)
        dense.append((d, weight, None))
    t_lib32 = graph_time_ms(loop(lambda d, k, _: torch.nn.functional.conv2d(
        d, k, padding=lp1.geometry.halo), dense)) / len(dense)
    b_seq, by_seq = conv_bound(vm, seq_slabs)
    b_int, by_int = conv_bound(vm, int_slabs)

    def samples_per_s(plan, iters=3):
        def run():
            for b in range(B):
                snn_apply(params, spikes[b], cfg, plan, collect_stats=False)
        run()
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return B / statistics.median(ts)

    sps_int, sps_seq = samples_per_s(serve_plan), samples_per_s(seq_plan)
    device_profile(lambda: snn_apply(params, spikes[0], cfg, serve_plan),
                   "single-sample serve plan forward", 1 / sps_int)
    device_profile(lambda: snn_apply(params, spikes[0], cfg, seq_plan),
                   "single-sample event_par=1 forward", 1 / sps_seq)
    tag = f"[{card}]"
    print(f"timing event_conv_interlaced_single (conv1, one sample, depth "
          f"{lp1.queue_depth}, event_par {ep}, {c_in} c_in per (block 0, t) "
          f"launch, tile {hp}x{wp}x{cb} f32): device {t_int:.5f} ms/launch, "
          f"host-bound {h_int:.5f}, plain {p_int:.4f}, bound {b_int:.6f} "
          f"({by_int}), conv2d {c_in} c_in {t_lib32:.5f} {tag}")
    print(f"timing event_conv_seq_single (conv1, one sample, capacity "
          f"{lp1s.capacity}, {c_in} c_in per (block 0, t) launch, tile "
          f"{hp}x{wp}x{cb} f32): device {t_seq:.5f} ms/launch, host-bound "
          f"{h_seq:.5f}, plain {p_seq:.4f}, bound {b_seq:.6f} ({by_seq}), "
          f"conv2d {c_in} c_in {t_lib32:.5f} {tag}")
    print(f"timing end-to-end csnn_paper.FULL one sample per forward "
          f"(snn_apply over 8 images): serve plan {sps_int:.1f} samples/s, "
          f"event_par=1 {sps_seq:.1f} samples/s {tag}")
    src = "src/repro_torch/kernels/csrc/event_conv.cu"
    ref = "src/repro/kernels/event_conv/kernel.py:"
    return [
        dict(name="event_conv_interlaced_single", route="cuda", source=src,
             replaces=ref + "317", ms=t_int, plain_ms=p_int, bound_ms=b_int,
             bound_by=by_int, library_ms=t_lib32),
        dict(name="event_conv_seq_single", route="cuda", source=src,
             replaces=ref + "186", ms=t_seq, plain_ms=p_seq, bound_ms=b_seq,
             bound_by=by_seq, library_ms=t_lib32),
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    if sys.argv[1:2] == ["--compare-threshold"]:
        return compare_threshold(sys.argv[2:])
    if sys.argv[1:2] == ["--stress-emit"]:
        return stress_emit(float(sys.argv[2]))
    if sys.argv[1:2] == ["--lm"]:
        return lm_main()
    if sys.argv[1:2] == ["--lm-train"]:
        return lm_train_main()
    if sys.argv[1:2] == ["--mesh"]:
        return mesh_main()
    if sys.argv[1:2] == ["--crossover"]:
        return crossover_main()
    if sys.argv[1:2] == ["--vgg"]:
        return vgg_main()
    if sys.argv[1:2] == ["--aeq-build"]:
        return aeq_build_main()
    from repro_torch.configs import csnn_paper, csnn_wide
    from repro_torch.kernels import runtime

    # full-float32 yardsticks (F.conv2d); the port's own FC head sums in
    # float64 and reads neither switch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    card = card_line()                                   # phase 1
    print(card)
    build_s = runtime.build_all()                        # phase 2
    print(f"build: {build_s:.1f} s (nvcc -gencode arch=compute_90a,"
          f"code=sm_90a, {len(runtime.SOURCES)} sources in parallel)")
    for src, log in runtime.BUILD_LOGS.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}")
    max_err = check_kernels(dev)                         # phase 3
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    audit_phase(card)                                    # phase 3b
    print(f"phase 3b done at {time.perf_counter() - t_start:.1f} s")
    launches, params, imgs, plans, serve_run = main_path(  # phases 4-5
        dev, csnn_paper.FULL, csnn_wide.FULL)
    sspikes = single_path(dev, csnn_paper.FULL, params, plans, launches)
    serve_plan = plans["serve plan (interlaced)"]
    stream, splans = engine_path(dev, csnn_paper.FULL, params, serve_plan,
                                 launches)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
        plans["tuned plan"] = tuned_path(dev, csnn_paper.FULL, params, imgs,
                                         serve_run, launches, Path(tmp))
        tuned_ingest(dev, Path(tmp))
        for name, phase in (
                ("sharding", lambda: sharded_path(
                    dev, csnn_paper.FULL, params, imgs, plans, launches)),
                ("int datapaths", lambda: int_path(dev, csnn_paper.FULL,
                                                   launches)),
                ("conversion", lambda: conversion_path(dev,
                                                       csnn_paper.FULL))):
            t0 = time.perf_counter()
            phase()
            print(f"phase 4, {name}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        lm_timing_lines = lm_phase()
        print(f"phase 4, LM: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        lm_timing_lines += lm_train_phase()
        print(f"phase 4, LM training: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        lm_timing_lines += mesh_phase()
        print(f"phase 4, mesh: {time.perf_counter() - t0:.1f} s")
        print(f"phases 4-5 done at {time.perf_counter() - t_start:.1f} s")

        env = dict(os.environ, PYTHONPATH=str(SRC),      # phase 6
                   REPRO_TORCH_PLAN_CACHE=str(Path(tmp) / "serve_cache.json"))
        for flags, line in (([], "mode=batched"), (["--engine"], "engine: "),
                            (["--engine", "--continuous", "--t-chunk", "1"],
                             "engine: chunks="),
                            (["--stream"], "stream: events="),
                            (["--tune", "measured"],
                             "tune: mode=measured plan derived in"),
                            (["--tune", "cached"],
                             "tune: mode=cached plan derived in")):
            serve = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                 "csnn-paper", "--requests", "8", *flags],
                capture_output=True, text=True, env=env, cwd=ROOT,
                timeout=600)
            print(serve.stdout, end="")
            if (serve.returncode != 0 or serve.stdout.count("req ") != 8
                    or line not in serve.stdout):
                fail(f"serve {' '.join(flags)} exited {serve.returncode}:\n"
                     f"{serve.stderr}")
        if len(json.loads((Path(tmp) / "serve_cache.json").read_text())[
                "entries"]) != 1:
            fail("serve --tune measured/cached: want one cache entry")
        lm_cli(env, Path(tmp))
    quick = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.quickstart"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    print(quick.stdout, end="")
    if quick.returncode != 0 or "dense-oracle match: True" not in quick.stdout:
        fail(f"quickstart exited {quick.returncode}:\n{quick.stderr}")
    train = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_csnn", "--steps",
         "150", "--n-train", "1000", "--n-eval", "100"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    print(train.stdout, end="")
    if train.returncode != 0 or "int8 saturating datapath" not in train.stdout:
        fail(f"train_csnn exited {train.returncode}:\n{train.stderr}")

    kernels = timing(dev, csnn_paper.FULL, params, imgs, plans,  # phase 7
                     card)
    kernels += timing_single(dev, csnn_paper.FULL, params, plans, sspikes,
                             card)
    timing_engine(dev, csnn_paper.FULL, params, serve_plan, stream, splans,
                  card)
    gather_crossover(dev, card)
    kernels += aeq_build_timing(dev, card)
    offline_launch_share(dev)
    vgg_phase(dev, card)
    for line in lm_timing_lines:
        print(line)
    for k in kernels:  # a record at another shape counts its kernel's runs
        name = k["name"].split()[0]
        k.update(launches=launches[name], max_abs_err=max_err[name])
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
