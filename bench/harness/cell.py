"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line."""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from yardstick import compare

from . import config as cfgmod
from .inputs import make_pool
from .record import Setup

#: top-level module names that may not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def read_metric(name: str, run):
    """The value of metric ``name`` from its reader ``metrics/<name>.py``,
    or None where the reader finds nothing to read."""
    return cfgmod.load_module("metrics", name).read(run)


def card_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell: cfgmod.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_setup0: float):
    """Set up, measure, check; returns the result object, the lines of the
    comparison (number beside limit) and the run's record."""
    conf, traffic = cell.config, cell.traffic
    builder = cfgmod.load_path(conf["builder"])
    reference = cfgmod.load_path(conf["reference"])
    loop = cfgmod.load_module("loops", traffic["loop"])
    params = builder.weights(conf, seed, device)
    setup = Setup(device=device, program=builder.build(conf, params, device),
                  net=conf["network"], traffic=traffic,
                  pool=make_pool(traffic["inputs"], conf["network"], seed),
                  seed=seed, seconds=seconds, trace=trace)
    run, run.setup_s = loop.run(setup, t_setup0)
    pool = setup.pool
    del setup
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded in the measured "
                         f"process: {', '.join(found)}")
    peak = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.empty_cache()

    # the reference, after the window, over the whole pool
    ref = reference.check(params, pool, conf, device)
    run.adds = float(sum(ref.adds[rows].sum() for rows in run.window_rows))
    run.traced_least_s = ref.least_time_s(run.traced_rows)
    rows = torch.cat([r for r, _ in run.answers]) if run.answers else \
        torch.zeros(0, dtype=torch.long)
    got = torch.cat([g for _, g in run.answers]) if run.answers else \
        torch.zeros((0, ref.logits.shape[1]))
    nums = compare.numbers(got, ref.logits[rows], run.due)
    correct, checks = compare.judge(nums, conf["limits"])

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": card_name(device), "count": 1,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.due,
              "failed": nums["missing"], "metrics": metrics, "device": dev}
    if trace and run.trace is not None and run.trace.device:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = checks
    lines = [f"generator lateness max {run.lateness_s * 1e3:.3f} ms"
             if run.latencies_s else
             f"forwards in window {len(run.window_rows)}",
             f"card {power_limit()}"]
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    return result, lines, run


def main(argv: list, t_setup0: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cfgmod.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, lines, _ = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), device, t_setup0)
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0
