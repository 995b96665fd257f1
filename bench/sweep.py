#!/usr/bin/env python3
"""Find the highest Poisson rate a served cell sustains.

    python3 bench/sweep.py --workload <name> --rates 2000,4000 --seconds 8

runs the cell once per rate in one process (the traffic file's rate
replaced) and prints, per rate, the p50 and p95 latency, the share of the
requests due in the window that finished inside it, and the median
latency of the window's last quarter over its first quarter (above 1,
the queue grows).  Used once, when a served cell is defined; the cell
then offers a fixed rate.
"""
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from harness import env  # noqa: E402

env.setup()


def main() -> int:
    import argparse

    import torch

    from harness import config
    from harness.cell import run_cell
    from yardstick.stats import percentile
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    device = torch.device("cuda", 0)
    for rate in (float(r) for r in args.rates.split(",")):
        cell = config.load_cell(args.workload)
        cell.traffic["arrivals"]["rate_per_s"] = rate
        result, _, run = run_cell(cell, args.seed, args.seconds, False,
                                  device, time.perf_counter())
        lat = run.latencies_s
        q = max(1, len(lat) // 4)
        trend = statistics.median(lat[-q:]) / statistics.median(lat[:q])
        print(json.dumps({
            "rate": rate, "p50_ms": 1e3 * percentile(lat, 50),
            "p95_ms": 1e3 * percentile(lat, 95),
            "done_in_window": run.samples / max(run.due, 1),
            "trend": trend, "lateness_ms": 1e3 * run.lateness_s,
            "batches": run.engine["batches"],
            "correct": result["correct"],
            "checks": {k: c["value"] for k, c in result["checks"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
