#!/usr/bin/env python3
"""Readings that set the limits of ``correct``, at a cell's own size.

    python3 bench/control.py --workload <name> --side <side> --seeds 1,2,3 \
        --seconds 3

runs the cell once per seed in one process, with ``--side`` in the
program's place (``harness/controls.py``): ``program`` (the readings of
sound runs), ``bf16`` (the reference in bfloat16: the control), ``int16``
(the program's own int16 datapath), or a fault of the timed path
(``unchanged``, ``half``, ``altered``).  Prints one JSON line per seed
with the numbers compared.  The benchmark's own runs never run this.
"""
import json
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
    from harness.controls import SIDES, patched
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=SIDES, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = config.load_cell(args.workload)
        with patched(args.side, cell.config["network"]):
            result, _, run = run_cell(cell, seed, args.seconds, False, device,
                                      time.perf_counter())
        print(json.dumps({"workload": args.workload, "side": args.side,
                          "seed": seed, "correct": result["correct"],
                          "answers": len(run.answers), "due": run.due,
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
