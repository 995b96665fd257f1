#!/usr/bin/env python3
"""Read the program's own spans and counters in one traced run of a cell.

    python3 bench/program_spans.py --workload <name> --seed <n> --seconds <s>

runs the cell once as ``bench/run.py --trace 1`` does, with the traced
segment's ``csnn.*`` spans kept beside the trace (``harness.program``) and
the serving engine's host-path counters taken over the window, and prints
the result line, then one JSON line of what the program's spans and
counters read:

- served cells: ``queue_wait_ms.serve`` (mean ms from submit to the launch
  of a request's batch) and ``launch_ms.serve`` (mean host ms of a batch's
  launch), over the window, from ``CSNNEngine.stats``; the device's idle
  ms per traced batch in each stretch of the engine's cycle,
  ``idle_collect_ms.serve``, ``idle_launch_ms.serve`` and
  ``idle_handoff_ms.serve`` (wait plus resolve), with the traced batches
  and idle ms they split;
- continuous engines: ``encode_ms.continuous``, the mean host ms of one
  request's encode, from the traced ``csnn.engine.encode`` spans;
- offline cells: ``conv<i>_device_us`` and ``readout_device_us``, the
  union of device time launched under each layer's span over the samples
  the traced forwards carried;
- every cell: the ten longest idle gaps, labelled by the benchmark span
  or else the engine's stretch open at their start; the mean host ms of
  the traced segment's ``bench.snn_apply_batched`` spans and of its
  ``csnn.engine.launch`` spans (enqueue with the profiler on); and any
  ``csnn.*`` name among the device operations (none is expected).

A program without the spans or counters reads nothing for them.  The
benchmark's own runs do not use this tool.
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
    from harness.program import instrument, readings
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("program_spans: needs a CUDA device", file=sys.stderr)
        return 2
    seen = instrument()
    result, lines, run = run_cell(config.load_cell(args.workload),
                                  args.seed, args.seconds, True,
                                  torch.device("cuda", 0),
                                  time.perf_counter())
    print(json.dumps(result), flush=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "program": readings(run, seen)}), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
