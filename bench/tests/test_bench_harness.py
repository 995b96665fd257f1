"""The benchmark's harness on the CPU: the metric arithmetic, the seeds,
the result line, the import check, and ``correct`` under the control and
under each fault of the timed path.  The cells run cut to the port's
SMOKE sizes (``cells.tiny``), with the harness's look for a card skipped;
the one test that runs a cell from the command line needs the card."""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cells import tiny
from harness import cell as cellmod
from harness import config
from harness import trace as tracemod
from harness.controls import patched
from harness.inputs import make_pool
from harness.record import Run
from harness.trace import Trace
from yardstick import stats

ROOT = config.ROOT
CPU = torch.device("cpu")


def test_union_idle_share_and_gaps():
    """Busy time is the union of device intervals, not their sum."""
    tr = Trace(device=[("k1", 0.0, 40.0), ("k2", 30.0, 50.0),
                       ("k3", 80.0, 100.0), ("copy", 85.0, 90.0)],
               host=[("bench.wait", 45.0, 85.0)])
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(70e-6)
    run = Run(window_s=1.0, trace=tr)
    assert cellmod.read_metric("idle_share", run) == pytest.approx(30.0)
    assert tr.idle_gaps() == [["bench.wait", pytest.approx(30e-6)]]
    assert tr.device_ops(1) == [["k1", pytest.approx(40e-6)]]
    assert len(tr.device_ops()) == 4
    # none is the port's: every busy instant is glue, overlaps once
    assert cellmod.read_metric("glue_device_share", run) == \
        pytest.approx(100.0)


def test_glue_share_leaves_out_the_ports_kernels():
    tr = Trace(device=[("void (anonymous namespace)::event_conv_gather_kernel"
                        "<float, (Keep)1>(float const*)", 0.0, 60.0),
                       ("void at::native::radixSortKVInPlace<2>", 60.0,
                        80.0),
                       ("Memcpy HtoD (Pinned -> Device)", 80.0, 100.0)])
    run = Run(window_s=1.0, trace=tr)
    assert cellmod.read_metric("glue_device_share", run) == \
        pytest.approx(40.0)


def test_p95_counts_unfinished_requests():
    lat = [0.01] * 94 + [math.inf] * 6
    run = Run(window_s=1.0, latencies_s=lat)
    assert math.isinf(cellmod.read_metric("latency_p95_ms", run))
    run.latencies_s = [0.01] * 95 + [math.inf] * 5
    assert cellmod.read_metric("latency_p95_ms", run) == pytest.approx(10.0)
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_readers_find_nothing_without_their_source():
    run = Run(window_s=1.0)
    for name in ("conv_roofline", "idle_share", "idle_share.serve",
                 "glue_device_share", "enqueue_ms", "batch_fill.serve",
                 "synop_mfu", "samples_per_s", "latency_p95_ms"):
        assert cellmod.read_metric(name, run) is None


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def test_generators_repeat_by_seed_and_only_reorder():
    spec = tiny("paper-offline-b1024")
    net, inputs = spec.config["network"], spec.traffic["inputs"]
    a = make_pool(inputs, net, 11)
    b = make_pool(inputs, net, 11)
    c = make_pool(inputs, net, 12)
    assert a.kind == "images" and a.for_reference[1] == "images"
    a, b, c = a.data, b.data, c.data
    assert torch.equal(a, b) and not torch.equal(a, c)
    key = lambda t: sorted(map(bytes, t.numpy()))  # noqa: E731
    assert key(a) == key(c)  # the same rows in another order
    poisson = config.load_module("arrivals", "poisson")
    spec = {"process": "poisson", "rate_per_s": 500.0}
    due1, rows1 = poisson.draw(spec, 2.0, 64, 11, 2)
    due2, rows2 = poisson.draw(spec, 2.0, 64, 11, 2)
    due3, rows3 = poisson.draw(spec, 2.0, 64, 2**31 + 5, 2)
    assert np.array_equal(due1, due2) and np.array_equal(rows1, rows2)
    assert len(due1) == len(due3) == 1000
    assert due1[0] == 0.0 and due1[-1] < 2.0 and np.all(np.diff(due1) > 0)
    assert not np.array_equal(due1, due3)
    assert sorted(rows1) == sorted(rows3)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("repro_torch.fake", "jax_like", "reprox"):
        monkeypatch.setitem(sys.modules, name, object())
    for name in ("repro", "repro.core", "jaxlib.xla", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    found = cellmod.forbidden_modules()
    for name in ("repro", "repro.core", "jaxlib.xla", "flax"):
        assert name in found
    for name in ("repro_torch.fake", "jax_like", "reprox"):
        assert name not in found


@pytest.mark.parametrize("workload", ["paper-offline-b1024",
                                      "dvs-frames-b1024",
                                      "paper-serve-poisson"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(workload, trace, monkeypatch):
    monkeypatch.setattr(tracemod, "TRACE_S", 0.2)  # the CPU profiles slowly
    monkeypatch.setattr(config.load_module("loops", "engine"), "WARM_S", 0.3)
    cell = tiny(workload)
    # a window of several CPU forwards of ~0.3 s, also on a loaded host
    result, lines, run = cellmod.run_cell(cell, 2**31 + 9, 4.0, trace, CPU,
                                          time.perf_counter())
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(result)
    assert result["correct"] is True and result["failed"] == 0, \
        result["checks"]
    assert result["attempted"] > 0
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(result["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in wanted}
        assert result["metrics"]["setup_s"]["value"] > 0
    assert lines[-2:] == [f"check {k} {c['value']!r} limit {c['limit']!r}"
                          for k, c in result["checks"].items()]
    json.dumps(result)


@pytest.mark.parametrize("workload", ["paper-offline-b1024",
                                      "dvs-frames-b1024",
                                      "paper-serve-poisson"])
@pytest.mark.parametrize("side", ["bf16", "unchanged", "half", "altered"])
def test_control_and_faults_come_out_not_correct(workload, side,
                                                 monkeypatch):
    """The reference in bfloat16 in the program's place, a step that
    returns its state unchanged, half the batch replaced by the mean of
    the rest, one answer altered where it is produced: each reads not
    correct.  (The cells run on one chip: no exchange to leave out.)"""
    monkeypatch.setattr(config.load_module("loops", "engine"), "WARM_S", 0.3)
    cell = tiny(workload)
    with patched(side, cell.config["network"]):
        result, _, _ = cellmod.run_cell(cell, 3, 0.6, False, CPU,
                                        time.perf_counter())
    assert result["correct"] is False
    assert result["checks"]["differ_pct"]["value"] > 0


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "paper-offline-b1024",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_names_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for c in bench["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        for key in ("builder", "reference"):
            assert (config.BENCH_DIR / conf[key]).is_file()
    for w in bench["workloads"]:
        traffic = json.loads((config.BENCH_DIR / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert config.load_module("loops", traffic["loop"]).run
        assert config.load_module("generators",
                                  traffic["inputs"]["generator"]).generate
        if "arrivals" in traffic:
            assert config.load_module("arrivals",
                                      traffic["arrivals"]["process"]).draw
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (config.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.gpu
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "paper-offline-b1024",
         "--seed", "5", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
