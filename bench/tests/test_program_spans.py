"""The program's spans in a trace (``harness.program``) on hand-made
timelines, and the served loop's counters and spans through the tool's
instrumentation on a tiny CPU cell.

A timeline is a list of profiler-like events: host ranges and runtime
calls on the CPU, kernels on the card, a kernel and the call that
launched it sharing a correlation id.  The accepted ``Tracer`` and
``ProgramTracer`` reduce the same timeline, so every metric of the
benchmark reads the same with and without the program's spans.
"""
import time
from types import SimpleNamespace

import pytest
import torch

from cells import tiny
from harness import cell as cellmod
from harness import config, program
from harness import trace as tracemod
from harness.record import Run
from harness.trace import Trace, Tracer

CPU = torch.device("cpu")
GATHER = "void (anonymous namespace)::event_conv_gather_kernel<float>"
SORT = "void at::native::radixSortKVInPlace<2>"


def _ev(name, start, end, cuda=False, corr=0, **args):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type="DeviceType.CUDA" if cuda else "DeviceType.CPU",
        id=corr, kwinputs=args)


def _reduce(tracer_cls, events):
    tracer = tracer_cls.__new__(tracer_cls)
    tracer._prof = SimpleNamespace(stop=lambda: None, events=lambda: events)
    return tracer.stop()


def _offline():
    """Two layers of one forward: conv0 launches a sort (1) and a gather
    (2), conv1 a gather (3); a copy (4) is launched outside both.  The
    benchmark's span and its mirror, the program's spans."""
    bench = [_ev("bench.snn_apply_batched", 0.0, 40.0),
             _ev("bench.snn_apply_batched", 10.0, 150.0, cuda=True)]
    host = [_ev("cudaMemcpyAsync", 1.0, 2.0, corr=4),
            _ev("cudaLaunchKernel", 6.0, 7.0, corr=1),
            _ev("cudaLaunchKernel", 8.0, 9.0, corr=2),
            _ev("cudaLaunchKernel", 22.0, 23.0, corr=3)]
    device = [_ev("Memcpy HtoD", 10.0, 20.0, cuda=True, corr=4),
              _ev(SORT, 20.0, 30.0, cuda=True, corr=1),
              _ev(GATHER, 25.0, 70.0, cuda=True, corr=2),
              _ev(GATHER, 100.0, 150.0, cuda=True, corr=3)]
    spans = [_ev("csnn.conv0", 5.0, 10.0), _ev("csnn.conv1", 21.0, 30.0)]
    return bench + host + device, spans


def test_program_spans_leave_every_metric_as_it_reads():
    base, spans = _offline()
    plain = _reduce(Tracer, base)
    traced = _reduce(program.ProgramTracer, base + spans)
    # a mirror of a csnn.* range, should the profiler leave one
    mirrored = _reduce(program.ProgramTracer, base + spans + [
        _ev("csnn.conv1", 100.0, 150.0, cuda=True)])
    for tr in (traced, mirrored):
        assert tr.device == plain.device and tr.host == plain.host
        assert tr.device_ops() == plain.device_ops()
        assert tr.idle_gaps() == plain.idle_gaps()
        assert not any(n.startswith("csnn.") for n, _ in tr.device_ops())
    for name in ("idle_share", "glue_device_share", "conv_roofline"):
        runs = [Run(window_s=1.0, trace=tr, traced_least_s=20e-6)
                for tr in (plain, traced, mirrored)]
        values = [cellmod.read_metric(name, r) for r in runs]
        assert values[0] is not None and values[1:] == [values[0]] * 2
    assert [n for n, *_ in traced.program] == ["csnn.conv0", "csnn.conv1"]


def test_layer_device_time_is_the_union_launched_in_its_span():
    base, spans = _offline()
    tr = _reduce(program.ProgramTracer, base + spans)
    assert sorted(tr.launched) == [("conv0", 20.0, 30.0),
                                   ("conv0", 25.0, 70.0),
                                   ("conv1", 100.0, 150.0)]
    # the sort and gather overlap: 20..70 counted once; the copy is
    # launched under no layer span
    assert program.layer_device_us(tr) == {"conv0": pytest.approx(50.0),
                                           "conv1": pytest.approx(50.0)}
    run = Run(window_s=1.0, trace=tr, traced_rows=[torch.arange(10)])
    got = program.readings(run, {})
    assert got["conv0_device_us"] == pytest.approx(5.0)
    assert got["conv1_device_us"] == pytest.approx(5.0)
    assert got["traced_samples"] == 10
    assert got["enqueue_ms.traced"] == pytest.approx(0.04)
    assert got["csnn_device_ops"] == []


def _served():
    """Two batches: each launch, a device wait, a resolve, then the
    collection of the next batch; one benchmark tick in the second
    collection.  Device work of batch k runs inside its wait."""
    spans = [_ev("csnn.engine.launch", 0.0, 10.0, seq=0),
             _ev("csnn.engine.resolve", 40.0, 45.0, seq=0),
             _ev("csnn.engine.launch", 60.0, 70.0, seq=1),
             _ev("csnn.engine.resolve", 95.0, 100.0, seq=1)]
    device = [_ev(GATHER, 5.0, 30.0, cuda=True),
              _ev(GATHER, 65.0, 90.0, cuda=True),
              _ev(SORT, 120.0, 130.0, cuda=True)]
    host = [_ev("bench.submit", 102.0, 104.0)]
    return spans + device + host


def test_idle_splits_over_the_engine_cycle_and_sums_to_idle():
    tr = _reduce(program.ProgramTracer, _served())
    assert program.batches(tr) == 2
    assert [k for k, *_ in program.stretches(tr.program, tr.window_us)] == \
        ["launch", "wait", "resolve", "collect", "launch", "wait", "resolve",
         "collect"]
    idle = program.idle_by_stretch(tr)
    # gaps: 30..65 (wait 30-40, resolve 40-45, collect 45-60, launch
    # 60-65) and 90..120 (wait 90-95, resolve 95-100, collect 100-120)
    assert idle == {"collect": pytest.approx(35.0),
                    "launch": pytest.approx(5.0),
                    "wait": pytest.approx(15.0),
                    "resolve": pytest.approx(10.0)}
    assert sum(idle.values()) == pytest.approx(
        (tr.window_s - tr.busy_s) * 1e6)
    got = program.readings(Run(window_s=1.0, trace=tr), {})
    per_batch = [got[f"idle_{k}_ms.serve"]
                 for k in ("collect", "launch", "handoff")]
    assert per_batch == [pytest.approx(0.0175), pytest.approx(0.0025),
                         pytest.approx(0.0125)]
    assert sum(per_batch) * got["traced_batches"] == \
        pytest.approx(got["traced_idle_ms"])
    assert got["launch_ms.traced"] == pytest.approx(0.01)


def test_a_gap_no_benchmark_span_labels_takes_the_engine_stretch():
    tr = _reduce(program.ProgramTracer, _served())
    assert tr.idle_gaps() == [["host: no span", pytest.approx(35e-6)],
                              ["host: no span", pytest.approx(30e-6)]]
    assert program.idle_gaps(tr) == [["csnn.engine.wait",
                                      pytest.approx(35e-6)],
                                     ["csnn.engine.wait",
                                      pytest.approx(30e-6)]]
    # a gap that opens inside a benchmark span keeps that span's label
    events = _served() + [_ev("bench.submit", 89.0, 91.0)]
    tr = _reduce(program.ProgramTracer, events)
    assert ["bench.submit", pytest.approx(30e-6)] in program.idle_gaps(tr)


def test_without_engine_spans_no_gap_takes_an_engine_label():
    """A served timeline from a program with no spans of its own: no
    cycle, so each gap keeps the accepted label and no idle split is
    read."""
    events = [e for e in _served() if not e.name.startswith("csnn.")]
    tr = _reduce(program.ProgramTracer, events)
    assert tr.program == []
    assert program.stretches(tr.program, tr.window_us) == []
    assert sum(program.idle_by_stretch(tr).values()) == 0.0
    assert program.idle_gaps(tr) == tr.idle_gaps() == [
        ["host: no span", pytest.approx(35e-6)],
        ["host: no span", pytest.approx(30e-6)]]
    got = program.readings(Run(window_s=1.0, trace=tr), {})
    assert not any(k.startswith(("idle_", "encode_")) and k != "idle_gaps"
                   for k in got)


def test_encode_reads_the_mean_of_its_spans():
    events = _served() + [_ev("csnn.engine.encode", 46.0, 48.0),
                          _ev("csnn.engine.encode", 50.0, 54.0)]
    tr = _reduce(program.ProgramTracer, events)
    got = program.readings(Run(window_s=1.0, trace=tr), {})
    assert got["encode_ms.continuous"] == pytest.approx(0.003)
    assert "encode_ms.continuous" not in program.readings(
        Run(window_s=1.0, trace=_reduce(program.ProgramTracer, _served())),
        {})


def test_served_counters_and_spans_through_the_harness(monkeypatch):
    """The tool's instrumentation on a tiny served cell on the CPU: the
    engine's counters over the window and its spans in the trace."""
    monkeypatch.setattr(tracemod, "TRACE_S", 1.0)
    loop = config.load_module("loops", "engine")
    monkeypatch.setattr(loop, "WARM_S", 0.3)
    from repro_torch.serve import csnn_engine
    for mod, name in ((loop, "Tracer"), (loop, "settle_gc"),
                      (config.load_module("loops", "offline"), "Tracer"),
                      (csnn_engine, "CSNNEngine")):
        monkeypatch.setattr(mod, name, getattr(mod, name))  # restored after
    seen = program.instrument()
    result, _, run = cellmod.run_cell(tiny("paper-serve-poisson"), 2**31 + 3,
                                      3.0, True, CPU, time.perf_counter())
    assert result["correct"] is True
    got = program.readings(run, seen)
    assert got["window_batches"] > 0
    assert got["queue_wait_ms.serve"] > 0 and got["launch_ms.serve"] > 0
    names = {n for n, *_ in run.trace.program}
    assert {"csnn.engine.launch", "csnn.engine.resolve", "csnn.conv0",
            "csnn.conv1", "csnn.readout"} <= names
    assert isinstance(run.trace, Trace) and run.trace.device == []
