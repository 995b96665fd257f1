"""The program's own spans in a traced segment, and what they say.

The port marks its layer boundaries as ``csnn.*`` host ranges
(``repro_torch.runtime.spans``): ``csnn.conv<i>`` and ``csnn.readout``
around each layer of a forward, ``csnn.engine.launch`` and
``csnn.engine.resolve`` around each batch of the serving engine,
``csnn.engine.encode`` around each request's encode in continuous mode.  They
leave no mirror on the card's timeline, so ``trace.Tracer`` keeps none of
them and every metric read from ``Trace`` reads the same with or
without them.  ``ProgramTracer`` keeps them beside the ``Trace``:

- ``Trace.program``: (name, start_us, end_us, args) of every ``csnn.*``
  host range;
- ``Trace.launched``: (layer, start_us, end_us) of every device operation
  launched while a ``csnn.conv<i>`` or ``csnn.readout`` range was open on
  the host (``layer`` its name without the prefix), found through the
  launch's correlation: the operation and the runtime call that launched
  it carry one correlation id, and the call's start lies in the range.

From those, the served cell's idle device time splits over the engine's
cycle, and the offline cells' device time over the conv layers.
"""
from __future__ import annotations

import bisect
import re

from yardstick import stats

from . import config
from .trace import Trace, Tracer, _is_device

PREFIX = "csnn."
LAUNCH, RESOLVE = "csnn.engine.launch", "csnn.engine.resolve"
ENCODE = "csnn.engine.encode"
#: the spans a device operation is attributed to
LAYER = re.compile(r"csnn\.(conv\d+|readout)$")
#: the host runtime calls that put work on the card
RUNTIME = ("cuda", "cu")


def program_spans(events) -> list:
    """(name, start_us, end_us, args) of the ``csnn.*`` host ranges."""
    out = []
    for e in events:
        if e.name.startswith(PREFIX) and not _is_device(e):
            rng = e.time_range
            out.append((e.name, float(rng.start), float(rng.end),
                        dict(getattr(e, "kwinputs", None) or {})))
    return sorted(out, key=lambda s: s[1])


def attribute(device: list, launches: dict, spans: list) -> list:
    """(layer, start_us, end_us) of each device operation whose launch
    (``launches``: correlation id -> host start) lies in a layer span.
    ``device`` holds (correlation id, start_us, end_us)."""
    layers = [(s, e, LAYER.match(n).group(1)) for n, s, e, _ in spans
              if LAYER.match(n)]
    starts = [s for s, _, _ in layers]
    out = []
    for corr, s, e in device:
        at = launches.get(corr)
        if at is None:
            continue
        k = bisect.bisect_right(starts, at) - 1
        if k >= 0 and at <= layers[k][1]:
            out.append((layers[k][2], s, e))
    return out


class ProgramTracer(Tracer):
    """``Tracer`` that also keeps the program's spans and what each device
    operation was launched under; the ``Trace`` it returns is the one
    ``Tracer`` returns, with ``program`` and ``launched`` added, and
    without any device mirror of a ``csnn.*`` range (a user-scope range
    would leave one)."""

    def stop(self) -> Trace:
        trace = super().stop()
        trace.device = [d for d in trace.device
                        if not d[0].startswith(PREFIX)]
        events = self._prof.events()
        trace.program = program_spans(events)
        launches = {e.id: float(e.time_range.start) for e in events
                    if not _is_device(e) and e.name.startswith(RUNTIME)}
        device = [(e.id, float(e.time_range.start), float(e.time_range.end))
                  for e in events if _is_device(e)
                  and not e.name.startswith(("bench.", PREFIX))]
        trace.launched = attribute(device, launches, trace.program)
        return trace


def stretches(program: list, window: tuple) -> list:
    """(stretch, start_us, end_us) of the engine's cycle over ``window``:
    each batch's ``launch`` and ``resolve`` span, ``wait`` between them
    (the device wait), and ``collect`` before each launch and after the
    last resolve (waiting for requests or the deadline).  Without any
    engine span there is no cycle, and no stretch."""
    lo, hi = window
    marks = sorted((s, e, "launch" if n == LAUNCH else "resolve")
                   for n, s, e, _ in program if n in (LAUNCH, RESOLVE))
    if not marks:
        return []
    out, at, prev = [], lo, None
    for s, e, kind in marks:
        if s > at:
            out.append(("wait" if prev == "launch" else "collect", at, s))
        out.append((kind, s, e))
        at, prev = max(at, e), kind
    if hi > at:
        out.append(("wait" if prev == "launch" else "collect", at, hi))
    return out


def idle_by_stretch(trace: Trace) -> dict:
    """Device idle us in each stretch of the engine's cycle, over the
    traced window; the values sum to the traced idle time."""
    cycle = stretches(trace.program, trace.window_us)
    out = {"collect": 0.0, "launch": 0.0, "wait": 0.0, "resolve": 0.0}
    for a, b in stats.gaps([(s, e) for _, s, e in trace.device]):
        for kind, s, e in cycle:
            out[kind] += max(0.0, min(b, e) - max(a, s))
    return out


def batches(trace: Trace) -> int:
    """Engine batches (or chunks) launched in the traced segment."""
    return sum(n == LAUNCH for n, *_ in trace.program)


def layer_device_us(trace: Trace) -> dict:
    """Union of device us attributed to each layer span, by layer."""
    by_layer: dict = {}
    for layer, s, e in trace.launched:
        by_layer.setdefault(layer, []).append((s, e))
    return {k: stats.covered(v) for k, v in sorted(by_layer.items())}


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """``Trace.idle_gaps`` with each gap that no benchmark span labels
    given the stretch of the engine's cycle open at its start."""
    cycle = stretches(trace.program, trace.window_us)
    out = []
    for a, b in stats.gaps([(s, e) for _, s, e in trace.device]):
        open_spans = [(s, n) for n, s, e in trace.host if s <= a < e]
        if open_spans:
            label = max(open_spans)[1]
        else:
            label = next((f"csnn.engine.{k}" for k, s, e in cycle
                          if s <= a < e), "host: no span")
        out.append([label, (b - a) / 1e6])
    return sorted(out, key=lambda kv: -kv[1])[:top]


def instrument() -> dict:
    """Trace with ``ProgramTracer`` in both loops, and keep the serving
    engine with its counters as they stood when the window began (the
    served loop settles the collector right after it reads them)."""
    from repro_torch.serve import csnn_engine
    for name in ("offline", "engine"):
        config.load_module("loops", name).Tracer = ProgramTracer
    seen: dict = {}

    class Engine(csnn_engine.CSNNEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["engine"] = self

    csnn_engine.CSNNEngine = Engine
    loop = config.load_module("loops", "engine")
    settle = loop.settle_gc

    def settle_gc():
        if "engine" in seen:
            seen["before"] = dict(seen["engine"].stats)
        settle()

    loop.settle_gc = settle_gc
    return seen


def _mean_ms(spans: list):
    return 1e-3 * sum(e - s for s, e in spans) / len(spans) if spans \
        else None


def readings(run, seen: dict) -> dict:
    """What the program's spans and counters read in ``run`` (see
    ``bench/program_spans.py``); ``seen`` is what :func:`instrument`
    kept."""
    out: dict = {}
    if "before" in seen:
        a, b = seen["before"], seen["engine"].stats
        delta = {k: b[k] - a[k] for k in b if k in a}
        if delta.get("queue_wait_ms_sum") is not None and delta["requests"]:
            out["queue_wait_ms.serve"] = (delta["queue_wait_ms_sum"]
                                          / delta["requests"])
        if delta.get("launch_ms_sum") is not None and delta["batches"]:
            out["launch_ms.serve"] = (delta["launch_ms_sum"]
                                      / delta["batches"])
        out["window_batches"] = delta["batches"]
    tr = run.trace
    if tr is None or not tr.device:
        return out
    n = batches(tr)
    if n:
        idle = idle_by_stretch(tr)
        out["idle_collect_ms.serve"] = idle["collect"] / 1e3 / n
        out["idle_launch_ms.serve"] = idle["launch"] / 1e3 / n
        out["idle_handoff_ms.serve"] = (idle["wait"] + idle["resolve"]) \
            / 1e3 / n
        out["idle_wait_ms"] = idle["wait"] / 1e3 / n
        out["traced_batches"] = n
        out["traced_idle_ms"] = (tr.window_s - tr.busy_s) * 1e3
        out["launch_ms.traced"] = _mean_ms(
            [(s, e) for name, s, e, _ in tr.program
             if name == LAUNCH])
    samples = sum(len(r) for r in run.traced_rows)
    if samples:
        for layer, us in layer_device_us(tr).items():
            out[f"{layer}_device_us"] = us / samples
        out["traced_samples"] = samples
    encodes = [(s, e) for name, s, e, _ in tr.program if name == ENCODE]
    if encodes:
        out["encode_ms.continuous"] = _mean_ms(encodes)
    out["enqueue_ms.traced"] = _mean_ms(
        [(s, e) for name, s, e in tr.host
         if name == "bench.snn_apply_batched"])
    out["idle_gaps"] = idle_gaps(tr)
    out["csnn_device_ops"] = sorted({name for name, _, _ in tr.device
                                     if name.startswith(PREFIX)})
    return out
