"""The traced segment of a run: ``torch.profiler`` over whole forwards or
a stretch of requests, reduced to device intervals by kernel name and the
benchmark's own host spans (``bench.*`` annotations), on one clock."""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from yardstick import stats

#: seconds of device work a traced segment covers
TRACE_S = 2.0


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (name, start_us, end_us)
    host: list = field(default_factory=list)    # (name, start_us, end_us)

    @property
    def window_us(self) -> tuple[float, float]:
        """From the first device operation's start to the last one's end:
        the traced forwards' device work and every gap between it."""
        return (min(s for _, s, _ in self.device),
                max(e for _, _, e in self.device))

    @property
    def window_s(self) -> float:
        lo, hi = self.window_us
        return (hi - lo) / 1e6

    @property
    def busy_s(self) -> float:
        return stats.covered([(s, e) for _, s, e in self.device]) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the operations that took the most time."""
        by_name: dict = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[label, seconds] of the longest device idle gaps, each labelled
        by the innermost benchmark span open on the host at its start."""
        out = []
        for a, b in stats.gaps([(s, e) for _, s, e in self.device]):
            open_spans = [(s, n) for n, s, e in self.host if s <= a < e]
            label = max(open_spans)[1] if open_spans else "host: no span"
            out.append([label, (b - a) / 1e6])
        return sorted(out, key=lambda kv: -kv[1])[:top]


def _is_device(event) -> bool:
    """An operation on the card's timeline: a kernel, copy or fill, or the
    mirror of a ``bench.*`` host span, which callers tell apart by name."""
    return str(getattr(event, "device_type", "")).endswith("CUDA")


class Tracer:
    """``torch.profiler`` started and stopped by hand, so that a traced
    stretch can begin and end inside an event loop."""

    def __init__(self):
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> Trace:
        self._prof.stop()
        trace = Trace()
        for e in self._prof.events():
            rng = e.time_range
            span_ = (e.name, float(rng.start), float(rng.end))
            if e.name.startswith("bench."):
                if not _is_device(e):
                    trace.host.append(span_)
            elif _is_device(e):
                trace.device.append(span_)
        return trace


def span(name: str, enabled: bool):
    """A ``bench.<name>`` host span in the trace, or nothing."""
    return record_function(f"bench.{name}") if enabled else \
        contextlib.nullcontext()
