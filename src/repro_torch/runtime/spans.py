"""Named host spans of the port on ``torch.profiler``'s clock.

``span("conv0")`` marks a stretch of host code as ``csnn.conv0`` in a
profiler trace, with keyword ``args`` (ints or strings: a batch's
sequence number, its sizes) in the range's inputs where the profiler
records them (``record_shapes=True``).  With no profiler running it
costs one check and returns a shared no-op context.  There is no switch
of its own: a running profiler is the switch, and the profiler writes
the spans out with the rest of its trace.

Each span is a function-scope ``RecordFunction``, the scope torch gives
its own operators.  Unlike ``torch.profiler.record_function`` (user
scope), it leaves no mirror on the card's timeline: a device operation
launched inside it keeps its own name there, and a trace reader
attributes it to the span through the launch's correlation (the host
runtime call that launched it starts inside the span).

A span opens and closes inside synchronous code on one thread.  Never
hold one across an ``await``: a range belongs to its thread, and other
tasks on the same event loop open ranges of their own in between.
"""
from __future__ import annotations

import contextlib

import torch

#: the prefix every span of the port carries in a trace
PREFIX = "csnn."

_NULL = contextlib.nullcontext()
_enabled = torch._C._autograd._profiler_enabled
_record = torch._C._profiler._RecordFunctionFast


def span(name: str, **args):
    """``csnn.<name>`` over a ``with`` block while the profiler runs;
    otherwise a shared no-op context."""
    if not _enabled():
        return _NULL
    return _record(PREFIX + name, (), args)
