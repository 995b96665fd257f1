"""Synaptic adds of every forward answered inside the window (counted by
the reference from its own spikes), over the time from the window's start to the last of them, as a share
of the H100's float32 peak (host clock)."""
from yardstick import peaks


def read(run):
    if not run.adds or not run.span_s:
        return None
    return 100.0 * run.adds / run.span_s / peaks.FP32_FLOPS
