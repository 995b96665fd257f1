"""``idle_share`` of the served cell, which moves its tail latency
(device trace)."""
from harness.cell import read_metric


def read(run):
    return read_metric("idle_share", run)
