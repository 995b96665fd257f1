"""The least time of the traced forwards' conv work (``yardstick.counts``)
over the device's busy time while it ran, in % (device trace)."""


def read(run):
    if run.trace is None or not run.trace.device or not run.traced_least_s:
        return None
    return 100.0 * run.traced_least_s / run.trace.busy_s
