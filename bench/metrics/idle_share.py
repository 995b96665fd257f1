"""Share of the traced window with no operation running on the device:
one minus the union of device intervals over the window (device trace)."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
