"""Device time in operations other than the program's hand-written CUDA
kernels (torch's sorts, scans, scatters, copies), as a share of the
device's busy time in the traced window (device trace)."""
from yardstick.stats import covered

#: the __global__ functions of the program's CUDA sources, as the
#: profiler names them (a template's name carries its arguments)
PORT_KERNELS = ("event_conv_gather_kernel", "event_conv_banked_kernel",
                "threshold_pool_kernel", "threshold_pool_emit_kernel")


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    glue = covered([(s, e) for name, s, e in run.trace.device
                    if not any(k in name for k in PORT_KERNELS)]) / 1e6
    return 100.0 * glue / run.trace.busy_s
