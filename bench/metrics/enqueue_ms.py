"""Mean host ms to enqueue one forward: the benchmark's own span around
each ``snn_apply_batched`` call in the window, with no synchronise
(program span)."""


def read(run):
    if not run.enqueue_s:
        return None
    return 1e3 * sum(run.enqueue_s) / len(run.enqueue_s)
