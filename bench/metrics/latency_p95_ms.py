"""95th percentile, in ms, over every request due in the window, from its
due time to its logits on the host; a request that failed or never
finished counts as missing it (host clock)."""
from yardstick.stats import percentile


def read(run):
    if not run.latencies_s:
        return None
    return 1e3 * percentile(run.latencies_s, 95)
