"""Real requests per flushed batch over ``max_batch``, in %, from the
engine's own counters over the window (program counter)."""


def read(run):
    if not run.engine or not run.engine["batches"]:
        return None
    return 100.0 * run.engine["requests"] / (run.engine["batches"]
                                             * run.max_batch)
