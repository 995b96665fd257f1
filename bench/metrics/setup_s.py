"""Seconds from the process's start to the first timed request: imports,
CUDA start-up, kernel builds, weights and inputs from the seed, and the
warm-up of every shape the traffic uses (host clock)."""


def read(run):
    return run.setup_s
