"""Fault-tolerance control plane of the training loop (``health``) and
the port's named host spans on the profiler's clock (``spans``)."""
