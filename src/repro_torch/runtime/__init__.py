"""Fault-tolerance control plane of the training loop (``health``)."""
