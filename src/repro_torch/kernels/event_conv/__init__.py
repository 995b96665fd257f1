"""Batched event-conv kernels: ``kernel`` (CUDA wrappers), ``ref``
(plain versions), ``ops`` (public wrapper and sizing rules)."""
