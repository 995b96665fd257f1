"""Event-conv kernels (batched and single-queue): ``kernel`` (CUDA wrappers), ``ref``
(plain versions), ``ops`` (public wrapper and sizing rules)."""
