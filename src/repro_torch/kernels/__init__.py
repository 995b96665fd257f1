"""Hopper kernels of the port and their wrappers.

* ``event_conv`` — the batched sequential and interlaced conv units
  (``csrc/event_conv.cu``; replace ``event_conv_pallas_batched`` and
  ``event_conv_pallas_interlaced_batched``);
* ``threshold_pool`` — the batched threshold unit
  (``csrc/threshold_pool.cu``; replaces ``threshold_pool_pallas``);
* ``runtime`` — the CUDA/CPU switch, the nvcc build and the launch
  counters.
"""
