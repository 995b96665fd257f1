"""Hopper kernels of the port and their wrappers.

* ``event_conv`` — the conv units: sequential and interlaced, batched
  (``csrc/event_conv.cu``; replace ``event_conv_pallas_batched`` and
  ``event_conv_pallas_interlaced_batched``) and single-queue (the same
  file; replace ``event_conv_pallas`` and ``event_conv_pallas_interlaced``);
  both are one output-stationary gather per (block, t) over every input
  channel's queues, the interlaced one with the Pallas unit's keep
  predicate (a coordinate repeated in a column-homogeneous group lands
  once); and banked
  (``csrc/event_conv_banked.cu``; the counterpart of the jnp
  ``apply_banked_columns_fused``, the conv unit of the ``banked-cuda`` and
  ``fused-handoff`` variants, one launch per (block, t) over all input
  channels);
* ``threshold_pool`` — the batched threshold unit
  (``csrc/threshold_pool.cu``; replaces ``threshold_pool_pallas``): the
  base mode, and the emit mode, which also writes the next layer's
  fused-handoff carrier (``emit_capacity``);
* ``aeq_build`` — the event-set builder (``csrc/aeq_build.cu``; replaces
  no Pallas kernel, the JAX package builds its queues in jnp): a spike
  chunk straight into the queue variants' segment-padded interlaced
  queues, in the conv unit's launch layout (``aeq.build_launch_queues``);
* ``runtime`` — the CUDA/CPU switch, the nvcc build and the launch
  counters.

Each wrapper runs its plain version (``ref.py``) for CPU tensors: the CPU
tests (``tests/test_torch_kernels.py``, ``tests/test_torch_fused.py``,
``tests/test_torch_single.py``, ``tests/test_torch_seq_gather.py``,
``tests/test_torch_interlaced_gather.py``, ``tests/test_torch_aeq_build.py``)
hold those against the JAX package, and ``chip_smoke.py`` and
``tests/test_torch_gpu.py`` hold the kernels against them on a card.
"""
