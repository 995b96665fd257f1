"""The event-set builder: ``kernel`` (CUDA wrapper of
``csrc/aeq_build.cu``), ``ref`` (its plain version)."""
