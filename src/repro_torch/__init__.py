"""PyTorch/CUDA port of the ``repro`` CSNN accelerator reproduction.

Mirrors ``repro``'s module layout (``core/``, ``kernels/``, ``configs/``,
``launch/``) and imports nothing of it.  The event-conv and threshold
kernels are CUDA C++ for Hopper (``kernels/csrc``), built with nvcc at
first use; every kernel wrapper runs its plain PyTorch version for CPU
tensors.
"""
