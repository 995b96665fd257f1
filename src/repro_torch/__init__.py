"""PyTorch/CUDA port of the ``repro`` CSNN accelerator reproduction.

Mirrors ``repro``'s module layout (``core/``, ``kernels/``, ``configs/``,
``models/``, ``serve/``, ``launch/``) and imports nothing of it.  The
event-conv and threshold kernels are CUDA C++ for Hopper
(``kernels/csrc``), built with nvcc at first use; every kernel wrapper
runs its plain PyTorch version for CPU tensors.  The LM models
(``models/``) have no kernel of their own: their products are PyTorch
matmuls.
"""
