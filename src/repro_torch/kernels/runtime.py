"""Kernel runtime shared by every wrapper in ``kernels/*``.

Three jobs, the counterpart of ``repro.kernels.runtime``:

* **The backend switch** (:func:`use_kernel`).  A wrapper launches its
  CUDA kernel for a tensor on a CUDA device and runs its plain PyTorch
  version for a tensor on the CPU.  There is no fallback: a CUDA tensor
  either goes through the kernel or the wrapper raises.
* **The build.**  Each ``csrc/*.cu`` source is compiled by ``nvcc`` for
  ``sm_90a`` into its own shared library with a plain C interface, at
  first use, under ``build/repro_torch/`` of the checkout
  (``REPRO_TORCH_BUILD_DIR`` overrides).  A library's file name carries a
  hash of its source and flags, so an edited source rebuilds and an
  unchanged one loads straight from disk.  :func:`build_all` starts one
  ``nvcc`` per source, all at once.
* **Launch counters** (:data:`LAUNCHES`): one plain int per kernel, which
  each wrapper bumps exactly where it launches, so a run can show which
  kernels the main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: ``-lineinfo`` lets compute-sanitizer name source lines; it does not
#: change the generated code
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("event_conv", "event_conv_banked", "threshold_pool", "aeq_build")

#: launches per kernel since the last :func:`reset_launches`;
#: ``event_conv_interlaced_tile`` counts the batched interlaced launches
#: that took the tile path (each also counts as ``event_conv_interlaced``);
#: ``aeq_build`` the event-set builder's, one per queue layer and chunk
LAUNCHES = {"event_conv_seq": 0, "event_conv_interlaced": 0,
            "event_conv_banked": 0, "threshold_pool": 0,
            "threshold_pool_emit": 0, "event_conv_seq_single": 0,
            "event_conv_interlaced_single": 0,
            "event_conv_interlaced_tile": 0, "aeq_build": 0}

#: dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.int16: 1, torch.int8: 2}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when all lie on
    the CPU; mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel operands must all be on one CUDA device or all "
                     f"on the CPU, got devices {sorted(kinds)}")


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from kernels/csrc at first "
                       "use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{key}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (popen, tmp_path, target) or
    None when the library is already on disk."""
    target = _target(name)
    if target.exists():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish_build(name: str, job) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    BUILD_LOGS[name] = out
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent build never sees a stub


def build_all() -> float:
    """Build every missing kernel library, one nvcc per source, all in
    parallel; returns the wall seconds spent."""
    t0 = time.perf_counter()
    jobs = {name: _start_build(name) for name in SOURCES}
    for name, job in jobs.items():
        if job is not None:
            _finish_build(name, job)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use; a
    first use that finds it missing builds every missing library at once
    (:func:`build_all`), so a forward's first launches wait for the
    slowest nvcc, not for their sum."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        msg = lib.cuda_error_string(ctypes.c_int(status)).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
