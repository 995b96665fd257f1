"""The process environment every benchmark entry point sets before it
imports torch."""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def setup() -> None:
    """Put the port on the path, keep every build and kernel cache at a
    fixed path inside the checkout, and run the host side on one CPU
    thread: the card's host is shared, and PyTorch's default of one
    OpenMP thread per core made the served cell's tail latency swing by
    tens of percent between runs of the same code."""
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
