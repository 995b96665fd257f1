"""Network configurations of the port: ``--arch`` ids -> modules with
``FULL`` and ``SMOKE`` (the three CSNN ids, then the ten LM architectures
of ``repro.configs``).  ``csnn-vgg16`` is the port's own: the JAX
package's ``ARCHS`` has no such id."""
from . import (csnn_paper, csnn_vgg16, csnn_wide, deepseek_v2, gemma3_1b,
               granite_34b, llama4_maverick, phi3_medium_14b, qwen2_vl_7b,
               rwkv6_1p6b, stablelm_3b, whisper_medium, zamba2_1p2b)
from .base import SHAPES, SMOKE_SHAPE, ArchConfig, ShapeConfig

CSNN_ARCHS = {"csnn-paper": csnn_paper, "csnn-wide": csnn_wide,
              "csnn-vgg16": csnn_vgg16}
LM_ARCHS = {
    "zamba2-1.2b": zamba2_1p2b,
    "rwkv6-1.6b": rwkv6_1p6b,
    "stablelm-3b": stablelm_3b,
    "granite-34b": granite_34b,
    "phi3-medium-14b": phi3_medium_14b,
    "gemma3-1b": gemma3_1b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "whisper-medium": whisper_medium,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "deepseek-v2-236b": deepseek_v2,
}
ARCHS = {**CSNN_ARCHS, **LM_ARCHS}

# (arch, shape) cells skipped at dry-run time, with the reason recorded in
# the roofline table.
LONG_CONTEXT_OK = {"zamba2-1.2b", "rwkv6-1.6b", "gemma3-1b"}


def skip_reason(arch_id: str, shape_name: str) -> str | None:
    if shape_name == "long_500k" and arch_id not in LONG_CONTEXT_OK:
        if arch_id == "whisper-medium":
            return "enc-dec audio model: 500k-token decode is not meaningful"
        return "pure full-attention arch: long_500k needs sub-quadratic attention"
    return None
