"""The paper's own architecture: 28x28-32C3-32C3-P3-10C3-F10 m-TTFS CSNN
(T=5), trained by ANN->SNN conversion (Sec. VII).  Same shapes as
``repro.configs.csnn_paper``."""
from repro_torch.core.csnn import CSNNConfig, ConvSpec, FCSpec

FULL = CSNNConfig(
    input_hw=(28, 28),
    layers=(ConvSpec(32), ConvSpec(32, pool=3), ConvSpec(10), FCSpec(10)),
    t_steps=5,
)

SMOKE = CSNNConfig(
    input_hw=(12, 12),
    layers=(ConvSpec(8), ConvSpec(8, pool=3), FCSpec(10)),
    t_steps=4,
)
