"""The paper net with a 5x5 first conv layer (25 interlace banks), which
exercises the parametric k x k event pipeline end to end.  Same shapes
as ``repro.configs.csnn_wide``."""
from repro_torch.core.csnn import CSNNConfig, ConvSpec, FCSpec

FULL = CSNNConfig(
    input_hw=(28, 28),
    layers=(ConvSpec(32, kernel=5), ConvSpec(32, pool=3), ConvSpec(10),
            FCSpec(10)),
    t_steps=5,
)

SMOKE = CSNNConfig(
    input_hw=(12, 12),
    layers=(ConvSpec(8, kernel=5), ConvSpec(8, pool=3), FCSpec(10)),
    t_steps=4,
)
