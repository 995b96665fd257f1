"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the full 700 W power limit).  A share of a peak is stated with
the card's ``power.limit`` beside it."""

#: float32 operations per second outside the tensor cores
FP32_FLOPS = 67e12
#: HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12
