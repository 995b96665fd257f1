"""VGG-16 in its CIFAR-10 form as an m-TTFS CSNN (T=5): configuration D
of Simonyan & Zisserman (arXiv:1409.1556, Table 1), thirteen 3x3 SAME
convolutions ``64,64,M,128,128,M,256,256,256,M,512,512,512,M,512,512,512,M``
on a 32x32x3 input, five 2x2 pools down to 1x1x512 and one classifier
``Linear(512, 10)`` (github.com/kuangliu/pytorch-cifar ``models/vgg.py``).

Its spiking form is the paper's (arXiv:2203.12437, Sec. VII): m-TTFS
input coding of each of the 3 channels, the IF neuron with its fired
latch in place of ReLU, OR-pool in place of max-pool (exact on binary
spikes), batch norm folded into the conv weights and biases, and the head
reading the 512 spike counts.  No width is cut.  The JAX package has no
counterpart of this network.

``PLAN`` is the offline plan pinned for ``FULL`` (``plan_network``'s
per-layer knobs): capacities H*W, so no queue drops an event; channel
blocks that widen as the maps shrink, so that each layer's membrane tile
stays on the interlaced unit's tile path (at most
``kernels.event_conv.kernel.TILE_MAX_BYTES``) with few launches: 78
channel blocks, 780 kernel launches a forward; ``event_par`` 8 on the
32x32 and 16x16 maps, 4 on the 8x8 ones, 2 below, where a column holds
at most a few pixels.

``GAIN_LOG2`` holds one power-of-two gain per conv layer for weights
drawn He-normal on a 2**-14 grid (the benchmark's draw): without them the
input density falls layer by layer and the last layers receive no
events.  They were chosen greedily, layer by layer, for a fired share
near 15 % at the last step on the benchmark's synthetic images
(``bench/gains.py``); powers of two keep the weights on the grid.
"""
from repro_torch.core.csnn import CSNNConfig, ConvSpec, FCSpec

#: output channels per conv layer; a 2x2 pool follows each of these
WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
POOLED = (1, 3, 6, 9, 12)


def _layers(widths, n_out: int = 10):
    return tuple(ConvSpec(c, pool=2 if i in POOLED else None)
                 for i, c in enumerate(widths)) + (FCSpec(n_out),)


FULL = CSNNConfig(input_hw=(32, 32), input_channels=3,
                  layers=_layers(WIDTHS), t_steps=5, v_t=1.0)

#: every conv and pool of FULL at 1/16 of its widths, for the CPU tests
SMOKE = CSNNConfig(input_hw=(32, 32), input_channels=3,
                   layers=_layers(tuple(c // 16 for c in WIDTHS)),
                   t_steps=5, v_t=1.0)

PLAN = {
    "capacity": [1024, 1024, 256, 256, 64, 64, 64, 16, 16, 16, 4, 4, 4],
    "channel_block": [4, 4, 16, 16, 64, 64, 64, 128, 128, 128, 256, 256,
                      256],
    "event_par": [8, 8, 8, 8, 4, 4, 4, 2, 2, 2, 2, 2, 2],
    "batch_tile": 8,
}

GAIN_LOG2 = (-2, 0, 0, 1, 0, 1, 1, 0, 1, 1, 1, 1, 2)
