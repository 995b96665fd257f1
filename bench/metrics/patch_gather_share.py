"""Device time of the conv unit's patch gather (``event_conv_gather_kernel``
instances that are not its tile path ``event_conv_gather_kernel_tile``),
over the device time of every gather instance, in % (device trace): the
share of the queue conv's time spent on the path that rereads the queues
once per pixel patch, where a membrane tile is too large for the tile
path or a launch has too few tiles for it (``kernel.tile_path``)."""
from yardstick.stats import covered

GATHER = "event_conv_gather_kernel"
TILE = "event_conv_gather_kernel_tile"


def read(run):
    if run.trace is None:
        return None
    gathers = [(name, s, e) for name, s, e in run.trace.device
               if GATHER in name]
    if not gathers:
        return None
    total = covered([(s, e) for _, s, e in gathers])
    patch = covered([(s, e) for name, s, e in gathers if TILE not in name])
    return 100.0 * patch / total
