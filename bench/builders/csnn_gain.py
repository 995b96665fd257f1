"""The builder of a CSNN configuration whose weights carry one power-of-two
gain per conv layer: the draw of ``builders/csnn.py`` (loaded by path,
unchanged), each conv layer's weights and bias times 2**``gain_log2[i]``,
put back on the 2**-``grid_bits`` grid.  A gain of 2**k (k >= 0) keeps
every weight on the grid as it is; a negative one rounds, once, here, and
both sides are given the rounded weights.  Scaling a layer's weights and
bias scales its membranes, so a gain of 2**k fires the layer as a
threshold of v_t / 2**k would (the data-based normalisation of
converted networks, in powers of two).

The program is the port's registered network ``arch``
(``repro_torch.configs.CSNN_ARCHS``), which carries the same network,
plan and gains; set-up refuses a configuration file that differs from it,
so the cell measures the network the port ships.

Configuration keys: those of ``builders/csnn.py``, ``arch``, and
``init["gain_log2"]`` (one integer per conv layer).
"""
from __future__ import annotations

from harness import config as cfgmod
from harness.record import Program

base = cfgmod.load_path("builders/csnn.py")


def apply_gains(params: dict, net: dict, gains, bits: int) -> dict:
    """``params`` with conv layer i's weights and bias times 2**gains[i],
    on the grid of 2**-``bits``."""
    convs = [f"conv{i}" for i, layer in enumerate(net["layers"])
             if "conv" in layer]
    if len(gains) != len(convs):
        raise ValueError(f"{len(gains)} gains for {len(convs)} conv layers")
    out = dict(params)
    for name, g in zip(convs, gains):
        out[name] = {k: base._on_grid(t * 2.0 ** g, bits).contiguous()
                     for k, t in params[name].items()}
    return out


def weights(conf: dict, seed: int, device) -> dict:
    """The benchmark's draw (``builders/csnn.make_weights``) with the
    configuration's gains: what both the program and the reference are
    given."""
    init = conf["init"]
    return apply_gains(base.weights(conf, seed, device), conf["network"],
                       init["gain_log2"], init["grid_bits"])


def check_program(conf: dict):
    """The port's registered network ``conf["arch"]``; raises SystemExit
    where the program has no such network, or one that differs from the
    configuration file in its layers, plan or gains."""
    from repro_torch.configs import CSNN_ARCHS
    arch = conf["arch"]
    if arch not in CSNN_ARCHS:
        raise SystemExit(f"the program has no network {arch!r}; it has "
                         f"{sorted(CSNN_ARCHS)}")
    mod = CSNN_ARCHS[arch]
    cfg = base.program_config(conf["network"])
    differ = [name for name, same in (
        ("network", cfg == mod.FULL), ("plan", conf["plan"] == mod.PLAN),
        ("gains", list(conf["init"]["gain_log2"]) == list(mod.GAIN_LOG2)))
        if not same]
    if differ:
        raise SystemExit(f"{conf['name']}: the file's {', '.join(differ)} "
                         f"differ from the program's {arch!r}")
    return mod


def build(conf: dict, params: dict, device) -> Program:
    """The program set up on ``params`` (``builders/csnn.build``), once its
    registered network is found equal to the file's."""
    check_program(conf)
    return base.build(conf, params, device)
