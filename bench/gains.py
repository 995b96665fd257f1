#!/usr/bin/env python3
"""Choose the per-layer power-of-two gains of a configuration drawn with
gains (``builders/csnn_gain.py``).

    python3 bench/gains.py --config csnn_vgg16_cifar --traffic offline-cifar-b256

draws the configuration's weights as the benchmark does, takes the first
``ROWS`` images of the traffic's pool (in the generator's own order) and
walks the conv layers in order in the float64 reference
(``yardstick/reference.py``): for each layer, every gain 2**k with k in
[``LO``, ``HI``] on its weights and bias, put back on the grid; the layer
keeps the k whose fired share at the last time step is nearest
``TARGET`` (ties to the smaller k), and its spikes at that gain feed the
next layer.  It prints the gains, each layer's input density and fired
share, and whether the logits differ between inputs; then the same
readings for the gains the file pins.  Used once, when the configuration
is defined; the file then pins the gains and names these constants under
``assumed``.  A run's seed only permutes channel blocks, so the readings
do not depend on it: the draw here takes seed 0.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

#: pool images the gains are chosen on
ROWS = 64
#: the fired share at the last time step each layer's gain aims at
TARGET = 0.15
#: the range of log2 gains tried on each layer
LO, HI = -4, 8


def layer_walk(params: dict, images, net: dict, gains, bits: int) -> dict:
    """The conv layers in order in float64: with ``gains`` None, each
    layer's gain chosen as the module says; else the given gains.
    Returns {"gains", "density" (each conv layer's input spike density),
    "fired" (each layer's fired share at the last step), "logits"}."""
    import torch

    from yardstick import reference

    def scaled(p, k):
        return {n: torch.round(t * 2.0 ** k * 2.0 ** bits) / 2.0 ** bits
                for n, t in p.items()}

    x = reference.encode(images, net["t_steps"])
    out = {"gains": [], "density": [], "fired": []}
    conv_i = 0
    for i, layer in enumerate(net["layers"]):
        if "conv" not in layer:
            p = params[f"fc{i}"]
            out["logits"] = reference.head(x.flatten(2).sum(1), p["w"],
                                           p["b"], net["t_steps"],
                                           torch.float64)
            break
        out["density"].append(float(x.double().mean()))
        p = params[f"conv{i}"]
        ks = range(LO, HI + 1) if gains is None else [gains[conv_i]]
        best = None
        for k in ks:
            q = scaled(p, k)
            fired = reference.conv_layer(x, q["w"], q["b"], net["v_t"], None,
                                         torch.float64)
            share = float(fired[:, -1].double().mean())
            if best is None or abs(share - TARGET) < abs(best[1] - TARGET):
                best = (k, share, q)
        k, share, q = best
        out["gains"].append(k)
        out["fired"].append(share)
        x = reference.conv_layer(x, q["w"], q["b"], net["v_t"],
                                 layer.get("pool"), torch.float64)
        conv_i += 1
    return out


def main() -> int:
    import argparse

    import torch

    from harness import config
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    args = ap.parse_args()
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    conf = json.loads((config.BENCH_DIR / "configs"
                       / f"{args.config}.json").read_text())
    traffic = json.loads((config.BENCH_DIR / "traffic"
                          / f"{args.traffic}.json").read_text())
    net, init = conf["network"], conf["init"]
    base = config.load_path("builders/csnn.py")
    params = base.weights(conf, 0, device)
    gen = config.load_module("generators", traffic["inputs"]["generator"])
    images = gen.generate(traffic["inputs"], net).data[:ROWS].to(device)
    for label, gains in (("derived", None), ("pinned", init["gain_log2"])):
        t0 = time.perf_counter()
        walk = layer_walk(params, images, net, gains, init["grid_bits"])
        logits = walk.pop("logits")
        walk["distinct_logit_rows"] = len({tuple(r) for r in
                                           logits.cpu().tolist()})
        walk["rows"] = ROWS
        walk["seconds"] = time.perf_counter() - t0
        print(json.dumps({label: walk}), flush=True)
    return 0


if __name__ == "__main__":
    from harness import env  # before torch is imported; not on import,
    env.setup()              # where the tests load ``layer_walk``
    sys.exit(main())
