"""Quickstart of the port: event-driven spiking inference on one image.

  PYTHONPATH=src python -m repro_torch.launch.quickstart           # GPU
  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu --smoke

The paper's pipeline on a single sample: m-TTFS multi-threshold encoding
-> AEQ compaction -> event-driven convolution (Algorithm 1) -> OR-pool ->
spike-integrating classifier, held against the dense frame-based oracle.
The counterpart of ``examples/quickstart.py`` (same image generator and
seed, weights from the port's own seeded init).  Exits 1 when the
event-driven logits and the dense oracle's disagree.
"""
import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain path)")
    ap.add_argument("--smoke", action="store_true",
                    help="the 12x12 SMOKE network instead of FULL")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import csnn_paper
    from repro_torch.core.aeq import build_aeq
    from repro_torch.core.csnn import (encode_input, init_params, snn_apply,
                                       snn_apply_dense)
    from repro_torch.data.synthetic import synth_digits

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu for the plain path)")
    cfg = csnn_paper.SMOKE if args.smoke else csnn_paper.FULL
    print(f"CSNN: {cfg.layers}, T={cfg.t_steps} time steps (m-TTFS), "
          f"device={device}")
    images, _ = synth_digits(1, seed=42, hw=cfg.input_hw)
    img = torch.from_numpy(images).to(device)

    spikes = encode_input(img, cfg)[0]  # (T, H, W, 1)
    per_step = spikes.sum(dim=(1, 2, 3)).tolist()
    sparsity = 100 * (1 - spikes.float().mean().item())
    print(f"input spikes per time step: {per_step} "
          f"(sparsity {sparsity:.1f}%)")

    q = build_aeq(spikes[2, :, :, 0], capacity=784)
    print(f"AEQ at t=2: {int(q.count)} events, first 5 (interlaced order): "
          f"{q.coords[:5].tolist()}")

    params = init_params(cfg, seed=0, device=device)
    logits, stats = snn_apply(params, spikes, cfg, capacity=784)
    logits_dense = snn_apply_dense(params, spikes, cfg)
    match = bool(torch.allclose(logits, logits_dense, atol=1e-4))
    print(f"event-driven logits argmax: {int(logits.argmax())}; "
          f"dense-oracle match: {match}")
    for li, st in enumerate(stats):
        print(f"  layer {li + 1}: input sparsity "
              f"{100 * float(st.in_sparsity):.1f}%, events/step "
              f"{st.in_spike_counts.sum(dim=1).tolist()}")
    return 0 if match else 1


if __name__ == "__main__":
    sys.exit(main())
