"""End-to-end conversion driver (paper Sec. VII): train a clamped-ReLU
CNN on the synthetic digit set, convert it to an m-TTFS CSNN, evaluate
both, then quantize to 16- and 8-bit saturating datapaths and evaluate
again.

  PYTHONPATH=src python -m repro_torch.launch.train_csnn          # GPU
  PYTHONPATH=src python -m repro_torch.launch.train_csnn --device cpu --steps 20

The counterpart of ``examples/train_csnn.py``: the same data (seeds 0 and
1), steps, batches and conversion; the weights start from the port's own
seeded init (``csnn.init_params(seed=0)``), not JAX's.  ``--smoke`` runs
the 12x12 SMOKE network instead of the paper's FULL one.
"""
import argparse
import dataclasses
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--n-train", type=int, default=3000)
    ap.add_argument("--n-eval", type=int, default=300)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain path)")
    ap.add_argument("--smoke", action="store_true",
                    help="the 12x12 SMOKE network instead of FULL")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import csnn_paper
    from repro_torch.core.conversion import (ann_accuracy, fit_ann,
                                             normalize_params,
                                             quantize_params,
                                             quantized_threshold,
                                             snn_accuracy)
    from repro_torch.core.csnn import init_params
    from repro_torch.data.synthetic import synth_digits

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu for the plain path)")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    cfg = csnn_paper.SMOKE if args.smoke else csnn_paper.FULL
    print(f"device: {where}")
    print("1) generating synthetic digit data (MNIST stand-in; offline)")
    xtr, ytr = synth_digits(args.n_train, seed=0, hw=cfg.input_hw)
    xte, yte = synth_digits(args.n_eval, seed=1, hw=cfg.input_hw)

    print(f"2) training clamped-ReLU CNN for {args.steps} steps")
    params = init_params(cfg, seed=0, device=device)
    t0 = time.perf_counter()
    params = fit_ann(params, cfg, xtr, ytr, steps=args.steps, log_every=100)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    acc_ann = ann_accuracy(params, cfg, xte, yte)
    print(f"   ANN accuracy: {100 * acc_ann:.1f}% ({train_s:.2f} s, "
          f"{1e3 * train_s / max(args.steps, 1):.2f} ms/step on {where})")

    print("3) converting to SNN (data-based threshold balancing, V_t = 1)")
    params = normalize_params(params, torch.from_numpy(xtr[:256]).to(device),
                              cfg)
    # channel_block sets only the launches per forward (every block size
    # gives the same spikes); JAX's default of 1 walks 74 blocks a step
    acc_snn = snn_accuracy(params, cfg, xte, yte, capacity=400,
                           channel_block=8)
    print(f"   m-TTFS SNN accuracy (T={cfg.t_steps}): {100 * acc_snn:.1f}% "
          f"(gap {100 * (acc_ann - acc_snn):+.2f}pp)")

    for bits in (16, 8):
        conv = {k: v for k, v in params.items() if k.startswith("conv")}
        qp, spec = quantize_params(conv, bits, v_t=cfg.v_t)
        qp.update({k: v for k, v in params.items() if k.startswith("fc")})
        cfg_q = dataclasses.replace(cfg, v_t=quantized_threshold(cfg.v_t,
                                                                 spec))
        acc_q = snn_accuracy(qp, cfg_q, xte, yte, capacity=400,
                             channel_block=8, sat_bits=bits)
        print(f"4) int{bits} saturating datapath: {100 * acc_q:.1f}% "
              f"(scale {spec.scale:.5f}, V_t_int {cfg_q.v_t})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
