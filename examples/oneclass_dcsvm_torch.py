"""One-class SVM through the whole DC-SVM pipeline on the PyTorch/CUDA
port: divide, conquer, serve.

Label-free anomaly detection on the contaminated gaussian_with_outliers
mixture through the same multilevel engine as classification.  The
one-class dual carries the equality constraint ``sum alpha = nu * n``, so
every sub-QP is solved by the pairwise (SMO-style) engine and the divide
step splits the mass target over the clusters in proportion.  The model's
decision is

    f(x) = sum_i alpha_i K(x_i, x) - rho     (f >= 0 <=> inlier)

with rho from the equality multiplier.  The model is compacted into a
ServingModel (one beta column + rho) and served as every other task is.

    PYTHONPATH=src python examples/oneclass_dcsvm_torch.py \\
        [--n 4000 --nu 0.1] [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import (DCSVMConfig, Kernel, OneClassSVM, f1, fit,
                              precision, predict_early, predict_exact,
                              recall)
from repro_torch.data import gaussian_with_outliers, train_test_split
from repro_torch.device import resolve_device
from repro_torch.launch.serve_svm import (export_serving_model,
                                          run_request_loop, serve_batch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--nu", type=float, default=0.1)
    ap.add_argument("--gamma", type=float, default=4.0)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    X, y = gaussian_with_outliers(rng, args.n)
    Xtr, ytr, Xte, yte = (torch.from_numpy(a).to(dev) for a in
                          train_test_split(rng, X, y))
    kern = Kernel("rbf", gamma=args.gamma)
    cfg = DCSVMConfig(kernel=kern, k=4, levels=args.levels,
                      m=min(1000, Xtr.shape[0]), tol=1e-4)
    task = OneClassSVM(nu=args.nu)

    print(f"n_train={Xtr.shape[0]} nu={args.nu} levels={cfg.levels} "
          f"(training is label-free; labels grade the detector)")
    t0 = time.perf_counter()

    def cb(level, alpha, st):
        print(f"  level {level}: clusters={st['clusters']} n_sv={st['n_sv']} "
              f"train_t={st['train_time']:.1f}s", flush=True)

    model = fit(cfg, Xtr, callback=cb, task=task, device=dev)
    n = Xtr.shape[0]
    print(f"total train {time.perf_counter() - t0:.1f}s  "
          f"SVs {len(model.sv_index)}/{n}  rho={model.rho:.4f}  "
          f"sum alpha={float(model.alpha.sum()):.2f} "
          f"(= nu*n = {args.nu * n:.0f})")

    # nu's two-sided property on the training set
    out_frac = float((predict_exact(model, Xtr) < 0).float().mean())
    sv_frac = len(model.sv_index) / n
    print(f"  nu sandwich: outlier-fraction {out_frac:.3f} <= nu={args.nu} "
          f"<= SV-fraction {sv_frac:.3f}")

    def report(tag, pred):
        print(f"  {tag}: outlier recall {recall(yte, pred, -1.0):.4f} "
              f"precision {precision(yte, pred, -1.0):.4f} "
              f"f1 {f1(yte, pred, -1.0):.4f}")

    report("predict_exact", predict_exact(model, Xte))

    # eq.-11 early prediction: per-cluster local one-class models, each
    # feasible for its share of the mass target
    model_early = fit(dataclasses.replace(cfg, early_stop_level=1), Xtr,
                      task=task, device=dev)
    report("predict_early", predict_early(model_early, Xte))

    # serving: one beta column + rho, the same path as SVC and SVR
    idx = np.random.default_rng(0).integers(0, Xte.shape[0],
                                            size=(20, args.batch))
    batches = Xte[torch.from_numpy(idx).to(dev)]
    for strategy, m in [("exact", model), ("early", model_early)]:
        sm = export_serving_model(m, with_bcm=False)
        assert sm.task == "ocsvm"
        pred_s, _ = serve_batch(sm, Xte, kern, strategy)
        rep = run_request_loop(sm, kern, strategy, batches)
        print(f"  serve[{strategy}]: f1 {f1(yte, pred_s, -1.0):.4f} | "
              f"{rep['qps']:.0f} q/s | p50 {rep['lat_ms_p50']:.2f} ms "
              f"p95 {rep['lat_ms_p95']:.2f} ms")


if __name__ == "__main__":
    main()
