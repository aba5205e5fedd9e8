"""epsilon-SVR through the whole DC-SVM pipeline on the PyTorch/CUDA
port: divide, conquer, serve.

Trains an epsilon-insensitive SVR on Friedman #1 through the same
multilevel engine as classification (one generalised dual: the
2n-variable (alpha, alpha*) problem clusters by base sample, so mirrored
coordinates share a sub-QP), compacts the collapsed beta coefficients into
a ServingModel and serves batched regression requests.

Two models are exported: the exact final solve (served ``exact``) and an
early-stopped level-1 model whose per-cluster local SVRs are what eq. 11
routes to (served ``early``; an exact model's beta is not
cluster-separable).

    PYTHONPATH=src python examples/svr_dcsvm_torch.py \\
        [--n 4000 --levels 2] [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import (DCSVMConfig, EpsilonSVR, Kernel, fit, mae,
                              mse, predict_early, predict_exact)
from repro_torch.data import friedman1, train_test_split
from repro_torch.device import resolve_device
from repro_torch.launch.serve_svm import (export_serving_model,
                                          run_request_loop, serve_batch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--C", type=float, default=4.0)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    X, y = friedman1(rng, args.n)
    Xtr, ytr, Xte, yte = (torch.from_numpy(a).to(dev) for a in
                          train_test_split(rng, X, y))
    kern = Kernel("rbf", gamma=args.gamma)
    cfg = DCSVMConfig(kernel=kern, C=args.C, k=4, levels=args.levels,
                      m=min(1000, Xtr.shape[0]), tol=1e-3)
    task = EpsilonSVR(eps=args.eps)

    print(f"n_train={Xtr.shape[0]} dual_vars={2 * Xtr.shape[0]} "
          f"levels={cfg.levels} eps={args.eps}")
    t0 = time.perf_counter()

    def cb(level, alpha, st):
        print(f"  level {level}: clusters={st['clusters']} n_sv={st['n_sv']} "
              f"train_t={st['train_time']:.1f}s", flush=True)

    model = fit(cfg, Xtr, ytr, callback=cb, task=task, device=dev)
    print(f"total train {time.perf_counter() - t0:.1f}s  "
          f"SVs {len(model.sv_index)}/{Xtr.shape[0]}")

    base = float(torch.mean((yte - torch.mean(ytr)) ** 2))
    pred = predict_exact(model, Xte)
    print(f"  predict_exact : mse {mse(yte, pred):.5f} "
          f"mae {mae(yte, pred):.5f}  (predict-the-mean baseline mse "
          f"{base:.5f})")

    # eq.-11 early prediction wants locally trained models: stop at level
    # 1 and let each cluster keep its own SVR
    model_early = fit(dataclasses.replace(cfg, early_stop_level=1), Xtr, ytr,
                      task=task, device=dev)
    pred_e = predict_early(model_early, Xte)
    print(f"  predict_early : mse {mse(yte, pred_e):.5f} "
          f"mae {mae(yte, pred_e):.5f}  (level-1 local models)")

    # serving: compacted beta-form models, the same path as SVC
    idx = np.random.default_rng(0).integers(0, Xte.shape[0],
                                            size=(20, args.batch))
    batches = Xte[torch.from_numpy(idx).to(dev)]
    for strategy, m in [("exact", model), ("early", model_early)]:
        sm = export_serving_model(m, with_bcm=False)
        pred_s, _ = serve_batch(sm, Xte, kern, strategy)
        rep = run_request_loop(sm, kern, strategy, batches)
        print(f"  serve[{strategy}]: mse {mse(yte, pred_s):.5f} | "
              f"{rep['qps']:.0f} q/s | p50 {rep['lat_ms_p50']:.2f} ms "
              f"p95 {rep['lat_ms_p95']:.2f} ms")


if __name__ == "__main__":
    main()
