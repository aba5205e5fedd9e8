"""Multiclass one-vs-all DC-SVM on the PyTorch/CUDA port, trained once
and served three ways.

Trains all ``n_classes`` one-vs-rest machines with one shared partition
and one batched CD call a level (the Gram does not depend on the labels),
then compares the three serving strategies (exact / early / bcm) on
accuracy and latency through the serving path.

    PYTHONPATH=src python examples/multiclass_dcsvm_torch.py \\
        [--n 6000 --classes 4] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (DCSVMConfig, Kernel, accuracy_multiclass,
                              fit_ova, predict_bcm_ova, predict_early_ova,
                              predict_exact_ova)
from repro_torch.data import gaussian_mixture_multiclass, train_test_split
from repro_torch.device import resolve_device
from repro_torch.launch.serve_svm import (export_serving_model,
                                          run_request_loop, serve_batch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=6000)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    X, y = gaussian_mixture_multiclass(rng, args.n, n_classes=args.classes,
                                       d=10)
    Xtr, ytr, Xte, yte = (torch.from_numpy(a).to(dev) for a in
                          train_test_split(rng, X, y))
    kern = Kernel("rbf", gamma=8.0)
    cfg = DCSVMConfig(kernel=kern, C=4.0, k=4, levels=args.levels,
                      m=min(1000, Xtr.shape[0]), tol=1e-3)

    print(f"n_train={Xtr.shape[0]} n_classes={args.classes} "
          f"levels={cfg.levels} ({cfg.k ** cfg.levels} bottom clusters, "
          f"{args.classes * cfg.k ** cfg.levels} sub-QPs per bottom level)")
    t0 = time.perf_counter()

    def cb(level, alpha, st):
        print(f"  level {level}: clusters={st['clusters']} n_sv={st['n_sv']} "
              f"train_t={st['train_time']:.1f}s", flush=True)

    model = fit_ova(cfg, Xtr, ytr, callback=cb, device=dev)
    print(f"total train {time.perf_counter() - t0:.1f}s")

    for name, fn in [("exact", predict_exact_ova),
                     ("early", predict_early_ova), ("bcm", predict_bcm_ova)]:
        print(f"  predict_{name}_ova acc: "
              f"{accuracy_multiclass(yte, fn(model, Xte)):.4f}")

    sm = export_serving_model(model)
    idx = np.random.default_rng(0).integers(0, Xte.shape[0],
                                            size=(20, args.batch))
    batches = Xte[torch.from_numpy(idx).to(dev)]
    for strategy in ["exact", "early", "bcm"]:
        pred, _ = serve_batch(sm, Xte, kern, strategy)
        acc = accuracy_multiclass(yte, pred)
        rep = run_request_loop(sm, kern, strategy, batches)
        print(f"  serve[{strategy}]: acc {acc:.4f} | {rep['qps']:.0f} q/s | "
              f"p50 {rep['lat_ms_p50']:.2f} ms p95 {rep['lat_ms_p95']:.2f} ms")


if __name__ == "__main__":
    main()
