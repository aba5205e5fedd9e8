"""DC-SVM quickstart on the PyTorch/CUDA port: train a kernel SVM by
divide and conquer, compare it with the exact from-zero solver, and serve
with early prediction.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (DCSVMConfig, Kernel, accuracy, fit, gram,
                              kkt_residual, predict_early, predict_exact,
                              resolve_use_kernels, solve_with_shrinking)
from repro_torch.data import gaussian_mixture, train_test_split
from repro_torch.device import resolve_device


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a multi-modal, non-linearly-separable dataset (covtype-style)
    rng = np.random.default_rng(0)
    X, y = gaussian_mixture(rng, args.n, d=16, modes_per_class=8,
                            spread=0.12)
    Xtr, ytr, Xte, yte = (torch.from_numpy(a).to(dev) for a in
                          train_test_split(rng, X, y))
    kern = Kernel("rbf", gamma=16.0)
    C = 4.0

    # 2. exact baseline: greedy CD from zero (the LIBSVM analogue)
    t0 = time.perf_counter()
    K = gram(kern, Xtr, Xtr, use_kernels=resolve_use_kernels(None, dev))
    Q = (ytr[:, None] * ytr[None, :]) * K
    exact = solve_with_shrinking(Q, C, tol=1e-3, max_iters=300_000)
    sync(dev)
    t_exact = time.perf_counter() - t0
    print(f"exact solver: {t_exact:.1f}s, {int(exact.iters)} CD iterations")

    # 3. DC-SVM: two levels of divide and conquer, then the warm-started
    # conquer
    cfg = DCSVMConfig(kernel=kern, C=C, k=4, levels=2, m=500, tol=1e-3)
    t0 = time.perf_counter()
    model = fit(cfg, Xtr, ytr, device=dev)
    sync(dev)
    t_dc = time.perf_counter() - t0
    f_exact = 0.5 * exact.alpha @ Q @ exact.alpha - exact.alpha.sum()
    f_dc = 0.5 * model.alpha @ Q @ model.alpha - model.alpha.sum()
    print(f"DC-SVM: {t_dc:.1f}s | objective {float(f_dc):.4f} "
          f"vs exact {float(f_exact):.4f} "
          f"(rel err {abs(float(f_dc - f_exact) / f_exact):.2e})")
    print(f"KKT residual: {float(kkt_residual(Q, model.alpha, C)):.2e}")
    print(f"test accuracy: {accuracy(yte, predict_exact(model, Xte)):.4f}")

    # 4. early-prediction serving: stop at level 1, route queries to
    # clusters
    cfg_early = DCSVMConfig(kernel=kern, C=C, k=4, levels=2, m=500,
                            tol=1e-3, early_stop_level=1)
    early = fit(cfg_early, Xtr, ytr, device=dev)
    t0 = time.perf_counter()
    acc = accuracy(yte, predict_early(early, Xte))
    t_pred = (time.perf_counter() - t0) / Xte.shape[0]
    print(f"early prediction (eq. 11): acc {acc:.4f}, "
          f"{t_pred * 1e6:.0f} us/query")


if __name__ == "__main__":
    main()
