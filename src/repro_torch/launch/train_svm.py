"""DC-SVM end-to-end training command line (binary C-SVC).

    PYTHONPATH=src python -m repro_torch.launch.train_svm --task svc \\
        --dataset covtype_like --n 20000 --levels 3 [--early 2] [--device cuda]

Prints one line per level and the reference CLI's summary line for ``svc``
(exact test accuracy, or early prediction at ``--early``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import (DCSVMConfig, Kernel, accuracy, fit,
                              predict_early, predict_exact)
from repro_torch.data import covtype_like, gaussian_mixture, train_test_split

DATASETS = {
    "covtype_like": covtype_like,
    "gaussian": lambda rng, n: gaussian_mixture(rng, n, d=16,
                                                modes_per_class=8),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="svc", choices=["svc"])
    ap.add_argument("--dataset", default="gaussian", choices=sorted(DATASETS))
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--C", type=float, default=4.0)
    ap.add_argument("--gamma", type=float, default=8.0)
    ap.add_argument("--kernel", default="rbf", choices=["rbf", "poly", "linear"])
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--m", type=int, default=1000)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--block", type=int, default=0)
    ap.add_argument("--early", type=int, default=0,
                    help="stop at this level and use early prediction")
    ap.add_argument("--gram-budget", type=int, default=0,
                    help="byte budget for a level's batch of cluster Grams "
                         "(0 = default)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    X, y = DATASETS[args.dataset](rng, args.n)
    Xtr, ytr, Xte, yte = train_test_split(rng, X, y)
    extra = {"gram_budget": args.gram_budget} if args.gram_budget > 0 else {}
    cfg = DCSVMConfig(kernel=Kernel(args.kernel, gamma=args.gamma), C=args.C,
                      k=args.k, levels=args.levels, m=args.m, tol=args.tol,
                      block=args.block, early_stop_level=args.early,
                      seed=args.seed, **extra)

    def cb(level, alpha, st):
        print(f"level {level}: clusters={st.get('clusters', 1)} "
              f"n_sv={st['n_sv']} cluster_t={st.get('cluster_time', 0):.1f}s "
              f"train_t={st['train_time']:.1f}s", flush=True)

    t0 = time.perf_counter()
    model = fit(cfg, Xtr, ytr, callback=cb, device=args.device)
    t_train = time.perf_counter() - t0
    if model.is_early:
        pred = predict_early(model, Xte)
        mode = f"early prediction (level {args.early})"
    else:
        pred = predict_exact(model, Xte)
        mode = "exact"
    print(f"done in {t_train:.1f}s | {mode} | test acc "
          f"{accuracy(yte, pred.cpu()):.4f} | "
          f"SVs {len(model.sv_index)}/{Xtr.shape[0]}", flush=True)


if __name__ == "__main__":
    main()
