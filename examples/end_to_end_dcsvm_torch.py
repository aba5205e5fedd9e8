"""End-to-end driver on the PyTorch/CUDA port: a multilevel DC-SVM fit
with checkpoints after every level and the whole of Algorithm 1, on a
covtype-style synthetic dataset (the paper's flagship experiment shape).

About 20k training points, 3 levels (64 -> 16 -> 4 clusters), adaptive
clustering from the lower level's support vectors, the refine pass, the
exact conquer to the paper's stopping rule, then exact and early
prediction.

    PYTHONPATH=src python examples/end_to_end_dcsvm_torch.py \\
        [--n 20000] [--device cpu] [--ckpt-dir DIR]
"""
import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.core import (DCSVMConfig, Kernel, accuracy, fit,
                              objective_value, predict_early, predict_exact)
from repro_torch.data import covtype_like, train_test_split
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "dcsvm_e2e_torch"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    X, y = covtype_like(rng, args.n)
    Xtr, ytr, Xte, yte = (torch.from_numpy(a).to(dev) for a in
                          train_test_split(rng, X, y))
    kern = Kernel("rbf", gamma=32.0)
    cfg = DCSVMConfig(kernel=kern, C=8.0, k=4, levels=args.levels, m=1000,
                      tol=1e-3, adaptive=True, refine=True,
                      full_gram_threshold=24_000)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    print(f"n_train={Xtr.shape[0]} n_test={Xte.shape[0]} d={Xtr.shape[1]} "
          f"levels={cfg.levels} (bottom: {cfg.k ** cfg.levels} clusters)")
    t0 = time.perf_counter()

    def cb(level, alpha, st):
        el = time.perf_counter() - t0
        print(f"  [t={el:7.1f}s] level {level}: "
              f"clusters={st.get('clusters', 1)} n_sv={st['n_sv']}"
              f" cluster_t={st.get('cluster_time', 0.0):.1f}s"
              f" train_t={st['train_time']:.1f}s", flush=True)
        mgr.save(cfg.levels - level + 1, {"alpha": alpha})

    model = fit(cfg, Xtr, ytr, callback=cb, device=dev)
    t_total = time.perf_counter() - t0
    mgr.wait()

    f_final = float(objective_value(cfg, Xtr, ytr, model.alpha))
    acc = accuracy(yte, predict_exact(model, Xte))
    n_sv = int((model.alpha > 0).sum())
    print(f"total {t_total:.1f}s | f(alpha)={f_final:.2f} | "
          f"SVs {n_sv}/{Xtr.shape[0]} | exact test acc {acc:.4f}")
    print(f"checkpoints: steps {mgr.steps()} in {args.ckpt_dir}")

    cfg_e = dataclasses.replace(cfg, early_stop_level=1)
    t0 = time.perf_counter()
    me = fit(cfg_e, Xtr, ytr, device=dev)
    t_early = time.perf_counter() - t0
    acc_e = accuracy(yte, predict_early(me, Xte))
    print(f"DC-SVM (early): {t_early:.1f}s, acc {acc_e:.4f} "
          f"({t_total / max(t_early, 1e-9):.1f}x faster than exact)")


if __name__ == "__main__":
    main()
