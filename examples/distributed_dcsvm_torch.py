"""Distributed DC-SVM on the PyTorch/CUDA port over torch.distributed.

The divide step solves each rank's clusters with no collective (each
rank's Grams stay on its own device); the conquer runs
communication-efficient parallel block minimisation: every rank solves
its own top-B sub-QP a round and one all-gather ships the P rank-B
updates, so the descent a communication round grows with the rank count.
The replicated mode (one global block a round) is timed beside it.

    PYTHONPATH=src OMP_NUM_THREADS=1 python -m torch.distributed.run \\
        --standalone --nproc-per-node 2 \\
        examples/distributed_dcsvm_torch.py [--device cpu] \\
        [--dist-backend gloo|nccl]

gloo lets the ranks share one card or run on the CPU; NCCL takes one GPU
a rank.  Run alone (without torch.distributed.run) it is a world of one.
Only rank 0 prints.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import (DCSVMConfig, Kernel, gram, kkt_residual,
                              resolve_use_kernels)
from repro_torch.core.distributed import (ConquerConfig, conquer_step,
                                          fit_distributed)
from repro_torch.data import gaussian_mixture
from repro_torch.launch.mesh import make_conquer_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"])
    args = ap.parse_args(argv)
    mesh = make_conquer_mesh("i", device=args.device,
                             backend=args.dist_backend)
    lead = mesh.rank == 0
    try:
        if lead:
            print(f"ranks: {mesh.size} ({mesh.backend or 'no process group'})"
                  f", device {mesh.device}")
        kern = Kernel("rbf", gamma=8.0)
        X, y = (torch.from_numpy(a).to(mesh.device) for a in gaussian_mixture(
            np.random.default_rng(0), args.samples, d=8, modes_per_class=4))
        C = 4.0

        cfg = DCSVMConfig(kernel=kern, C=C, k=4, levels=2, m=400, tol=1e-3)
        t0 = time.perf_counter()
        alpha, stats = fit_distributed(cfg, mesh, "i", X, y,
                                       conquer_block=32)
        t = time.perf_counter() - t0
        Q = (y[:, None] * y[None, :]) * gram(
            kern, X, X, use_kernels=resolve_use_kernels(None, mesh.device))
        if lead:
            for st in stats:
                print("  ", {k: v for k, v in st.items() if k != "trace"})
            print(f"distributed DC-SVM: {t:.1f}s | KKT residual "
                  f"{float(kkt_residual(Q, alpha, C)):.2e} | "
                  f"SVs {int((alpha > 0).sum())}")

        # the conquer alone from zero: P parallel blocks against one
        # replicated block
        ccfg = ConquerConfig(kernel=kern, C=C, tol=1e-3, max_iters=10_000,
                             block=32, mode="parallel")
        for mode in ("parallel", "replicated"):
            t0 = time.perf_counter()
            _, rounds, pg = conquer_step(
                mesh, "i", dataclasses.replace(ccfg, mode=mode), X, y,
                torch.zeros(X.shape[0], dtype=X.dtype, device=X.device))[:3]
            t2 = time.perf_counter() - t0
            if lead:
                print(f"conquer from zero [{mode:>10}]: {t2:.1f}s, "
                      f"{int(rounds)} communication rounds, "
                      f"pg_max {float(pg):.2e}")
    finally:
        mesh.close()


if __name__ == "__main__":
    main()
