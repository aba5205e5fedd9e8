"""Random Fourier features, the FastFood analogue [Rahimi-Recht; Le et
al. 2013] (port of ``repro.baselines.rff``).

z(x) = sqrt(2/D) cos(W x + b), W ~ N(0, 2 gamma I), b ~ U[0, 2 pi), so
E[z(x)'z(x')] is the rbf kernel (FastFood's Hadamard trick changes only
the cost of forming Wx, not the estimator).  A linear SVM on z by the
box-QP block CD.  No hand-written kernel runs here: ``X @ W`` is a plain
product.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from repro_torch.baselines.common import elapsed, prepare, signed
from repro_torch.core import solver as S
from repro_torch.core.kernels import Kernel
from repro_torch.device import as_tensor


@dataclasses.dataclass
class RFFSVM:
    Wproj: torch.Tensor
    bias: torch.Tensor
    w: torch.Tensor
    train_time: float

    def features(self, Xq) -> torch.Tensor:
        Xq = as_tensor(Xq, self.Wproj.device, self.Wproj.dtype)
        D = self.Wproj.shape[1]
        return math.sqrt(2.0 / D) * torch.cos(Xq @ self.Wproj + self.bias)

    def decision(self, Xq) -> torch.Tensor:
        return self.features(Xq) @ self.w

    def predict(self, Xq) -> torch.Tensor:
        return torch.sign(self.decision(Xq))


def train_rff(X, y, kernel: Kernel, C: float, num_features: int = 512,
              tol: float = 1e-3, max_iters: int = 200_000, seed: int = 0,
              normal=None, uniform=None, device=None,
              use_kernels: Optional[bool] = None,
              dtype: torch.dtype = torch.float32) -> RFFSVM:
    """``normal`` (d, D) standard normal and ``uniform`` (D,) in [0, 1):
    the draws scaled to W = sqrt(2 gamma) N and b = 2 pi U, as the
    reference scales its ``jax.random`` draws; drawn from a CPU generator
    seeded with ``seed`` where not given.  ``use_kernels`` is taken for a
    common signature: no kernel runs here."""
    if kernel.kind != "rbf":
        raise ValueError("RFF approximates shift-invariant kernels (rbf)")
    X, y, _ = prepare(X, y, device, dtype, use_kernels)
    n, d = X.shape
    D = num_features
    t0 = time.perf_counter()
    if normal is None or uniform is None:
        g = torch.Generator().manual_seed(seed)
        normal = torch.randn((d, D), generator=g, dtype=torch.float64)
        uniform = torch.rand((D,), generator=g, dtype=torch.float64)
    Wproj = math.sqrt(2.0 * kernel.gamma) * as_tensor(normal, X.device,
                                                      X.dtype)
    bias = as_tensor(uniform, X.device, X.dtype) * (2 * math.pi)
    feats = math.sqrt(2.0 / D) * torch.cos(X @ Wproj + bias)
    res = S.solve_box_qp_block(signed(feats @ feats.T, y), C, tol=tol,
                               max_iters=max_iters, block=min(64, n))
    w = feats.T @ (res.alpha * y)
    return RFFSVM(Wproj, bias, w, elapsed(t0, X.device))
