"""LTPU: Locally-Tuned Processing Units [Moody & Darken, 1989] (port of
``repro.baselines.ltpu``).

An RBF network: k-means centers as units, gaussian activations with the
SVM's gamma, linear read-out weights by ridge regression (the paper used
LIBLINEAR; ridge on +/-1 targets is the equivalent least-squares read-out).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.baselines.common import draw_indices, elapsed, prepare
from repro_torch.baselines.nystrom import _plain_kmeans
from repro_torch.core.kernels import Kernel, gram
from repro_torch.device import as_tensor


@dataclasses.dataclass
class LTPU:
    kernel: Kernel
    centers: torch.Tensor
    w: torch.Tensor
    train_time: float
    use_kernels: bool = False

    def decision(self, Xq) -> torch.Tensor:
        Xq = as_tensor(Xq, self.centers.device, self.centers.dtype)
        return gram(self.kernel, Xq, self.centers,
                    use_kernels=self.use_kernels) @ self.w

    def predict(self, Xq) -> torch.Tensor:
        return torch.sign(self.decision(Xq))


def train_ltpu(X, y, kernel: Kernel, num_units: int = 128,
               reg: float = 1e-3, seed: int = 0, init_idx=None, device=None,
               use_kernels: Optional[bool] = None,
               dtype: torch.dtype = torch.float32) -> LTPU:
    """``init_idx`` as in ``train_llsvm``."""
    X, y, use_kernels = prepare(X, y, device, dtype, use_kernels)
    n = X.shape[0]
    t0 = time.perf_counter()
    centers = _plain_kmeans(X, num_units, draw_indices(n, num_units, seed)
                            if init_idx is None else init_idx)
    Phi = gram(kernel, X, centers, use_kernels=use_kernels)    # (n, u)
    A = Phi.T @ Phi + reg * torch.eye(num_units, dtype=X.dtype,
                                      device=X.device)
    w = torch.linalg.solve(A, Phi.T @ y)
    return LTPU(kernel, centers, w, elapsed(t0, X.device), use_kernels)
