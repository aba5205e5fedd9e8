"""LLSVM: k-means Nystrom low-rank linearisation [Zhang et al.; Wang et
al. 2011] (port of ``repro.baselines.nystrom``).

Approximate K ~= K_nb K_bb^-1 K_bn with b landmarks chosen by k-means, map
every point to phi(x) = K_bb^{-1/2} k_b(x) (a rank-b feature space) and
train a linear SVM there with the box-QP block CD.  An approximate solver
in the paper's taxonomy: fast, but its accuracy saturates with b.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.baselines.common import (draw_indices, elapsed, prepare,
                                          signed)
from repro_torch.core import solver as S
from repro_torch.core.kernels import Kernel, gram
from repro_torch.device import as_tensor

# elements of one row chunk's (rows, b, d) distance tensor in
# _plain_kmeans (2**26: 256 MiB in f32; the whole tensor at the covtype
# split, 464,810 x 128 x 54, would be 12.8 GB)
KMEANS_CHUNK = 2 ** 26


def _plain_kmeans(X: torch.Tensor, b: int, init_idx, iters: int = 15
                  ) -> torch.Tensor:
    """Standard (input-space) k-means from the rows ``init_idx``, for
    landmark selection.  The squared distances are taken over row chunks,
    each entry as the reference forms it."""
    n, d = X.shape
    if not isinstance(init_idx, torch.Tensor):
        init_idx = torch.from_numpy(np.array(init_idx, dtype=np.int64))
    centers = X[init_idx.to(X.device)]
    rows = max(1, KMEANS_CHUNK // max(b * d, 1))
    for _ in range(iters):
        a = torch.cat([torch.argmin(torch.sum(
            (X[s:s + rows, None, :] - centers[None, :, :]) ** 2, -1), 1)
            for s in range(0, n, rows)])
        H = torch.zeros((n, b), dtype=X.dtype, device=X.device)
        H.scatter_(1, a[:, None], 1.0)
        cnt = torch.clamp(H.sum(0), min=1.0)
        centers = (H.T @ X) / cnt[:, None]
    return centers


@dataclasses.dataclass
class LLSVM:
    kernel: Kernel
    C: float
    landmarks: torch.Tensor   # (b, d)
    whiten: torch.Tensor      # (b, b) = K_bb^{-1/2}
    w: torch.Tensor           # (b,) linear weights in feature space
    train_time: float
    use_kernels: bool = False

    def features(self, Xq) -> torch.Tensor:
        Xq = as_tensor(Xq, self.landmarks.device, self.landmarks.dtype)
        return gram(self.kernel, Xq, self.landmarks,
                    use_kernels=self.use_kernels) @ self.whiten

    def decision(self, Xq) -> torch.Tensor:
        return self.features(Xq) @ self.w

    def predict(self, Xq) -> torch.Tensor:
        return torch.sign(self.decision(Xq))


def train_llsvm(X, y, kernel: Kernel, C: float, num_landmarks: int = 128,
                tol: float = 1e-3, max_iters: int = 200_000,
                reg: float = 1e-6, seed: int = 0, init_idx=None, device=None,
                use_kernels: Optional[bool] = None,
                dtype: torch.dtype = torch.float32) -> LLSVM:
    """``init_idx``: the k-means init rows (the reference draws them with
    ``jax.random.choice(PRNGKey(seed), n, (b,), replace=False)``); default
    ``draw_indices(n, b, seed)``."""
    X, y, use_kernels = prepare(X, y, device, dtype, use_kernels)
    n, b = X.shape[0], num_landmarks
    t0 = time.perf_counter()
    landmarks = _plain_kmeans(X, b, draw_indices(n, b, seed)
                              if init_idx is None else init_idx)
    Kbb = gram(kernel, landmarks, landmarks, use_kernels=use_kernels)
    eye = torch.eye(b, dtype=X.dtype, device=X.device)
    evals, evecs = torch.linalg.eigh(Kbb + reg * eye)
    # a function of the matrix: the eigenvectors' signs do not matter
    whiten = evecs @ torch.diag(torch.rsqrt(torch.clamp(evals, min=reg))) \
        @ evecs.T
    feats = gram(kernel, X, landmarks, use_kernels=use_kernels) @ whiten
    # the linear SVM's dual, Q = (y y') ∘ (F F'), by the same CD machinery
    res = S.solve_box_qp_block(signed(feats @ feats.T, y), C, tol=tol,
                               max_iters=max_iters, block=min(64, n))
    w = feats.T @ (res.alpha * y)
    return LLSVM(kernel, C, landmarks, whiten, w, elapsed(t0, X.device),
                 use_kernels)
