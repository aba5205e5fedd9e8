"""CascadeSVM [Graf et al., NIPS 2005] (port of
``repro.baselines.cascade``).

A random (not kernel k-means) binary partition tree: split the data into
2^L random chunks, train an SVM on each, pass only the support vectors of
each pair of siblings to the parent, retrain, repeat to the root.  The
paper's Figure 2 shows why DC-SVM beats it: random partitions have a large
D(pi), and a point dropped at a lower level never comes back.  The
permutation is ``np.random.default_rng(seed)``'s, as the reference's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.baselines.common import elapsed, prepare, signed
from repro_torch.core import solver as S
from repro_torch.core.kernels import Kernel, gram
from repro_torch.device import as_tensor


@dataclasses.dataclass
class CascadeSVM:
    kernel: Kernel
    C: float
    Xsv: torch.Tensor
    ysv: torch.Tensor
    alpha_sv: torch.Tensor
    train_time: float
    sv_index: np.ndarray     # indices into the original training set
    use_kernels: bool = False
    survivors: Tuple[int, ...] = ()   # points passed up from each level

    def decision(self, Xq) -> torch.Tensor:
        Xq = as_tensor(Xq, self.Xsv.device, self.Xsv.dtype)
        w = self.alpha_sv * self.ysv
        return gram(self.kernel, Xq, self.Xsv,
                    use_kernels=self.use_kernels) @ w

    def predict(self, Xq) -> torch.Tensor:
        return torch.sign(self.decision(Xq))


def _solve_chunk(kernel: Kernel, C: float, X: torch.Tensor, y: torch.Tensor,
                 tol: float, max_iters: int, use_kernels: bool
                 ) -> torch.Tensor:
    Q = signed(gram(kernel, X, X, use_kernels=use_kernels), y)
    return S.solve_box_qp(Q, C, tol=tol, max_iters=max_iters).alpha


def train_cascade(X, y, kernel: Kernel, C: float, levels: int = 3,
                  tol: float = 1e-3, max_iters: int = 100_000, seed: int = 0,
                  device=None, use_kernels: Optional[bool] = None,
                  dtype: torch.dtype = torch.float32) -> CascadeSVM:
    X, y, use_kernels = prepare(X, y, device, dtype, use_kernels)
    n = X.shape[0]
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    chunks: List[np.ndarray] = np.array_split(perm, 2 ** levels)

    def survivors_of(idx: np.ndarray):
        idx_t = torch.as_tensor(idx, device=X.device)
        a = _solve_chunk(kernel, C, X[idx_t], y[idx_t], tol, max_iters,
                         use_kernels)
        return idx[(a > 0).cpu().numpy()], a

    # leaves: train each chunk, keep only its SVs
    surviving = [survivors_of(idx)[0] for idx in chunks]
    counts = [sum(len(s) for s in surviving)]
    # cascade: merge sibling SV sets, retrain, keep SVs
    while len(surviving) > 1:
        surviving = [survivors_of(np.concatenate(surviving[i:i + 2]))[0]
                     for i in range(0, len(surviving), 2)]
        counts.append(sum(len(s) for s in surviving))
    final_idx = surviving[0]
    idx_t = torch.as_tensor(final_idx, device=X.device)
    _, a = survivors_of(final_idx)
    keep = (a > 0).cpu().numpy()
    keep_t = torch.as_tensor(keep, device=X.device)
    secs = elapsed(t0, X.device)
    return CascadeSVM(kernel, C, X[idx_t][keep_t], y[idx_t][keep_t],
                      a[keep_t], secs, final_idx[keep], use_kernels,
                      tuple(counts + [int(keep.sum())]))
