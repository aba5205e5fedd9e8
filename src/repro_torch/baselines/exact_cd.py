"""LIBSVM analogue: the exact whole-problem solver from zero (port of
``repro.baselines.exact_cd``).

Greedy coordinate descent with shrinking on the full bias-free dual, the
solver family LIBSVM uses (maximal-violation working sets; one coordinate
suffices without the bias).  The paper's primary exact baseline: DC-SVM
warm-starts this solver from the divide step's solution.  Above
``full_gram_threshold`` points it runs the Gram-free block CD
(``solve_box_qp_matvec``: on the card the graphed level-0 engine, one
``cd_column_update`` launch an iteration).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.baselines.common import elapsed, prepare, signed
from repro_torch.core import solver as S
from repro_torch.core.kernels import Kernel, gram
from repro_torch.device import as_tensor
from repro_torch.obs.trace import ConvTrace


@dataclasses.dataclass
class ExactSVM:
    kernel: Kernel
    C: float
    X: torch.Tensor
    y: torch.Tensor
    alpha: torch.Tensor
    iters: int
    pg_max: float
    train_time: float
    use_kernels: bool = False
    trace: Optional[ConvTrace] = None   # the solver's ring, when traced

    def decision(self, Xq, chunk: int = 4096) -> torch.Tensor:
        """sum_j K(x, x_j) alpha_j y_j over ``chunk`` training rows at a
        time (``kermat`` with ``use_kernels``)."""
        Xq = as_tensor(Xq, self.X.device, self.X.dtype).contiguous()
        w = self.alpha * self.y
        out = torch.zeros(Xq.shape[0], dtype=Xq.dtype, device=Xq.device)
        n = self.X.shape[0]
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            out = out + gram(self.kernel, Xq, self.X[s:e],
                             use_kernels=self.use_kernels) @ w[s:e]
        return out

    def predict(self, Xq) -> torch.Tensor:
        return torch.sign(self.decision(Xq))


def train_exact(X, y, kernel: Kernel, C: float, tol: float = 1e-3,
                max_iters: int = 300_000, shrink_rounds: int = 3,
                block: int = 0, alpha0=None,
                full_gram_threshold: int = 16384, device=None,
                use_kernels: Optional[bool] = None,
                dtype: torch.dtype = torch.float32, grad_chunks: int = 16,
                trace: Optional[ConvTrace] = None) -> ExactSVM:
    """Solve the whole dual from ``alpha0`` (default zero) on ``device``
    (default ``cuda``).  ``grad_chunks`` is the plain initial gradient's row
    chunk count on the Gram-free branch (the solver's default 16);
    ``trace`` records a sample an iteration, as the solvers do."""
    X, y, use_kernels = prepare(X, y, device, dtype, use_kernels)
    if alpha0 is not None:
        alpha0 = as_tensor(alpha0, X.device, X.dtype)
    t0 = time.perf_counter()
    n = X.shape[0]
    if n <= full_gram_threshold:
        Q = signed(gram(kernel, X, X, use_kernels=use_kernels), y)
        res = S.solve_with_shrinking(Q, C, alpha0=alpha0, tol=tol,
                                     max_iters=max_iters,
                                     rounds=shrink_rounds, block=block,
                                     trace=trace)
    else:
        res = S.solve_box_qp_matvec(X, y, kernel, C, alpha0=alpha0, tol=tol,
                                    max_iters=max_iters,
                                    block=max(block, 64),
                                    grad_chunks=grad_chunks,
                                    use_kernels=use_kernels, trace=trace)
    secs = elapsed(t0, X.device)
    return ExactSVM(kernel, C, X, y, res.alpha, int(res.iters),
                    float(res.pg_max), secs, use_kernels, res.trace)
