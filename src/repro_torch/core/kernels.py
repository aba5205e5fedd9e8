"""Kernel functions for DC-SVM (port of ``repro.core.kernels``).

A ``Kernel`` carries the hyper-parameters plus a plain-torch pairwise
evaluation.  Heavy Gram work goes through ``gram`` / ``gram_matvec``, which
take the hand-written CUDA kernels (``repro_torch.kernels.ops``) when
``use_kernels`` is set and the plain torch expressions otherwise.

Precision policy (``compute_dtype``): ``None``, or the data's own dtype,
keeps the plain arithmetic bit for bit.  ``"bfloat16"`` rounds the product
operands to bf16 (to nearest even), accumulates their products in f32
(also for float64 data), takes the rbf norms of the rounded rows in f32
and applies the transform in f32.

RBF  K(x, z) = exp(-gamma |x - z|^2)   (the paper's main kernel)
poly K(x, z) = (gamma x'z + coef0)^degree
linear K(x, z) = x'z
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ops import resolve_compute_dtype

# Gram memory budget in BYTES (2**29 = 512 MiB), the reference's default:
# it sizes the per-level cluster batches and the plain matvec's row chunks.
DEFAULT_GRAM_BUDGET = 2 ** 29


def auto_num_chunks(n_rows: int, n_cols: int, itemsize: int = 4,
                    budget_bytes: Optional[int] = None) -> int:
    """Smallest chunk count whose (n_rows/chunks, n_cols) row block fits the
    byte budget.  Chunking only partitions output rows."""
    budget = DEFAULT_GRAM_BUDGET if budget_bytes is None else int(budget_bytes)
    total = int(n_rows) * int(n_cols) * int(itemsize)
    return max(1, min(int(n_rows), -(-total // max(budget, 1))))


@dataclasses.dataclass(frozen=True)
class Kernel:
    """Kernel hyper-parameters. ``kind`` in {"rbf", "poly", "linear"}."""

    kind: str = "rbf"
    gamma: float = 1.0
    degree: int = 3
    coef0: float = 0.0

    def __post_init__(self):
        if self.kind not in ("rbf", "poly", "linear"):
            raise ValueError(f"unknown kernel kind: {self.kind}")

    def pairwise(self, X: torch.Tensor, Y: torch.Tensor,
                 compute_dtype=None) -> torch.Tensor:
        """K(X, Y): (..., n, d) x (..., m, d) -> (..., n, m) in plain torch,
        in the inputs' dtype; under a bf16 ``compute_dtype`` in f32 from
        the rounded operands (the module's policy, no mean shift)."""
        cd = resolve_compute_dtype(compute_dtype, X.dtype)
        if cd is None:
            if self.kind == "linear":
                return X @ Y.mT
            if self.kind == "poly":
                return (self.gamma * (X @ Y.mT) + self.coef0) ** self.degree
            return torch.exp(-self.gamma * sqdist(X, Y))
        # the rounded operands are exact in f32, and so is each product;
        # the sums run in f32, as preferred_element_type=float32 does
        return ref.kermat_rounded(ref.rounded(X, cd), ref.rounded(Y, cd),
                                  kind=self.kind, gamma=self.gamma,
                                  degree=self.degree, coef0=self.coef0)

    def diag(self, X: torch.Tensor) -> torch.Tensor:
        """K(x_i, x_i) for all rows, without forming the Gram matrix."""
        if self.kind == "linear":
            return torch.sum(X * X, dim=-1)
        if self.kind == "poly":
            return (self.gamma * torch.sum(X * X, dim=-1)
                    + self.coef0) ** self.degree
        return torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)

    @property
    def k_max(self) -> float:
        """Upper bound on K(x, x) used by the Theorem-2 margin (RBF: 1)."""
        return 1.0 if self.kind == "rbf" else float("inf")


def sqdist(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances via the Gram expansion."""
    xx = torch.sum(X * X, dim=-1)[..., :, None]
    yy = torch.sum(Y * Y, dim=-1)[..., None, :]
    sq = xx + yy - 2.0 * (X @ Y.mT)
    return torch.clamp(sq, min=0.0)


def resolve_use_kernels(flag: Optional[bool], device: torch.device) -> bool:
    """``None``: the CUDA kernels on a CUDA device, the plain versions on the
    CPU.  ``True`` on the CPU routes through the wrappers, which then run
    the plain versions (the counterpart of the reference's interpret mode)."""
    if flag is None:
        return torch.device(device).type == "cuda"
    return bool(flag)


def gram(kernel: Kernel, X: torch.Tensor, Y: torch.Tensor,
         use_kernels: bool = False, compute_dtype=None) -> torch.Tensor:
    """Kernel matrix K(X, Y), (n, m); batched (b, n, m) for 3-D inputs."""
    if use_kernels:
        from repro_torch.kernels import ops

        return ops.kernel_matrix(X.contiguous(), Y.contiguous(), kernel,
                                 compute_dtype=compute_dtype)
    return kernel.pairwise(X, Y, compute_dtype=compute_dtype)


def gram_blocks(kernel: Kernel, Xc: torch.Tensor, use_kernels: bool = False,
                compute_dtype=None) -> torch.Tensor:
    """Per-cluster Gram matrices: (k, nc, d) -> (k, nc, nc), one batched
    ``kermat`` launch with ``use_kernels``."""
    return gram(kernel, Xc, Xc, use_kernels=use_kernels,
                compute_dtype=compute_dtype)


def gram_matvec(kernel: Kernel, X: torch.Tensor, v: torch.Tensor,
                num_chunks: Optional[int] = None, use_kernels: bool = False,
                budget_bytes: Optional[int] = None, compute_dtype=None
                ) -> torch.Tensor:
    """K(X, X) @ v without materialising the Gram matrix: one streaming
    ``kernel_matvec`` launch, or row chunks of plain torch sized to the byte
    budget (any chunk count gives the same rows)."""
    if use_kernels:
        from repro_torch.kernels import ops

        return ops.kernel_matvec(X.contiguous(), X.contiguous(),
                                 v.contiguous(), kernel,
                                 compute_dtype=compute_dtype)
    n = X.shape[0]
    if num_chunks is None:
        num_chunks = auto_num_chunks(n, n, budget_bytes=budget_bytes)
    rows = -(-n // num_chunks)
    # the policy's f32 rows meet float64 weights in float64, as the
    # reference's type promotion has it
    return torch.cat([kernel.pairwise(X[i:i + rows], X,
                                      compute_dtype=compute_dtype).to(v.dtype)
                      @ v for i in range(0, n, rows)])


def offdiag_mass(kernel: Kernel, X: torch.Tensor, labels, num_chunks: int = 8
                 ) -> torch.Tensor:
    """D(pi) = sum_{i,j: pi(i) != pi(j)} |K(x_i, x_j)| (the Theorem-1
    quantity), over row chunks so the full Gram is never formed."""
    labels = torch.as_tensor(labels, device=X.device)
    n = X.shape[0]
    rows = -(-n // max(num_chunks, 1))
    total = torch.zeros((), dtype=X.dtype, device=X.device)
    for i in range(0, n, rows):
        K = torch.abs(kernel.pairwise(X[i:i + rows], X))
        total = total + torch.sum(K * (labels[i:i + rows, None]
                                       != labels[None, :]))
    return total
