"""Kernel-operator layer (port of ``repro.core.gramop``, without the dedup
view, the precision policy and the host-RAM spill tier).

A ``GramOperator`` holds the dual points ``Xd`` (n, d) and the sign vector
``s`` (n,) of ``Q = (s s') ∘ K(Xd, Xd)`` and gives the conquer solver every
kernel access it needs: row and column blocks, the working-set block, the
matvec and the rank-B gradient update.  Budgets are in BYTES.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.kernels import (DEFAULT_GRAM_BUDGET, Kernel,
                                      gram_matvec)


def fits_budget(n_elems: int, budget_bytes: int, itemsize: int = 4) -> bool:
    """Does an ``n_elems``-element buffer fit ``budget_bytes``?  The one
    predicate behind every Gram-residency decision."""
    return int(n_elems) * int(itemsize) <= int(budget_bytes)


@dataclasses.dataclass(frozen=True)
class GramOperator:
    """Kernel + dual data + backend choice for ``Q = (s s') ∘ K``."""

    Xd: torch.Tensor
    s: torch.Tensor
    kernel: Kernel = Kernel("rbf", gamma=1.0)
    use_kernels: bool = False
    budget_bytes: int = DEFAULT_GRAM_BUDGET

    @property
    def n_dual(self) -> int:
        return self.Xd.shape[0]

    def kmat(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        """K(A, B): the ``kermat`` kernel or the plain pairwise."""
        if self.use_kernels:
            from repro_torch.kernels import ops

            return ops.kernel_matrix(A.contiguous(), B.contiguous(),
                                     self.kernel)
        return self.kernel.pairwise(A, B)

    def kernel_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Raw (B, n) kernel rows ``K(Xd[idx], Xd)``."""
        return self.kmat(self.Xd[idx], self.Xd)

    def q_block(self, idx: torch.Tensor) -> torch.Tensor:
        """Signed (n, B) columns of Q (the plain path's orientation)."""
        Kb = self.kmat(self.Xd, self.Xd[idx])
        return (self.s[:, None] * self.s[idx][None, :]) * Kb

    def qbb(self, idx: torch.Tensor) -> torch.Tensor:
        """The (B, B) working-set block of Q (plain torch, as in the
        reference)."""
        Xsel, ssel = self.Xd[idx], self.s[idx]
        return (ssel[:, None] * ssel[None, :]) * self.kernel.pairwise(Xsel, Xsel)

    def matvec(self, v: torch.Tensor, num_chunks: Optional[int] = None
               ) -> torch.Tensor:
        """Q @ v without materialising Q."""
        return self.s * gram_matvec(self.kernel, self.Xd, self.s * v,
                                    num_chunks=num_chunks,
                                    use_kernels=self.use_kernels,
                                    budget_bytes=self.budget_bytes)

    def col_update(self, g: torch.Tensor, idx: torch.Tensor,
                   delta: torch.Tensor) -> torch.Tensor:
        """g + Q[:, idx] @ delta, the rank-B gradient update: the fused
        ``cd_column_update`` kernel, or the plain column block."""
        if self.use_kernels:
            from repro_torch.kernels import ops

            Xsel, ssel = self.Xd[idx], self.s[idx]
            return g + ops.cd_column_update(
                self.Xd.contiguous(), self.s.contiguous(), Xsel.contiguous(),
                (ssel * delta).contiguous(), self.kernel).to(g.dtype)
        return g + self.q_block(idx).to(g.dtype) @ delta
