"""Kernel-operator layer (port of ``repro.core.gramop``, without the
precision policy and the host-RAM spill tier).

A ``GramOperator`` holds the dual points ``Xd`` (n, d) and the sign vector
``s`` (n,) of ``Q = (s s') ∘ K(Xd, Xd)`` and gives the conquer solvers every
kernel access they need: row and column blocks, the working-set block, the
diagonal, the matvec and the rank-B gradient update.  Budgets are in BYTES.

Base-indexed view (``Xb``/``bidx``, ``Xd == Xb[bidx]`` row for row): tasks
with duplicated dual rows (epsilon-SVR's mirrored (alpha, alpha*) pair)
compute kernel rows against the n_base base rows only and expand the signs
at read, ``Q[i, j] = s_i K[i, bidx_j] s_j`` (exact: s is +/-1).  The fused
rank-B update then runs ``cd_column_update`` over the base rows with an
all-ones sign vector and gathers through ``bidx``.
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
    """Kernel + dual data + base-index view + backend for ``Q = (s s') ∘ K``."""

    Xd: torch.Tensor
    s: torch.Tensor
    Xb: Optional[torch.Tensor] = None
    bidx: Optional[torch.Tensor] = None
    kernel: Kernel = Kernel("rbf", gamma=1.0)
    use_kernels: bool = False
    budget_bytes: int = DEFAULT_GRAM_BUDGET

    # -- structure --------------------------------------------------------
    @property
    def n_dual(self) -> int:
        return self.Xd.shape[0]

    @property
    def dedup(self) -> bool:
        return self.bidx is not None

    @property
    def kwidth(self) -> int:
        """Width of a raw kernel row (n_base under the view)."""
        return self.Xb.shape[0] if self.dedup else self.n_dual

    def cache_keys(self, idx: torch.Tensor) -> torch.Tensor:
        """Row key of each selected dual coordinate: its base id under the
        view (mirrored SVR coordinates share one row), else itself."""
        return self.bidx[idx] if self.dedup else idx

    # -- kernel access ----------------------------------------------------
    def kmat(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        """K(A, B): the ``kermat`` kernel or the plain pairwise."""
        if self.use_kernels:
            from repro_torch.kernels import ops

            return ops.kernel_matrix(A.contiguous(), B.contiguous(),
                                     self.kernel)
        return self.kernel.pairwise(A, B)

    def kernel_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Raw (B, kwidth) kernel rows ``K(Xd[idx], base points)``."""
        return self.kmat(self.Xd[idx], self.Xb if self.dedup else self.Xd)

    def expand_rows(self, kr: torch.Tensor, idx: torch.Tensor
                    ) -> torch.Tensor:
        """Raw rows (B, kwidth) -> signed Q rows (B, n_dual)."""
        cols = kr[:, self.bidx] if self.dedup else kr
        return self.s[idx][:, None] * (cols * self.s[None, :])

    def q_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Signed (B, n_dual) rows of Q for a selected block."""
        return self.expand_rows(self.kernel_rows(idx), idx)

    def q_block(self, idx: torch.Tensor) -> torch.Tensor:
        """Signed (n, B) columns of Q (the plain path's orientation)."""
        Xsel = self.Xd[idx]
        if self.dedup:
            Kb = self.kmat(self.Xb, Xsel)[self.bidx]
        else:
            Kb = self.kmat(self.Xd, Xsel)
        return (self.s[:, None] * self.s[idx][None, :]) * Kb

    def qbb(self, idx: torch.Tensor) -> torch.Tensor:
        """The (B, B) working-set block of Q (plain torch, as in the
        reference)."""
        Xsel, ssel = self.Xd[idx], self.s[idx]
        return (ssel[:, None] * ssel[None, :]) * self.kernel.pairwise(Xsel, Xsel)

    def qdiag(self) -> torch.Tensor:
        return self.s * self.s * self.kernel.diag(self.Xd)

    def matvec(self, v: torch.Tensor, num_chunks: Optional[int] = None,
               via_base: bool = False) -> torch.Tensor:
        """Q @ v without materialising Q.  ``via_base`` (under the view)
        first collapses the weights onto the base rows, an n_base-sized
        matvec that sums in another order; off by default."""
        if via_base and self.dedup:
            w = torch.zeros(self.Xb.shape[0], dtype=v.dtype,
                            device=v.device).index_add_(0, self.bidx,
                                                        self.s * v)
            kv = gram_matvec(self.kernel, self.Xb, w, num_chunks=num_chunks,
                             use_kernels=self.use_kernels,
                             budget_bytes=self.budget_bytes)
            return self.s * kv[self.bidx]
        return self.s * gram_matvec(self.kernel, self.Xd, self.s * v,
                                    num_chunks=num_chunks,
                                    use_kernels=self.use_kernels,
                                    budget_bytes=self.budget_bytes)

    def col_update(self, g: torch.Tensor, idx: torch.Tensor,
                   delta: torch.Tensor) -> torch.Tensor:
        """g + Q[:, idx] @ delta, the rank-B gradient update: the fused
        ``cd_column_update`` kernel (over the base rows with y = 1 under
        the view, then gathered), or the plain column block."""
        if self.use_kernels:
            from repro_torch.kernels import ops

            Xsel = self.Xd[idx].contiguous()
            w = (self.s[idx] * delta).contiguous()
            if self.dedup:
                Xb = self.Xb.contiguous()
                base = ops.cd_column_update(
                    Xb, torch.ones(Xb.shape[0], dtype=Xb.dtype,
                                   device=Xb.device), Xsel, w, self.kernel)
                return g + (self.s * base[self.bidx]).to(g.dtype)
            return g + ops.cd_column_update(
                self.Xd.contiguous(), self.s.contiguous(), Xsel, w,
                self.kernel).to(g.dtype)
        return g + self.q_block(idx).to(g.dtype) @ delta
