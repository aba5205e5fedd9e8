"""Task abstraction: one generalized dual per kernel machine (port of
``repro.core.tasks``, box family, C-SVC).

Every task reduces to the box-constrained QP

    min_u  1/2 u' Q u + p' u     s.t.  0 <= u <= c,      Q = (s s') ∘ K

over the task's dual points.  C-SVC: dual points X, ``s = y``, ``p = -1``,
``c = C``.  The decision function is ``f(x) = sum_i beta_i K(x_i, x)`` with
``beta = scatter-add of s ∘ u over base_index`` (``y ∘ alpha`` for C-SVC).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


class TaskDual(NamedTuple):
    """One task instance reduced to the generalized dual, class-stacked.

    ``Xd``: (n_dual, d) dual points; ``S``/``P``/``Cvec``: (n_rows, n_dual)
    sign vector, linear term and per-coordinate upper bound (binary uses one
    row).  ``base_index``: (n_dual,) original sample per dual coordinate."""

    Xd: torch.Tensor
    S: torch.Tensor
    P: torch.Tensor
    Cvec: torch.Tensor
    base_index: np.ndarray

    @property
    def n_dual(self) -> int:
        return self.Xd.shape[0]

    @property
    def n_rows(self) -> int:
        return self.S.shape[0]

    @property
    def n_base(self) -> int:
        return int(self.base_index.max()) + 1 if self.base_index.size else 0

    def collapse(self, alpha: torch.Tensor) -> torch.Tensor:
        """(n_rows, n_dual) dual solution -> (n_rows, n_base) decision
        coefficients ``beta = scatter-add of s ∘ u over base_index``."""
        out = torch.zeros(alpha.shape[:-1] + (self.n_base,),
                          dtype=alpha.dtype, device=alpha.device)
        idx = torch.as_tensor(self.base_index, device=alpha.device)
        return out.index_add_(-1, idx, self.S * alpha)


@dataclasses.dataclass(frozen=True)
class Task:
    """Base task: hyper-parameters + the reduction to the generalized dual."""

    name = "base"

    def build(self, X: torch.Tensor, Y: torch.Tensor, C: float) -> TaskDual:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class CSVC(Task):
    """Standard C-SVC hinge dual: ``p = -1, s = y, c = C``."""

    name = "svc"

    def build(self, X: torch.Tensor, Y: torch.Tensor, C: float) -> TaskDual:
        return TaskDual(Xd=X, S=Y, P=torch.full_like(Y, -1.0),
                        Cvec=torch.full_like(Y, C),
                        base_index=np.arange(Y.shape[-1]))


def resolve_task(task: Optional[Task]) -> Task:
    """``None`` -> the default C-SVC hinge task."""
    return CSVC() if task is None else task
