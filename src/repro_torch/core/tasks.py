"""Task abstraction: one generalized dual per kernel machine (port of
``repro.core.tasks``).

Every task reduces to the QP

    min_u  1/2 u' Q u + p' u     s.t.  0 <= u <= c     [, a'u = d per group]

with ``Q = (s s') ∘ K`` over the task's dual points:

    task          dual points     s                 p             c
    ------------  --------------  ----------------  ------------  -----------
    CSVC          X        (n)    y                 -1            C
    WeightedCSVC  X        (n)    y                 -1            C * w_{y_i}
    EpsilonSVR    [X; X]   (2n)   (+1 ... -1 ...)   eps -/+ y     C
    OneClassSVM   X        (n)    1                 0             1, e'u = nu n
    NuSVC         X        (n)    y                 0             1, e'u = nu n
                                                    (with bias: nu n / 2 per
                                                    class group)

The decision function of every task is ``f(x) = sum_i beta_i K(x_i, x)``
(minus ``rho`` for the tasks with an offset) with ``beta = scatter-add of
s ∘ u over base_index``; for epsilon-SVR that collapses the mirrored pair
to ``alpha_i - alpha*_i``.  The divide step clusters the n base points and
``base_index`` expands the partition to dual coordinates, so SVR's two
mirrored coordinates of a sample always share a cluster.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.solver import equality_interval_grouped, equality_rho


class TaskDual(NamedTuple):
    """One task instance reduced to the generalized dual, class-stacked.

    ``Xd``: (n_dual, d) dual points; ``S``/``P``/``Cvec``: (n_rows, n_dual)
    sign vector, linear term and per-coordinate upper bound (binary and
    regression use one row).  ``base_index``: (n_dual,) original sample per
    dual coordinate.  ``A``/``Deq`` select the dual family: ``None`` for the
    box family, else the (n_rows, n_dual) equality coefficients and
    (n_rows, n_groups) targets of ``sum_{i in g} a_i u_i = d_g``; ``Geq``
    (n_rows, n_dual) assigns each coordinate to its group (``None``: one
    global constraint)."""

    Xd: torch.Tensor
    S: torch.Tensor
    P: torch.Tensor
    Cvec: torch.Tensor
    base_index: np.ndarray
    A: Optional[torch.Tensor] = None
    Deq: Optional[torch.Tensor] = None
    Geq: Optional[torch.Tensor] = None

    @property
    def has_equality(self) -> bool:
        return self.A is not None

    @property
    def n_groups(self) -> int:
        """Equality-constraint groups; 0 for the box family."""
        return 0 if self.Deq is None else self.Deq.shape[-1]

    @property
    def group_ids(self) -> torch.Tensor:
        """(n_rows, n_dual) int64 constraint-group ids (zeros for one global
        constraint)."""
        if self.Geq is not None:
            return self.Geq
        return torch.zeros(self.S.shape, dtype=torch.int64,
                           device=self.S.device)

    @property
    def n_dual(self) -> int:
        return self.Xd.shape[0]

    @property
    def n_rows(self) -> int:
        return self.S.shape[0]

    @property
    def n_base(self) -> int:
        return int(self.base_index.max()) + 1 if self.base_index.size else 0

    def base_view(self):
        """Deduplicated view ``(Xb, bidx)`` with ``Xd == Xb[bidx]`` row for
        row: ``Xb`` holds the first dual point of each base id (X itself for
        SVR's [X; X]), ``bidx`` the base id of each dual coordinate."""
        bi = np.asarray(self.base_index)
        _, first = np.unique(bi, return_index=True)
        dev = self.Xd.device
        return (self.Xd[torch.as_tensor(first, device=dev)],
                torch.as_tensor(bi, dtype=torch.int64, device=dev))

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
    is_regression = False
    label_free = False       # True: ``fit`` ignores y (one-class SVM)
    has_rho_offset = False   # True: f(x) = sum beta_i K(x_i, x) - rho

    def build(self, X: torch.Tensor, Y: torch.Tensor, C: float) -> TaskDual:
        raise NotImplementedError

    def recover_offset(self, alpha: torch.Tensor, grad: torch.Tensor,
                       cvec: torch.Tensor, avec: torch.Tensor,
                       gid: torch.Tensor,
                       active_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Decision offset rho of an equality-constrained task, read off
        the KKT multiplier bracket at the returned dual: the bracket
        midpoint of the single constraint (one-class SVM).  Leading batch
        dimensions are kept."""
        return equality_rho(alpha, grad, cvec, avec, active_mask=active_mask)


@dataclasses.dataclass(frozen=True)
class CSVC(Task):
    """Standard C-SVC hinge dual: ``p = -1, s = y, c = C``."""

    name = "svc"

    def build(self, X: torch.Tensor, Y: torch.Tensor, C: float) -> TaskDual:
        return TaskDual(Xd=X, S=Y, P=torch.full_like(Y, -1.0),
                        Cvec=torch.full_like(Y, C),
                        base_index=np.arange(Y.shape[-1]))


@dataclasses.dataclass(frozen=True)
class WeightedCSVC(Task):
    """Cost-sensitive C-SVC: per-class box ``c_i = C * w_{y_i}``, times an
    optional per-sample weight (array-like of shape (n,))."""

    w_pos: float = 1.0
    w_neg: float = 1.0
    sample_weight: Optional[object] = None

    name = "weighted-svc"

    def build(self, X: torch.Tensor, Y: torch.Tensor, C: float) -> TaskDual:
        w = torch.where(Y > 0, torch.full_like(Y, self.w_pos),
                        torch.full_like(Y, self.w_neg))
        if self.sample_weight is not None:
            w = w * torch.as_tensor(np.asarray(self.sample_weight),
                                    dtype=Y.dtype, device=Y.device)[None, :]
        return TaskDual(Xd=X, S=Y, P=torch.full_like(Y, -1.0), Cvec=C * w,
                        base_index=np.arange(Y.shape[-1]))


@dataclasses.dataclass(frozen=True)
class EpsilonSVR(Task):
    """epsilon-insensitive regression, the 2n-variable dual over [X; X]:
    ``s = (+1..., -1...)``, ``p = (eps - y, eps + y)``, ``c = C``; the
    collapsed ``beta_i = alpha_i - alpha*_i``."""

    eps: float = 0.1

    name = "svr"
    is_regression = True

    def build(self, X: torch.Tensor, Y: torch.Tensor, C: float) -> TaskDual:
        y = Y[0] if Y.dim() == 2 else Y
        n = y.shape[0]
        ones = torch.ones(n, dtype=X.dtype, device=X.device)
        return TaskDual(
            Xd=torch.cat([X, X], dim=0),
            S=torch.cat([ones, -ones])[None, :],
            P=torch.cat([self.eps - y, self.eps + y])[None, :].to(X.dtype),
            Cvec=torch.full((1, 2 * n), C, dtype=X.dtype, device=X.device),
            base_index=np.concatenate([np.arange(n), np.arange(n)]))


@dataclasses.dataclass(frozen=True)
class OneClassSVM(Task):
    """Schölkopf one-class SVM, LIBSVM's parameterization (label-free):
    ``min 1/2 a'Ka, 0 <= a <= 1, sum a = nu n``; the constraint's
    multiplier is the offset rho, f(x) >= 0 on inliers."""

    nu: float = 0.5

    name = "ocsvm"
    label_free = True
    has_rho_offset = True

    def build(self, X: torch.Tensor, Y: torch.Tensor, C: float) -> TaskDual:
        if not 0.0 < self.nu <= 1.0:
            raise ValueError(f"one-class nu must lie in (0, 1], got {self.nu}")
        n = X.shape[0]
        ones = torch.ones((1, n), dtype=X.dtype, device=X.device)
        return TaskDual(Xd=X, S=ones,
                        P=torch.zeros((1, n), dtype=X.dtype, device=X.device),
                        Cvec=ones, base_index=np.arange(n), A=ones,
                        Deq=torch.full((1, 1), self.nu * n, dtype=X.dtype,
                                       device=X.device))


@dataclasses.dataclass(frozen=True)
class NuSVC(Task):
    """nu-parameterized classifier.  Without the bias: ``0 <= u <= 1,
    sum u = nu n`` with ``Q = (y y') ∘ K``.  With the bias (libsvm's
    nu-SVC) ``y'u = 0`` is restored; with +/-1 labels the two constraints
    become one mass constraint ``nu n / 2`` per class group (``Geq`` the
    class indicator), and ``rho = -b`` from the per-group multipliers
    (``recover_offset``).  Feasible iff ``nu <= 2 min(n+, n-) / n``."""

    nu: float = 0.5
    with_bias: bool = False

    name = "nu-svc"

    @property
    def has_rho_offset(self) -> bool:
        return self.with_bias

    def build(self, X: torch.Tensor, Y: torch.Tensor, C: float) -> TaskDual:
        if not 0.0 < self.nu <= 1.0:
            raise ValueError(f"nu-SVC nu must lie in (0, 1], got {self.nu}")
        n = Y.shape[-1]
        common = dict(Xd=X, S=Y, P=torch.zeros_like(Y),
                      Cvec=torch.ones_like(Y), base_index=np.arange(n),
                      A=torch.ones_like(Y))
        if not self.with_bias:
            return TaskDual(**common, Deq=torch.full(
                (Y.shape[0], 1), self.nu * n, dtype=X.dtype, device=X.device))
        n_pos = (Y > 0).sum(dim=-1).cpu().numpy()
        n_min = np.minimum(n_pos, n - n_pos)
        if np.any(self.nu * n > 2 * n_min + 1e-9):
            raise ValueError(
                f"nu-SVC with bias needs nu <= 2 min(n+, n-)/n = "
                f"{2 * n_min.min() / n:.4f} (each class must carry mass "
                f"nu*n/2 with u <= 1); got nu = {self.nu}")
        return TaskDual(**common, Deq=torch.full(
            (Y.shape[0], 2), 0.5 * self.nu * n, dtype=X.dtype,
            device=X.device), Geq=torch.where(Y > 0, 0, 1).long())

    def recover_offset(self, alpha, grad, cvec, avec, gid, active_mask=None):
        # rho = -b = (r_+ - r_-) / 2 from the per-group multipliers; a group
        # with no coordinates (a one-class cluster of an early model) takes
        # the present group's level, so that cluster scores with offset 0
        if not self.with_bias:
            return Task.recover_offset(self, alpha, grad, cvec, avec, gid,
                                       active_mask=active_mask)
        lo, hi = equality_interval_grouped(alpha, grad, cvec, avec, gid, 2,
                                           active_mask=active_mask)
        mid = 0.5 * (lo + hi)
        r = torch.where(torch.isfinite(mid), mid,
                        torch.where(torch.isfinite(lo), lo, hi))
        has = torch.isfinite(r)
        zero = torch.zeros_like(r[..., 0])
        r0 = torch.where(has[..., 0], r[..., 0],
                         torch.where(has[..., 1], r[..., 1], zero))
        r1 = torch.where(has[..., 1], r[..., 1],
                         torch.where(has[..., 0], r[..., 0], zero))
        return 0.5 * (r0 - r1)


TASKS = {cls.name: cls for cls in (CSVC, WeightedCSVC, EpsilonSVR,
                                   OneClassSVM, NuSVC)}


def resolve_task(task: Optional[Task]) -> Task:
    """``None`` -> the default C-SVC hinge task."""
    return CSVC() if task is None else task
