"""Theorem 1-3 quantities of the paper and the one-class early-prediction
gap bound (port of ``repro.core.bounds``).

* ``d_pi``            -- D(pi), the cross-cluster kernel mass (Theorem 1)
* ``d_pi_subset``     -- the same within an index set S (Theorem 3)
* ``theorem1_bound``  -- (1/2) C^2 D(pi), the bound on f(a-bar) - f(a*)
* ``theorem2_margin`` -- the gradient threshold above which a subproblem
                         non-SV is provably a non-SV of the full problem
* ``oneclass_early_gap_bound`` -- |f_early - f| of eq.-11 one-class
                         serving, from D(pi), sigma_n, the cross-cluster
                         kernel mass at the query and the rho_c spread

Kernel evaluations go through ``core.kernels`` in the data's dtype; the
sums of the gap bound run in float64, as the reference's numpy does.
"""
from __future__ import annotations


import numpy as np
import torch

from repro_torch.core.kernels import Kernel, gram, offdiag_mass


def d_pi(kernel: Kernel, X: torch.Tensor, assign, num_chunks: int = 8
         ) -> torch.Tensor:
    """D(pi) = sum over cross-cluster pairs of |K(x_i, x_j)|."""
    return offdiag_mass(kernel, X, assign, num_chunks=num_chunks)


def d_pi_subset(kernel: Kernel, X: torch.Tensor, assign, subset
                ) -> torch.Tensor:
    """Theorem-3 restriction: D over the pairs within ``subset`` only."""
    subset = torch.as_tensor(subset, device=X.device)
    ls = torch.as_tensor(assign, device=X.device)[subset]
    Xs = X[subset]
    Ks = torch.abs(gram(kernel, Xs, Xs))
    return torch.sum(Ks * (ls[:, None] != ls[None, :]))


def theorem1_bound(kernel: Kernel, X: torch.Tensor, assign, C: float
                   ) -> float:
    return float(0.5 * C * C * d_pi(kernel, X, assign))


def theorem3_bound(kernel: Kernel, X: torch.Tensor, assign, C: float,
                   subset) -> float:
    return float(0.5 * C * C * d_pi_subset(kernel, X, assign, subset))


def _np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


def oneclass_early_gap_bound(kernel: Kernel, X: torch.Tensor, assign,
                             alpha_early, rho: float, rho_clusters,
                             Xq: torch.Tensor, cid_q, sigma_n: float,
                             alpha_exact=None, num_chunks: int = 8) -> dict:
    """Bound on the one-class early-prediction error |f_early(x) - f(x)|.

    With ``abar`` the concatenated per-cluster solution, ``a*`` the full
    optimum and ``c`` the routed cluster, per query

        |f_early - f| <= ||abar - a*||_2 ||K(., x)||_2       (term_drift)
                         + sum_{i not in c} abar_i |K(x_i, x)| (term_cross)
                         + max_c |rho_c - rho|                (term_rho);

    Theorem 1 (C = 1) bounds the drift a priori by
    ``k_max sqrt(n) sqrt(D(pi) / sigma_n)``.  With ``alpha_exact`` the dict
    also carries ``bound_measured``, the bound with the measured drift.
    ``num_chunks`` row chunks of D(pi) (more at a large n)."""
    Kq = np.abs(_np64(gram(kernel, Xq, X)))                    # (nq, n)
    abar = _np64(alpha_early)
    out_of_cluster = _np64(assign)[None, :] != _np64(cid_q)[:, None]
    term_cross = float(np.max(np.sum(Kq * abar[None, :] * out_of_cluster,
                                     axis=1)))
    D = float(d_pi(kernel, X, assign, num_chunks=num_chunks))
    n = X.shape[0]
    sigma_n = max(float(sigma_n), 1e-12)
    knorm = kernel.k_max * np.sqrt(n)
    term_drift = float(knorm * np.sqrt(max(D, 0.0) / sigma_n))
    term_rho = float(np.max(np.abs(_np64(rho_clusters) - float(rho))))
    out = {"term_cross": term_cross, "term_drift": term_drift,
           "term_rho": term_rho, "d_pi": D, "sigma_n": sigma_n,
           "bound": term_cross + term_drift + term_rho}
    if alpha_exact is not None:
        drift = float(np.linalg.norm(abar - _np64(alpha_exact)))
        out["alpha_drift_l2"] = drift
        out["term_drift_measured"] = float(knorm * drift)
        out["bound_measured"] = out["term_drift_measured"] + term_cross \
            + term_rho
    return out


def theorem2_margin(kernel: Kernel, X: torch.Tensor, assign, C: float,
                    sigma_n: float) -> float:
    """C D(pi) (1 + sqrt(n) K_max / sqrt(sigma_n D(pi))); ``sigma_n`` is the
    smallest eigenvalue of the kernel matrix (the caller supplies it)."""
    n = X.shape[0]
    D = float(d_pi(kernel, X, assign))
    if D <= 0.0:
        return 0.0
    return C * D * (1.0 + np.sqrt(n) * kernel.k_max / np.sqrt(sigma_n * D))
