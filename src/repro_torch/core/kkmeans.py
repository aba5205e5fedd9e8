"""Two-step kernel k-means (port of ``repro.core.kkmeans``).

Step 1: kernel k-means on m sampled points, entirely in kernel space.
Step 2: assign every point to its nearest center through the (n, m)
cross-kernel.  A center c is the kernel-space mean of the sampled points
assigned to it, so

    d(x, c) = K(x,x) - 2 K(x, X_m) @ w_c + s_c,
    w_c = H[:, c] / |V_c|,   s_c = w_c' K_mm w_c.

The random draws (the m-point sample and the init permutation) come from a
``torch.Generator``, or are passed in: ``jax.random`` streams cannot be
reproduced in torch, so tests hand the reference's draws to both sides.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.kernels import Kernel, gram, resolve_use_kernels


class KKMeansModel(NamedTuple):
    """Implicit kernel-space centers: d(x,c) = K(x,x) - 2 K(x,Xm) W[:,c] + s[c]."""

    Xm: torch.Tensor     # (m, d) sampled points
    W: torch.Tensor      # (m, k) normalized one-hot weights H / counts
    s: torch.Tensor      # (k,)  per-center self-term  w_c' K_mm w_c

    @property
    def k(self) -> int:
        return self.W.shape[1]


def _center_terms(Kmm: torch.Tensor, assign: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    H = torch.nn.functional.one_hot(assign, k).to(Kmm.dtype)     # (m, k)
    counts = torch.clamp(H.sum(dim=0), min=1.0)
    W = H / counts[None, :]
    M = Kmm @ W
    s = torch.einsum("mk,mk->k", W, M)
    return W, s


def kernel_kmeans(Kmm: torch.Tensor, k: int, init_perm: torch.Tensor,
                  iters: int = 20
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel k-means on an (m, m) kernel matrix from the balanced
    round-robin init over ``init_perm``.  Returns (assign, W, s)."""
    m = Kmm.shape[0]
    dev = Kmm.device
    diag = torch.diagonal(Kmm)
    perm = torch.as_tensor(init_perm, device=dev).long()
    assign = torch.empty(m, dtype=torch.int64, device=dev)
    assign[perm] = torch.arange(m, device=dev) % k
    rank = torch.arange(k, device=dev)
    for _ in range(iters):
        W, s = _center_terms(Kmm, assign, k)
        D = diag[:, None] - 2.0 * (Kmm @ W) + s[None, :]
        new = torch.argmin(D, dim=1)
        # reseed ALL empty clusters at once: the e-th empty cluster takes the
        # e-th point farthest from its own center (empties past m stay empty)
        counts = torch.bincount(new, minlength=k)
        eids = torch.nonzero(counts <= 0)[:, 0]
        if eids.numel():
            dist_own = D[torch.arange(m, device=dev), new]
            order = torch.argsort(-dist_own, stable=True)
            take = min(eids.numel(), m)
            new[order[rank[:take]]] = eids[:take]
        assign = new
    W, s = _center_terms(Kmm, assign, k)
    return assign, W, s


def assign_points(kernel: Kernel, model: KKMeansModel, X: torch.Tensor,
                  use_kernels: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-center assignment.  Returns (assign, D).  Empty centers (zero
    W column) get distance +inf, so a phantom center never captures points.

    With ``use_kernels`` and an RBF kernel the scores come from the fused
    ``kmeans_assign`` kernel, which never holds the (n, m) cross-kernel in
    memory; an empty center's self-term is set to +inf before the launch,
    so the kernel's own argmin already skips it."""
    empty = torch.sum(model.W, dim=0) <= 0.0
    if use_kernels and kernel.kind == "rbf":
        from repro_torch.kernels import ops

        s = torch.where(empty, torch.inf, model.s)
        assign, scores = ops.kmeans_assign(
            X.contiguous(), model.Xm.contiguous(), model.W.contiguous(),
            s.contiguous(), kernel.gamma)
        return assign, scores + kernel.diag(X)[:, None]
    Knm = gram(kernel, X, model.Xm, use_kernels=use_kernels)    # (n, m)
    D = kernel.diag(X)[:, None] - 2.0 * (Knm @ model.W) + model.s[None, :]
    D = torch.where(empty[None, :], torch.inf, D)
    return torch.argmin(D, dim=1), D


def route(kernel: Kernel, model: KKMeansModel, X: torch.Tensor,
          use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Serving-time router: cluster id per query point (early prediction).
    ``use_kernels=None`` takes the kernels on a CUDA device."""
    return assign_points(kernel, model, X,
                         use_kernels=resolve_use_kernels(use_kernels,
                                                         X.device))[0]


def balanced_assign(D: np.ndarray, capacity: int) -> np.ndarray:
    """Greedy capacity-constrained assignment from an (n, k) distance matrix.

    Points are processed in order of confidence (gap between best and
    second-best center); each takes its nearest center that still has room.
    Every cluster gets at most ``capacity`` points."""
    D = np.asarray(D, dtype=np.float64)
    n, k = D.shape
    if n > k * capacity:
        raise ValueError(f"capacity {capacity} x {k} clusters < n={n}")
    order_pref = np.argsort(D, axis=1)
    if k > 1:
        part = np.partition(D, 1, axis=1)
        confidence = part[:, 1] - part[:, 0]
    else:
        confidence = np.zeros(n)
    point_order = np.argsort(-confidence)
    remaining = np.full(k, capacity, dtype=np.int64)
    out = np.full(n, -1, dtype=np.int32)
    for i in point_order:
        for c in order_pref[i]:
            if remaining[c] > 0:
                out[i] = c
                remaining[c] -= 1
                break
    if (out < 0).any():
        raise RuntimeError("balanced_assign left points unassigned")
    return out


@dataclasses.dataclass(frozen=True)
class Partition:
    """A (near-)balanced partition of n points into k clusters, padded.

    ``idx[c]`` holds the original indices of cluster c padded with -1 up to
    ``nc`` slots; ``mask[c]`` marks real entries."""

    assign: np.ndarray      # (n,) cluster id per original index
    idx: np.ndarray         # (k, nc) original indices, -1 for padding
    mask: np.ndarray        # (k, nc) True for real points
    k: int
    nc: int
    model: KKMeansModel

    @staticmethod
    def build(assign: np.ndarray, k: int, model: KKMeansModel) -> "Partition":
        assign = np.asarray(assign)
        counts = np.bincount(assign, minlength=k)
        nc = int(counts.max())
        order = np.argsort(assign, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(assign.shape[0]) - starts[assign[order]]
        idx = np.full((k, nc), -1, dtype=np.int64)
        idx[assign[order], slot] = order
        return Partition(assign=assign, idx=idx, mask=idx >= 0, k=k, nc=nc,
                         model=model)

    def gather(self, A: torch.Tensor) -> torch.Tensor:
        """(n, ...) -> (k, nc, ...); pad slots read row 0."""
        return A[torch.as_tensor(np.maximum(self.idx, 0), device=A.device)]

    def scatter(self, Ac: torch.Tensor, n: int, fill: float = 0.0
                ) -> torch.Tensor:
        """(k, nc, ...) -> (n, ...); pad slots are dropped."""
        flat = torch.as_tensor(np.where(self.mask, self.idx, n).reshape(-1),
                               device=Ac.device)
        vals = Ac.reshape((self.k * self.nc,) + tuple(Ac.shape[2:]))
        out = torch.full((n + 1,) + tuple(vals.shape[1:]), fill,
                         dtype=vals.dtype, device=vals.device)
        out[flat] = vals
        return out[:n]


def two_step_kernel_kmeans(kernel: Kernel, X: torch.Tensor, k: int,
                           generator: Optional[torch.Generator] = None,
                           m: int = 1000, iters: int = 20,
                           sample_idx=None, balanced: bool = True,
                           use_kernels: bool = False, init_perm=None
                           ) -> Partition:
    """The paper's clustering step.  ``sample_idx`` overrides the random
    sample (adaptive clustering passes the current support vectors) and
    ``init_perm`` the k-means init permutation; whatever is not given is
    drawn from ``generator`` (on the CPU)."""
    n = X.shape[0]
    if sample_idx is None:
        sample_idx = torch.randperm(n, generator=generator)[:min(m, n)]
    sample_idx = torch.as_tensor(np.array(sample_idx), device=X.device).long()
    m = sample_idx.shape[0]
    if init_perm is None:
        init_perm = torch.randperm(m, generator=generator)
    Xm = X[sample_idx]
    Kmm = gram(kernel, Xm, Xm, use_kernels=use_kernels)
    _, W, s = kernel_kmeans(Kmm, k, torch.as_tensor(np.array(init_perm)),
                            iters=iters)
    model = KKMeansModel(Xm=Xm, W=W, s=s)
    assign, D = assign_points(kernel, model, X, use_kernels=use_kernels)
    if balanced:
        assign = balanced_assign(D.cpu().numpy(), -(-n // k))
    else:
        assign = assign.cpu().numpy()
    return Partition.build(np.asarray(assign, np.int32), k, model)
