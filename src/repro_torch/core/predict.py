"""Prediction for DC-SVM models (port of ``repro.core.predict``, binary).

* ``decision_exact``  -- f(x) = sum_i beta_i K(x, x_i) over all support
  vectors: one streaming ``kernel_matvec`` launch with ``use_kernels``,
  SV chunks of plain torch otherwise.
* ``decision_early``  -- paper eq. 11: route x to its nearest kernel-kmeans
  cluster and score it with that cluster's local model only.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.dcsvm import DCSVMModel
from repro_torch.core.kernels import Kernel, resolve_use_kernels
from repro_torch.core.kkmeans import assign_points


def bucketed_cluster_scores(kern: Kernel, Xq: torch.Tensor, cid: torch.Tensor,
                            Xblocks: torch.Tensor, Wblocks: torch.Tensor,
                            cap: int, use_kernels: bool = False
                            ) -> torch.Tensor:
    """Score every query against ONLY its assigned cluster's block.

    ``Xblocks``: (k, nc, d) per-cluster members, ``Wblocks``: (k, nc, 1)
    per-member weights (zero on pad slots).  Returns (nq, 1).  Queries are
    bucketed into a (k, cap, d) buffer and all clusters are scored in one
    batched kernel matvec; a cluster holding more than ``cap`` queries takes
    further rounds of the same program.  The buckets, scores and results
    stay on the device; the host reads one scalar, the largest in-cluster
    rank, to know the number of rounds."""
    nq, d = Xq.shape
    k = Xblocks.shape[0]
    n_out = Wblocks.shape[-1]
    if n_out != 1:
        raise NotImplementedError("one output column only (binary models)")
    if nq == 0:
        return torch.zeros((0, 1), dtype=Xq.dtype, device=Xq.device)
    dev = Xq.device
    order = torch.argsort(cid, stable=True)
    sc = cid[order]
    seg_start = torch.searchsorted(sc, torch.arange(k, device=dev,
                                                    dtype=sc.dtype))
    pos = torch.arange(nq, device=dev) - seg_start[sc]    # rank in its cluster
    rounds = int(pos.max()) // cap + 1
    Xs = Xq[order]
    out = torch.zeros((nq, 1), dtype=torch.promote_types(Xq.dtype,
                                                         torch.float32),
                      device=dev)
    for r in range(rounds):
        in_r = (pos >= r * cap) & (pos < (r + 1) * cap)
        row, col = sc[in_r], pos[in_r] - r * cap
        qbuf = torch.zeros((k, cap, d), dtype=Xq.dtype, device=dev)
        qbuf[row, col] = Xs[in_r]
        if use_kernels:
            from repro_torch.kernels import ops

            scores = ops.kernel_matvec(qbuf, Xblocks.contiguous(),
                                       Wblocks[..., 0].contiguous(), kern)
        else:
            scores = (kern.pairwise(qbuf, Xblocks) @ Wblocks)[..., 0]
        out[order[in_r], 0] = scores[row, col].to(out.dtype)
    return out.to(Xq.dtype)


def _decision_scan(kern: Kernel, Xq: torch.Tensor, Xs: torch.Tensor,
                   w: torch.Tensor, chunk: int) -> torch.Tensor:
    """K(Xq, Xs) @ w over SV chunks, never more than an (nq, chunk) kernel
    block live."""
    out = torch.zeros(Xq.shape[0], dtype=Xq.dtype, device=Xq.device)
    for i in range(0, Xs.shape[0], chunk):
        out = out + kern.pairwise(Xq, Xs[i:i + chunk]) @ w[i:i + chunk]
    return out


def decision_exact(model: DCSVMModel, Xq, chunk: int = 4096,
                   use_kernels: Optional[bool] = None) -> torch.Tensor:
    """f(x) = sum_i beta_i K(x_i, x) over all support vectors."""
    Xq = torch.as_tensor(Xq, device=model.X.device).to(model.X.dtype)
    sv = torch.as_tensor(model.sv_index, device=model.X.device)
    if len(sv) == 0:
        return torch.zeros(Xq.shape[0], dtype=Xq.dtype, device=Xq.device)
    if use_kernels is None:
        use_kernels = model.config.use_kernels
    Xs = model.X[sv]
    w = model.weights[sv]
    kern = model.config.kernel
    if resolve_use_kernels(use_kernels, Xq.device):
        from repro_torch.kernels import ops

        return ops.kernel_matvec(Xq.contiguous(), Xs.contiguous(),
                                 w.contiguous(), kern).to(Xq.dtype)
    return _decision_scan(kern, Xq, Xs, w, chunk)


def predict_exact(model: DCSVMModel, Xq) -> torch.Tensor:
    return torch.sign(decision_exact(model, Xq))


def _early_blocks(model: DCSVMModel, w: torch.Tensor):
    """Per-cluster member blocks (k, nc, d) and weights (k, nc, 1)."""
    part = model.partition
    dev = model.X.device
    members = torch.as_tensor(np.maximum(part.idx, 0), device=dev)
    mmask = torch.as_tensor(part.mask, device=dev)
    wm = torch.where(mmask, w[members], 0.0)[..., None]
    return model.X[members], wm


def early_capacity(nq: int, k: int) -> int:
    """Query-buffer slots per cluster: 2x the balanced load.  Overflow past
    this capacity takes extra rounds, never drops a query."""
    return int(min(nq, max(8, -(-2 * nq // k))))


def bucket_size(nq: int, lo: int = 8, hi: int = 4096) -> int:
    """Pad bucket for a ragged request batch: the smallest power of two
    >= ``nq``, clamped below by ``lo``; past ``hi``, a multiple of ``hi``."""
    if nq <= 0:
        return lo
    if nq > hi:
        return -(-nq // hi) * hi
    return max(lo, 1 << (nq - 1).bit_length())


def decision_early(model: DCSVMModel, Xq,
                   use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Paper eq. 11: nearest-cluster routing + local-model scoring, all
    clusters in one batched launch per round."""
    part = model.partition
    if part is None:
        raise ValueError("early prediction requires a partitioned model")
    Xq = torch.as_tensor(Xq, device=model.X.device).to(model.X.dtype)
    if use_kernels is None:
        use_kernels = model.config.use_kernels
    use_kernels = resolve_use_kernels(use_kernels, Xq.device)
    kern = model.config.kernel
    Xm, wm = _early_blocks(model, model.weights)
    cap = early_capacity(Xq.shape[0], part.k)
    cid, _ = assign_points(kern, part.model, Xq, use_kernels=use_kernels)
    return bucketed_cluster_scores(kern, Xq, cid, Xm, wm, cap,
                                   use_kernels=use_kernels)[:, 0]


def predict_early(model: DCSVMModel, Xq) -> torch.Tensor:
    return torch.sign(decision_early(model, Xq))


def accuracy(y_true, y_pred) -> float:
    y_true = torch.as_tensor(y_true)
    y_pred = torch.as_tensor(y_pred).to(y_true.device)
    return float((torch.sign(y_true) == torch.sign(y_pred)).float().mean())
