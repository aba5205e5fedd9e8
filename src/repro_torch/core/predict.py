"""Prediction for DC-SVM models of every task (port of
``repro.core.predict``).

Every strategy scores with the collapsed coefficients ``beta`` over the base
points (``model.weights``), less the offset ``rho`` of the equality tasks;
``predict_*`` returns signs for classifiers, ``d >= 0 -> +1`` for the tasks
with an offset, and the raw decision for regression.

* ``decision_exact``  -- f(x) = sum_i beta_i K(x, x_i) over all support
  vectors: one streaming ``kernel_matvec`` launch with ``use_kernels``,
  SV chunks of plain torch otherwise.
* ``decision_early``  -- paper eq. 11: route x to its nearest kernel-kmeans
  cluster and score it with that cluster's local model only.
* ``decision_bcm``    -- Bayesian Committee Machine combination of the k
  local models (the paper's Table-1 baseline).

The ``*_ova`` variants score one-vs-all models (``core.multiclass``): one
decision column per class and an argmax over them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.dcsvm import DCSVMModel
from repro_torch.core.kernels import Kernel, gram, resolve_use_kernels
from repro_torch.core.kkmeans import KKMeansModel, assign_points


def bucketed_cluster_scores(kern: Kernel, Xq: torch.Tensor, cid: torch.Tensor,
                            Xblocks: torch.Tensor, Wblocks: torch.Tensor,
                            cap: int, use_kernels: bool = False,
                            offsets: Optional[torch.Tensor] = None,
                            compute_dtype=None) -> torch.Tensor:
    """Score every query against ONLY its assigned cluster's block.

    ``Xblocks``: (k, nc, d) per-cluster members, ``Wblocks``: (k, nc, C)
    per-member weights (zero on pad slots).  Returns (nq, C).  ``offsets``
    (k, C), when given, is subtracted from each query's score by its
    cluster.  Queries are bucketed into a (k, cap, d) buffer and all
    clusters are scored in one batched launch: ``kernel_matvec`` for one
    column, ``kermat`` then a batched product for more.  A cluster holding
    more than ``cap`` queries takes further rounds of the same program.
    The buckets, scores and results stay on the device; the host reads one
    scalar, the largest in-cluster rank, to know the number of rounds.
    ``compute_dtype`` is the model's precision policy."""
    nq, d = Xq.shape
    k = Xblocks.shape[0]
    n_out = Wblocks.shape[-1]
    acc = torch.promote_types(Xq.dtype, torch.float32)
    if nq == 0:
        return torch.zeros((0, n_out), dtype=Xq.dtype, device=Xq.device)
    dev = Xq.device
    order = torch.argsort(cid, stable=True)
    sc = cid[order]
    seg_start = torch.searchsorted(sc, torch.arange(k, device=dev,
                                                    dtype=sc.dtype))
    pos = torch.arange(nq, device=dev) - seg_start[sc]    # rank in its cluster
    rounds = int(pos.max()) // cap + 1
    Xs = Xq[order]
    out = torch.zeros((nq, n_out), dtype=acc, device=dev)
    if use_kernels:
        from repro_torch.kernels import ops

        Xblocks = Xblocks.contiguous()
        if n_out == 1:
            w1 = Wblocks[..., 0].contiguous()
    for r in range(rounds):
        in_r = (pos >= r * cap) & (pos < (r + 1) * cap)
        row, col = sc[in_r], pos[in_r] - r * cap
        qbuf = torch.zeros((k, cap, d), dtype=Xq.dtype, device=dev)
        qbuf[row, col] = Xs[in_r]
        if use_kernels and n_out == 1:
            scores = ops.kernel_matvec(qbuf, Xblocks, w1, kern,
                                       compute_dtype=compute_dtype)[..., None]
        elif use_kernels:
            scores = ops.kernel_matrix(qbuf, Xblocks, kern,
                                       compute_dtype=compute_dtype) @ Wblocks
        else:
            scores = kern.pairwise(qbuf, Xblocks,
                                   compute_dtype=compute_dtype
                                   ).to(Wblocks.dtype) @ Wblocks
        out[order[in_r]] = scores[row, col].to(acc)
    if offsets is not None:
        out = out - offsets[cid]
    return out.to(Xq.dtype)


def _early_program(kern: Kernel, Xq: torch.Tensor, route_model: KKMeansModel,
                   Xblocks: torch.Tensor, Wblocks: torch.Tensor, cap: int,
                   use_kernels: bool = False,
                   offsets: Optional[torch.Tensor] = None,
                   compute_dtype=None) -> torch.Tensor:
    """Route + bucketed local scoring (paper eq. 11); the routing stays f32
    under the policy, as in the reference."""
    cid, _ = assign_points(kern, route_model, Xq, use_kernels=use_kernels)
    return bucketed_cluster_scores(kern, Xq, cid, Xblocks, Wblocks, cap,
                                   use_kernels=use_kernels, offsets=offsets,
                                   compute_dtype=compute_dtype)


def _decision_scan(kern: Kernel, Xq: torch.Tensor, Xs: torch.Tensor,
                   W: torch.Tensor, chunk: int, use_kernels: bool = False,
                   compute_dtype=None) -> torch.Tensor:
    """K(Xq, Xs) @ W over SV chunks, never more than an (nq, chunk) kernel
    block live.  W is (ns, C): one weight column per output."""
    out = torch.zeros((Xq.shape[0], W.shape[1]), dtype=Xq.dtype,
                      device=Xq.device)
    for i in range(0, Xs.shape[0], chunk):
        out = out + gram(kern, Xq, Xs[i:i + chunk], use_kernels=use_kernels,
                         compute_dtype=compute_dtype).to(W.dtype) \
            @ W[i:i + chunk]
    return out


def _policy(model):
    """The model's precision policy (``config.compute_dtype``)."""
    return getattr(model.config, "compute_dtype", None)


def _query(model, Xq) -> torch.Tensor:
    return torch.as_tensor(Xq, device=model.X.device).to(model.X.dtype)


def _use_kernels(model, use_kernels: Optional[bool]) -> bool:
    if use_kernels is None:
        use_kernels = model.config.use_kernels
    return resolve_use_kernels(use_kernels, model.X.device)


def _is_regression(model) -> bool:
    task = getattr(model, "task", None)
    return bool(task is not None and task.is_regression)


def _offset(model) -> float:
    """Decision offset rho of the equality tasks; 0 for the box family."""
    rho = getattr(model, "rho", None)
    return 0.0 if rho is None else float(rho)


def _labels(model, d: torch.Tensor) -> torch.Tensor:
    """Decisions -> predictions: raw values for regression, +/-1 for
    classification; a task with an offset thresholds ``d >= 0 -> +1``
    (inlier), as ``serve_batch`` does, where ``sign`` would give 0 on the
    boundary."""
    if _is_regression(model):
        return d
    if getattr(getattr(model, "task", None), "has_rho_offset", False):
        return torch.where(d >= 0, 1.0, -1.0).to(d.dtype)
    return torch.sign(d)


def decision_exact(model: DCSVMModel, Xq, chunk: int = 4096,
                   use_kernels: Optional[bool] = None) -> torch.Tensor:
    """f(x) = sum_i beta_i K(x_i, x) - rho over all support vectors."""
    Xq = _query(model, Xq)
    off = _offset(model)
    sv = torch.as_tensor(model.sv_index, device=model.X.device)
    if len(sv) == 0:
        return torch.zeros(Xq.shape[0], dtype=Xq.dtype, device=Xq.device) - off
    Xs = model.X[sv]
    w = model.weights[sv]
    kern = model.config.kernel
    if _use_kernels(model, use_kernels):
        from repro_torch.kernels import ops

        return ops.kernel_matvec(Xq.contiguous(), Xs.contiguous(),
                                 w.contiguous(), kern,
                                 compute_dtype=_policy(model)
                                 ).to(Xq.dtype) - off
    return _decision_scan(kern, Xq, Xs, w[:, None], chunk,
                          compute_dtype=_policy(model))[:, 0] - off


def predict_exact(model: DCSVMModel, Xq) -> torch.Tensor:
    """Labels for classifiers, raw values for regression."""
    return _labels(model, decision_exact(model, Xq))


def _early_blocks(model, w: torch.Tensor):
    """Per-cluster member blocks (k, nc, d) and weights (k, nc, C) of a
    partitioned model; ``w`` is (n,) or (n, C)."""
    part = model.partition
    dev = model.X.device
    members = torch.as_tensor(np.maximum(part.idx, 0), device=dev)
    mmask = torch.as_tensor(part.mask, device=dev)
    if w.dim() == 1:
        w = w[:, None]
    wm = torch.where(mmask[..., None], w[members], 0.0)
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
    clusters in one batched launch per round.  An early equality model
    subtracts its routed cluster's own offset ``rho_c``."""
    part = model.partition
    if part is None:
        raise ValueError("early prediction requires a partitioned model")
    Xq = _query(model, Xq)
    Xm, wm = _early_blocks(model, model.weights)
    cap = early_capacity(Xq.shape[0], part.k)
    rho_c = getattr(model, "rho_clusters", None)
    offsets = None if rho_c is None else torch.as_tensor(
        rho_c, dtype=Xq.dtype, device=Xq.device)[:, None]
    off = 0.0 if offsets is not None else _offset(model)
    return _early_program(model.config.kernel, Xq, part.model, Xm, wm, cap,
                          use_kernels=_use_kernels(model, use_kernels),
                          offsets=offsets,
                          compute_dtype=_policy(model))[:, 0] - off


def predict_early(model: DCSVMModel, Xq) -> torch.Tensor:
    return _labels(model, decision_early(model, Xq))


def decision_bcm(model: DCSVMModel, Xq, noise: float = 1e-2,
                 max_sv_per_cluster: int = 512) -> torch.Tensor:
    """Bayesian Committee Machine combination of the k local models (the
    paper's Table-1 baseline; f32 whatever the model's policy, as in the
    reference): each cluster's local decision f_c(x) - rho_c
    (the global rho for a fully trained equality model), weighted by the
    inverse GP predictive variance on (a subsample of) its support
    vectors."""
    W = model.weights[:, None]
    active = model.weights.cpu().numpy() != 0
    rho_c = getattr(model, "rho_clusters", None)
    offsets = (torch.as_tensor(rho_c).double().cpu().numpy()
               if rho_c is not None
               else np.full(model.partition.k, _offset(model)))
    return _bcm_scores(model, Xq, W, active, noise, max_sv_per_cluster,
                       offsets=offsets)[:, 0]


def _bcm_scores(model, Xq, W: torch.Tensor, active: np.ndarray, noise: float,
                max_sv_per_cluster: int,
                offsets: Optional[np.ndarray] = None) -> torch.Tensor:
    """Shared BCM combination: W is (n, C) decision weights, ``active``
    marks the support vectors eligible per cluster, ``offsets`` (k,) is
    subtracted from cluster c's local decision before the weighting.  The
    GP predictive variance is label-independent, so one variance per
    cluster weights all C outputs.  The solves run in float64, as the
    reference's do."""
    part = model.partition
    if part is None:
        raise ValueError("BCM prediction requires a partitioned model")
    kern = model.config.kernel
    use = _use_kernels(model, None)
    Xq = _query(model, Xq)
    nq = Xq.shape[0]
    f64 = dict(dtype=torch.float64, device=Xq.device)
    num = torch.zeros((nq, W.shape[1]), **f64)
    den = torch.zeros((nq, 1), **f64) + 1e-12
    diag = kern.diag(Xq).double()
    for c in range(part.k):
        members = part.idx[c][part.mask[c]]
        sv = members[active[members]]
        if len(sv) == 0:
            continue
        if len(sv) > max_sv_per_cluster:
            sv = sv[:: len(sv) // max_sv_per_cluster + 1]
        svt = torch.as_tensor(sv, device=Xq.device)
        Xs = model.X[svt]
        Kss = (gram(kern, Xs, Xs, use_kernels=use).double()
               + noise * torch.eye(len(sv), **f64))
        Kqs = gram(kern, Xq, Xs, use_kernels=use).double()
        f_c = Kqs @ W[svt].double()                            # (nq, C)
        if offsets is not None:
            f_c = f_c - float(offsets[c])
        sol = torch.linalg.solve(Kss, Kqs.T)                   # (s, nq)
        var = diag - torch.einsum("qs,sq->q", Kqs, sol)
        var = torch.clamp(var, min=noise)[:, None]
        num += f_c / var
        den += 1.0 / var
    return (num / den).to(torch.float32)


def predict_bcm(model: DCSVMModel, Xq) -> torch.Tensor:
    return _labels(model, decision_bcm(model, Xq))


def _pair(y_true, y_pred):
    y_true = torch.as_tensor(y_true)
    return y_true, torch.as_tensor(y_pred).to(y_true.device)


def accuracy(y_true, y_pred) -> float:
    y_true, y_pred = _pair(y_true, y_pred)
    return float((torch.sign(y_true) == torch.sign(y_pred)).float().mean())


def mse(y_true, y_pred) -> float:
    """Mean squared error (regression)."""
    y_true, y_pred = _pair(y_true, y_pred)
    return float(torch.mean((y_true.double() - y_pred.double()) ** 2))


def mae(y_true, y_pred) -> float:
    """Mean absolute error (regression)."""
    y_true, y_pred = _pair(y_true, y_pred)
    return float(torch.mean(torch.abs(y_true.double() - y_pred.double())))


def _np(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def recall(y_true, y_pred, label: float = 1.0) -> float:
    """Recall of one class (the minority class of weighted C-SVC)."""
    t = _np(y_true) == label
    if not t.any():
        return float("nan")
    return float(np.mean(_np(y_pred)[t] == label))


def precision(y_true, y_pred, label: float = 1.0) -> float:
    """Precision of one class (label -1: the outliers of a one-class
    model)."""
    p = _np(y_pred) == label
    if not p.any():
        return float("nan")
    return float(np.mean(_np(y_true)[p] == label))


def f1(y_true, y_pred, label: float = 1.0) -> float:
    """F1 of one class (label -1: one-class SVM's anomaly metric)."""
    t = _np(y_true) == label
    p = _np(y_pred) == label
    tp = float(np.sum(t & p))
    denom = 2.0 * tp + float(np.sum(~t & p)) + float(np.sum(t & ~p))
    return 0.0 if denom == 0 else 2.0 * tp / denom


# ---------------------------------------------------------------------------
# One-vs-all (multiclass) variants: per-class decision values + argmax.
# ``model`` is a core.multiclass.MulticlassModel.
# ---------------------------------------------------------------------------

def _ova_weights(model) -> torch.Tensor:
    """(n, n_classes) decision weights: column c is alpha_c * y_c."""
    return (model.alpha * model.Y).T


def decision_exact_ova(model, Xq, chunk: int = 4096,
                       use_kernels: Optional[bool] = None) -> torch.Tensor:
    """(nq, n_classes) exact decision values over the SV union: one kernel
    evaluation per (query, SV) pair serves every class."""
    Xq = _query(model, Xq)
    sv = torch.as_tensor(model.sv_union, device=model.X.device)
    n_cls = model.Y.shape[0]
    if len(sv) == 0:
        return torch.zeros((Xq.shape[0], n_cls), dtype=Xq.dtype,
                           device=Xq.device)
    return _decision_scan(model.config.kernel, Xq, model.X[sv],
                          _ova_weights(model)[sv], chunk,
                          use_kernels=_use_kernels(model, use_kernels),
                          compute_dtype=_policy(model))


def decision_early_ova(model, Xq,
                       use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Eq.-11 early prediction for one-vs-all: each query is routed once
    and all classes score it against the same cluster block."""
    part = model.partition
    if part is None:
        raise ValueError("early prediction requires a partitioned model")
    Xq = _query(model, Xq)
    Xm, wm = _early_blocks(model, _ova_weights(model))
    cap = early_capacity(Xq.shape[0], part.k)
    return _early_program(model.config.kernel, Xq, part.model, Xm, wm, cap,
                          use_kernels=_use_kernels(model, use_kernels),
                          compute_dtype=_policy(model))


def decision_bcm_ova(model, Xq, noise: float = 1e-2,
                     max_sv_per_cluster: int = 512) -> torch.Tensor:
    """BCM combination for one-vs-all: one variance weighting serves all
    classes."""
    active = (model.alpha > 0).any(dim=0).cpu().numpy()
    return _bcm_scores(model, Xq, _ova_weights(model), active, noise,
                       max_sv_per_cluster)


def _argmax_classes(model, scores: torch.Tensor) -> torch.Tensor:
    classes = torch.as_tensor(model.classes, device=scores.device)
    return classes[torch.argmax(scores, dim=1)]


def predict_exact_ova(model, Xq) -> torch.Tensor:
    return _argmax_classes(model, decision_exact_ova(model, Xq))


def predict_early_ova(model, Xq) -> torch.Tensor:
    return _argmax_classes(model, decision_early_ova(model, Xq))


def predict_bcm_ova(model, Xq) -> torch.Tensor:
    return _argmax_classes(model, decision_bcm_ova(model, Xq))


def accuracy_multiclass(y_true, y_pred) -> float:
    y_true = torch.as_tensor(y_true)
    y_pred = torch.as_tensor(y_pred).to(y_true.device)
    return float((y_true == y_pred).double().mean())
