"""DC-SVM: multilevel divide-and-conquer kernel machines (paper Algorithm 1),
port of ``repro.core.dcsvm`` for the box family (binary C-SVC).

Level l (= levels .. 1): partition all n points into k^l balanced clusters
by two-step kernel k-means (sampling from the lower level's support vectors
when ``adaptive``), then solve the k^l independent sub-QPs warm-started from
the lower level's alpha, as batches on the device.  Level 0: optional
refine pass on the level-1 support vectors, then the full problem: a dense
Gram with shrinking CD up to ``full_gram_threshold`` points, the Gram-free
block CD above it.  ``early_stop_level = l`` stops after level l and
returns an early-prediction model (paper eq. 11).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import gramop
from repro_torch.core import solver as S
from repro_torch.core.kernels import (DEFAULT_GRAM_BUDGET, Kernel, gram,
                                      gram_matvec, resolve_use_kernels)
from repro_torch.core.kkmeans import Partition, two_step_kernel_kmeans
from repro_torch.core.tasks import CSVC, Task, TaskDual, resolve_task
from repro_torch.device import DeviceLike, as_tensor, resolve_device
from repro_torch.obs.spans import span

# ``draws(level, n, m_sample) -> (sample_idx, init_perm)``: the random draws
# of one level's two-step k-means (the sample is used only when the level
# takes no adaptive support-vector sample).
Draws = Callable[[int, int, int], Tuple[np.ndarray, np.ndarray]]


@dataclasses.dataclass(frozen=True)
class DCSVMConfig:
    """Mirrors the reference config field for field; ``use_pallas`` is
    ``use_kernels`` here.  Features outside the port so far raise
    ``NotImplementedError`` when set to a non-default value."""

    kernel: Kernel = Kernel("rbf", gamma=1.0)
    C: float = 1.0
    k: int = 4                     # branching factor (paper: 4)
    levels: int = 4                # l_max (paper: 4 => 256 bottom clusters)
    m: int = 1000                  # kmeans sample size (paper: 1000)
    kmeans_iters: int = 20
    tol: float = 1e-3              # projected-gradient stopping tolerance
    max_iters: int = 30_000        # per-(sub)problem CD iteration cap
    block: int = 0                 # 0 = paper-faithful 1-coordinate CD; >0 = block CD
    sweeps: int = 4                # inner sweeps for block CD
    eq_block_size: int = 1         # equality family only (not ported yet)
    adaptive: bool = True          # sample kmeans points from lower-level SVs
    refine: bool = True            # refine pass on level-1 SVs before final solve
    balanced: bool = True
    use_kernels: Optional[bool] = None  # None = CUDA kernels on cuda, plain on cpu
    early_stop_level: int = 0      # 0 = exact solve; l >= 1 = stop after level l
    gram_budget: int = DEFAULT_GRAM_BUDGET  # BYTE budget of a level's batch of
                                   # cluster Grams and the plain matvec chunks
    compute_dtype: Optional[str] = None  # bf16 operand policy (not ported yet)
    host_spill: bool = False       # out-of-core level 0 (not ported yet)
    gram_dedup: bool = True        # dedup view for duplicated dual rows (SVR)
    full_gram_threshold: int = 16384   # above this, level 0 uses the matvec solver
    col_cache_cap: int = 0         # kernel-column LRU (not ported yet)
    shrink_rounds: int = 3
    seed: int = 0
    trace: Optional[int] = None    # convergence-trace ring (not ported yet)

    def __post_init__(self):
        for name, ok in (("compute_dtype", self.compute_dtype is None),
                         ("host_spill", not self.host_spill),
                         ("col_cache_cap", self.col_cache_cap <= 0),
                         ("trace", self.trace is None)):
            if not ok:
                raise NotImplementedError(
                    f"DCSVMConfig.{name}={getattr(self, name)!r} is not "
                    "ported yet")


@dataclasses.dataclass
class DCSVMModel:
    config: DCSVMConfig
    X: torch.Tensor                # base training points (n, d)
    y: torch.Tensor                # labels in {-1, +1}
    alpha: torch.Tensor            # dual solution (n,)
    partition: Optional[Partition]  # partition at the stopping level
    is_early: bool
    level_stats: List[Dict[str, Any]]
    task: Task = dataclasses.field(default_factory=CSVC)
    beta: Optional[torch.Tensor] = None   # decision coefficients (n,)

    @property
    def weights(self) -> torch.Tensor:
        """Decision coefficients beta: f(x) = sum_i beta_i K(x_i, x)."""
        return self.beta if self.beta is not None else self.alpha * self.y

    @property
    def sv_index(self) -> np.ndarray:
        return np.nonzero(self.weights.cpu().numpy() != 0)[0]


# ---------------------------------------------------------------------------
# per-level solve
# ---------------------------------------------------------------------------

def _cluster_chunk(cfg: DCSVMConfig, k: int, nc: int) -> int:
    """Clusters per batch: as many (nc, nc) f32 Grams as ``gram_budget``
    holds, at least one.  The problems are independent, so the chunking does
    not change any result (the reference vmaps or ``lax.map``s them)."""
    return max(1, min(k, int(cfg.gram_budget) // max(nc * nc * 4, 1)))


def _signed_gram_(K: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """In place: K <- (s s') ∘ K (exact: s is +/-1)."""
    return K.mul_(s[..., :, None]).mul_(s[..., None, :])


def _solve_clusters(cfg: DCSVMConfig, Xc: torch.Tensor, sc: torch.Tensor,
                    pc: torch.Tensor, cc: torch.Tensor, ac: torch.Tensor,
                    mask: torch.Tensor, use_kernels: bool = False
                    ) -> torch.Tensor:
    """Solve the independent sub-QPs of one level.  Xc: (k, nc, d), mask:
    (k, nc); sc/pc/cc/ac: (k, n_rows, nc) class-stacked sign vectors, linear
    terms, boxes and warm starts.  Pad slots get a zero row and column and
    a unit diagonal, and are frozen by the solver's active mask."""
    k, nc, _ = Xc.shape
    n_cls = sc.shape[1]
    out = torch.empty_like(ac)
    step = _cluster_chunk(cfg, k, nc)
    eye = torch.arange(nc, device=Xc.device)
    counts = mask.sum(dim=1).cpu()
    for c0 in range(0, k, step):
        sl = slice(c0, min(k, c0 + step))
        mi = mask[sl]
        Kz = gram(cfg.kernel, Xc[sl], Xc[sl], use_kernels=use_kernels)
        # zero the pad rows/cols so pads cannot leak into real gradients;
        # a cluster's pad slots are its tail (Partition.build)
        for j, cnt in enumerate(counts[sl].tolist()):
            Kz[j, cnt:] = 0.0
            Kz[j, :, cnt:] = 0.0
        for r in range(n_cls):
            Q = Kz if r == n_cls - 1 else Kz.clone()
            _signed_gram_(Q, sc[sl, r])
            Q[:, eye, eye] += (~mi).to(Q.dtype)        # unit pad diagonal
            ai = torch.where(mi, ac[sl, r], 0.0)
            if 0 < cfg.block < nc:
                res = S.solve_box_qp_block(
                    Q, cc[sl, r], alpha0=ai, tol=cfg.tol,
                    max_iters=cfg.max_iters, block=cfg.block,
                    sweeps=cfg.sweeps, active_mask=mi, p=pc[sl, r])
            else:
                res = S.solve_box_qp(Q, cc[sl, r], alpha0=ai, tol=cfg.tol,
                                     max_iters=cfg.max_iters, active_mask=mi,
                                     p=pc[sl, r])
            out[sl, r] = res.alpha
            del Q
        del Kz
    return out


def _solve_subset(cfg: DCSVMConfig, td: TaskDual, alpha: torch.Tensor,
                  idx: torch.Tensor, use_kernels: bool = False
                  ) -> torch.Tensor:
    """Refine pass: solve the sub-QP restricted to ``idx`` (the level-1
    support vectors) with one shared subset Gram."""
    Xs = td.Xd[idx]
    Ks = gram(cfg.kernel, Xs, Xs, use_kernels=use_kernels)
    alpha = alpha.clone()
    for r in range(td.n_rows):
        Qs = Ks if r == td.n_rows - 1 else Ks.clone()
        _signed_gram_(Qs, td.S[r, idx])
        if cfg.block > 0:
            res = S.solve_box_qp_block(
                Qs, td.Cvec[r, idx], alpha0=alpha[r, idx], tol=cfg.tol,
                max_iters=cfg.max_iters, block=min(cfg.block, Qs.shape[0]),
                sweeps=cfg.sweeps, p=td.P[r, idx])
        else:
            res = S.solve_box_qp(Qs, td.Cvec[r, idx], alpha0=alpha[r, idx],
                                 tol=cfg.tol, max_iters=cfg.max_iters,
                                 p=td.P[r, idx])
        alpha[r, idx] = res.alpha
        del Qs
    return alpha


def _stack(results: List[S.SolveResult]) -> S.SolveResult:
    return S.SolveResult(*(torch.stack([getattr(r, f) for r in results])
                           for f in S.SolveResult._fields))


def _solve_full(cfg: DCSVMConfig, td: TaskDual, alpha: torch.Tensor,
                use_kernels: bool = False) -> S.SolveResult:
    """Level-0 solve on the whole dual, warm-started; class-stacked
    (n_rows, n) results.  Dense Gram + shrinking CD up to
    ``full_gram_threshold``, the Gram-free block CD above it."""
    n = td.n_dual
    results = []
    if n <= cfg.full_gram_threshold:
        K = gram(cfg.kernel, td.Xd, td.Xd, use_kernels=use_kernels)
        for r in range(td.n_rows):
            Q = K if r == td.n_rows - 1 else K.clone()
            _signed_gram_(Q, td.S[r])
            results.append(S.solve_with_shrinking(
                Q, td.Cvec[r], alpha0=alpha[r], tol=cfg.tol,
                max_iters=cfg.max_iters, rounds=cfg.shrink_rounds,
                block=cfg.block, p=td.P[r]))
            del Q
        return _stack(results)
    for r in range(td.n_rows):
        op = gramop.GramOperator(Xd=td.Xd, s=td.S[r], kernel=cfg.kernel,
                                 use_kernels=use_kernels,
                                 budget_bytes=cfg.gram_budget)
        results.append(S.solve_box_qp_op(
            op, td.Cvec[r], alpha0=alpha[r], tol=cfg.tol,
            max_iters=cfg.max_iters, block=max(cfg.block, 64),
            sweeps=cfg.sweeps, p=td.P[r]))
    return _stack(results)


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------

def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _fit_algorithm1(cfg: DCSVMConfig, X: torch.Tensor, td: TaskDual,
                    callback=None, draws: Optional[Draws] = None):
    """Algorithm 1 for a box-family dual.  Returns ``(alpha (n_rows, n),
    partition, stats, is_early)``."""
    n = X.shape[0]
    use_kernels = resolve_use_kernels(cfg.use_kernels, X.device)
    gen = torch.Generator().manual_seed(cfg.seed)
    alpha = torch.zeros(td.S.shape, dtype=X.dtype, device=X.device)
    sv_idx: Optional[np.ndarray] = None
    stats: List[Dict[str, Any]] = []
    partition: Optional[Partition] = None
    rng = np.random.default_rng(cfg.seed)

    for l in range(cfg.levels, 0, -1):
        kl = cfg.k ** l
        if kl >= n // 2:   # degenerate level (clusters of ~1 point): skip
            continue
        t0 = time.perf_counter()
        sample_idx = init_perm = None
        if cfg.adaptive and sv_idx is not None and len(sv_idx) > kl:
            sample_idx = rng.choice(sv_idx, size=min(cfg.m, len(sv_idx)),
                                    replace=False)
        if draws is not None:
            m_sample = min(cfg.m, n) if sample_idx is None else len(sample_idx)
            drawn_sample, init_perm = draws(l, n, m_sample)
            if sample_idx is None:
                sample_idx = drawn_sample
        with span(f"divide/level{l}/cluster"):
            partition = two_step_kernel_kmeans(
                cfg.kernel, X, kl, gen, m=cfg.m, iters=cfg.kmeans_iters,
                sample_idx=sample_idx, balanced=cfg.balanced,
                use_kernels=use_kernels, init_perm=init_perm)
        t_cluster = time.perf_counter() - t0

        t0 = time.perf_counter()
        with span(f"divide/level{l}/solve"):
            Xc = partition.gather(X)
            mask = torch.as_tensor(partition.mask, device=X.device)
            sc = partition.gather(td.S.T).transpose(1, 2)     # (k, n_rows, nc)
            pc = partition.gather(td.P.T).transpose(1, 2)
            cc = partition.gather(td.Cvec.T).transpose(1, 2)
            ac = partition.gather(alpha.T).transpose(1, 2)
            ac = torch.where(mask[:, None, :], ac, 0.0)
            ac = _solve_clusters(cfg, Xc, sc, pc, cc, ac, mask,
                                 use_kernels=use_kernels)
            alpha = partition.scatter(ac.transpose(1, 2), n).T.contiguous()
            _sync(alpha)
        t_train = time.perf_counter() - t0

        sv_idx = np.nonzero((alpha > 0).any(dim=0).cpu().numpy())[0]
        st = dict(level=l, clusters=kl, cluster_time=t_cluster,
                  train_time=t_train, n_sv=int(len(sv_idx)))
        stats.append(st)
        if callback is not None:
            callback(l, alpha, st)
        if cfg.early_stop_level == l:
            return alpha, partition, stats, True

    # ---- level 0: refine + full solve -----------------------------------
    t0 = time.perf_counter()
    if cfg.refine and sv_idx is not None and 0 < len(sv_idx) < n:
        with span("conquer/refine"):
            alpha = _solve_subset(cfg, td, alpha,
                                  torch.as_tensor(sv_idx, device=X.device),
                                  use_kernels=use_kernels)
            _sync(alpha)
    with span("conquer/solve"):
        res = _solve_full(cfg, td, alpha, use_kernels=use_kernels)
        alpha = res.alpha
        _sync(alpha)
    st = dict(level=0, clusters=1, cluster_time=0.0,
              train_time=time.perf_counter() - t0,
              n_sv=int((alpha > 0).any(dim=0).sum()),
              iters=int(res.iters.sum()),
              pg_max=float(res.pg_max.max()))
    stats.append(st)
    if callback is not None:
        callback(0, alpha, st)
    return alpha, partition, stats, False


def fit(cfg: DCSVMConfig, X, y, callback=None, task: Optional[Task] = None,
        device: DeviceLike = None, draws: Optional[Draws] = None
        ) -> DCSVMModel:
    """Train DC-SVM (binary C-SVC on +/-1 labels) on ``device`` (default
    ``cuda``).  ``callback(level, alpha, stats)`` fires after each level
    (level 0 = final solve).  ``draws`` injects each level's k-means draws
    (see ``Draws``); by default they come from a generator seeded with
    ``cfg.seed``."""
    task = resolve_task(task)
    if not isinstance(task, CSVC):
        raise NotImplementedError(f"task {task.name!r} is not ported yet")
    dev = resolve_device(device)
    X = as_tensor(X, dev, torch.float32).contiguous()
    y = as_tensor(y, dev, X.dtype)
    td = task.build(X, y[None, :], cfg.C)
    cb = None if callback is None else (lambda l, a, st: callback(l, a[0], st))
    alpha, partition, stats, is_early = _fit_algorithm1(cfg, X, td, cb, draws)
    beta = td.collapse(alpha)[0]
    return DCSVMModel(cfg, X, y, alpha[0], partition, is_early, stats,
                      task=task, beta=beta)


def objective_value(cfg: DCSVMConfig, X: torch.Tensor, y: torch.Tensor,
                    alpha: torch.Tensor, num_chunks: Optional[int] = None,
                    p=-1.0) -> torch.Tensor:
    """f(alpha) = 1/2 alpha' Q alpha + p' alpha on the full dual, without
    materialising Q (the streaming ``kernel_matvec`` kernel with
    ``use_kernels``, budget-sized plain chunks otherwise)."""
    Kv = gram_matvec(cfg.kernel, X, y * alpha, num_chunks=num_chunks,
                     use_kernels=resolve_use_kernels(cfg.use_kernels,
                                                     X.device),
                     budget_bytes=cfg.gram_budget)
    pvec = torch.as_tensor(p, dtype=alpha.dtype,
                           device=alpha.device).broadcast_to(alpha.shape)
    return 0.5 * torch.dot(alpha, y * Kv) + torch.dot(pvec, alpha)
