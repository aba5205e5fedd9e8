"""DC-SVM: multilevel divide-and-conquer kernel machines (paper Algorithm 1),
port of ``repro.core.dcsvm`` for every task of ``core.tasks``: C-SVC,
weighted C-SVC and epsilon-SVR (the box family), one-class SVM and nu-SVC
(the equality family).

Level l (= levels .. 1): partition all n points into k^l balanced clusters
by two-step kernel k-means (sampling from the lower level's support vectors
when ``adaptive``), then solve the k^l independent sub-QPs warm-started from
the lower level's alpha, as batches on the device.  Level 0: optional
refine pass on the level-1 support vectors, then the full problem: a dense
Gram with shrinking CD up to ``full_gram_threshold`` points, the Gram-free
block CD above it (the pairwise / blocked engines for the equality family).
Clustering is label-free on the n base points; the base partition is
expanded to the task's dual coordinates, so SVR's mirrored pair of a sample
shares a cluster, and with ``gram_dedup`` the Grams of such a task are
computed on the base rows and gathered.  ``early_stop_level = l`` stops
after level l and returns an early-prediction model (paper eq. 11).
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
from repro_torch.obs.trace import (ConvTrace, trace_fetch, trace_init,
                                   trace_summary)

# ``draws(level, n, m_sample) -> (sample_idx, init_perm)``: the random draws
# of one level's two-step k-means (the sample is used only when the level
# takes no adaptive support-vector sample).
Draws = Callable[[int, int, int], Tuple[np.ndarray, np.ndarray]]


@dataclasses.dataclass(frozen=True)
class DCSVMConfig:
    """Mirrors the reference config field for field; ``use_pallas`` is
    ``use_kernels`` here."""

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
    eq_block_size: int = 1         # equality family: B maximal-violating pairs
                                   # an outer iteration (rank-2B blocked
                                   # engine); <= 1 = the rank-2 pairwise one
    adaptive: bool = True          # sample kmeans points from lower-level SVs
    refine: bool = True            # refine pass on level-1 SVs before final solve
    balanced: bool = True
    use_kernels: Optional[bool] = None  # None = CUDA kernels on cuda, plain on cpu
    early_stop_level: int = 0      # 0 = exact solve; l >= 1 = stop after level l
    gram_budget: int = DEFAULT_GRAM_BUDGET  # BYTE budget of a level's batch of
                                   # cluster Grams and the plain matvec chunks
    compute_dtype: Optional[str] = None  # Gram product-operand precision, e.g.
                                   # "bfloat16" (f32 accumulation); None = f32
    host_spill: bool = False       # level 0 out of core: kernel-row panels
                                   # spilled to pinned host RAM, device pool
                                   # + prefetch (core.gramop)
    gram_dedup: bool = True        # dedup view for duplicated dual rows (SVR)
    full_gram_threshold: int = 16384   # above this, level 0 uses the matvec solver
    col_cache_cap: int = 0         # kernel-row LRU slots of the level-0
                                   # block CD (core.colcache); 0 = none
    shrink_rounds: int = 3
    seed: int = 0
    trace: Optional[int] = None    # convergence-trace ring capacity of the
                                   # level-0 solve: keeps its LAST ``trace``
                                   # samples a class (obs.trace), fetched
                                   # once at the end into level_stats[-1]
                                   # ("trace", "trace_summary"); None or 0:
                                   # no ring, the untraced loops


@dataclasses.dataclass
class DCSVMModel:
    config: DCSVMConfig
    X: torch.Tensor                # base training points (n, d)
    y: torch.Tensor                # labels in {-1, +1} (SVR: real targets)
    alpha: torch.Tensor            # dual solution (n_dual,: 2n for SVR)
    partition: Optional[Partition]  # partition at the stopping level
    is_early: bool
    level_stats: List[Dict[str, Any]]
    task: Task = dataclasses.field(default_factory=CSVC)
    beta: Optional[torch.Tensor] = None   # decision coefficients (n,)
    rho: Optional[float] = None    # decision offset of the equality tasks:
                                   # f(x) = sum_i beta_i K(x_i, x) - rho
    rho_clusters: Optional[torch.Tensor] = None  # (k,) per-cluster offsets
                                   # of an early equality model (eq.-11
                                   # routing subtracts the routed cluster's)

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


def _split_eq_targets(Ac: torch.Tensor, Cc: torch.Tensor, mask: torch.Tensor,
                      Gc: torch.Tensor, d_total: torch.Tensor,
                      n_groups: int) -> torch.Tensor:
    """Proportional split of the global equality target(s) over clusters.

    ``Ac``/``Cc``/``Gc``: (k, n_rows, nc) gathered coefficients, boxes and
    group ids, ``mask``: (k, nc), ``d_total``: (n_rows, n_groups).  Per
    group, each cluster's target sits at the same relative position inside
    its attainable interval [sum_{a<0} a c, sum_{a>0} a c] as d_g inside
    the global one, so every sub-QP is feasible and the targets sum to d_g;
    a cluster with no member of the group gets 0.  Returns (k, n_rows,
    n_groups)."""
    m = mask[:, None, :]
    out = []
    for g in range(n_groups):
        contrib = torch.where(m & (Gc == g), Ac * Cc, 0.0)
        hi_c = torch.sum(torch.clamp(contrib, min=0.0), dim=-1)   # (k, n_rows)
        lo_c = torch.sum(torch.clamp(contrib, max=0.0), dim=-1)
        lo, hi = torch.sum(lo_c, dim=0), torch.sum(hi_c, dim=0)   # (n_rows,)
        span = torch.clamp(hi - lo, min=1e-12)
        frac = (torch.minimum(torch.maximum(d_total[:, g], lo), hi) - lo) / span
        out.append(lo_c + frac[None, :] * (hi_c - lo_c))
    return torch.stack(out, dim=-1)


def _cluster_grams(cfg: DCSVMConfig, Xc: torch.Tensor, counts, sl: slice,
                   use_kernels: bool, Xcb: Optional[torch.Tensor] = None,
                   lbc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (b, nc, nc) Grams of clusters ``sl`` with zero pad rows and
    columns (a cluster's pad slots are its tail, ``Partition.build``).
    Under the dedup view the Gram is computed on the cluster's base rows
    ``Xcb`` and gathered through the slot map ``lbc``: the same values."""
    cd = cfg.compute_dtype
    if Xcb is None:
        Kz = gram(cfg.kernel, Xc[sl], Xc[sl], use_kernels=use_kernels,
                  compute_dtype=cd).to(Xc.dtype)
    else:
        # one cluster at a time: a broadcast (b, nc, nc) index would take
        # three int64 copies of the Gram's size
        Kb = gram(cfg.kernel, Xcb[sl], Xcb[sl], use_kernels=use_kernels,
                  compute_dtype=cd).to(Xc.dtype)
        lb = lbc[sl]
        Kz = Kb.new_empty((lb.shape[0], lb.shape[1], lb.shape[1]))
        for j in range(lb.shape[0]):
            torch.index_select(Kb[j].index_select(0, lb[j]), 1, lb[j],
                               out=Kz[j])
        del Kb
    for j, cnt in enumerate(counts[sl].tolist()):
        Kz[j, cnt:] = 0.0
        Kz[j, :, cnt:] = 0.0
    return Kz


def _solve_clusters(cfg: DCSVMConfig, Xc: torch.Tensor, sc: torch.Tensor,
                    pc: torch.Tensor, cc: torch.Tensor, ac: torch.Tensor,
                    mask: torch.Tensor, use_kernels: bool = False,
                    aeq: Optional[torch.Tensor] = None,
                    geq: Optional[torch.Tensor] = None,
                    deq: Optional[torch.Tensor] = None, n_groups: int = 1,
                    Xcb: Optional[torch.Tensor] = None,
                    lbc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve the independent sub-QPs of one level.  Xc: (k, nc, d), mask:
    (k, nc); sc/pc/cc/ac: (k, n_rows, nc) class-stacked sign vectors, linear
    terms, boxes and warm starts.  Pad slots get a zero row and column and
    a unit diagonal, and are frozen by the solver's active mask.

    ``aeq``/``geq``/``deq`` (equality family): (k, n_rows, nc) coefficients
    and group ids and the (k, n_rows, n_groups) per-cluster targets of
    ``_split_eq_targets``, solved by the pairwise (``eq_block_size <= 1``)
    or blocked engine.  ``Xcb``/``lbc``: the dedup view's per-cluster base
    rows and slot map."""
    k, nc, _ = Xc.shape
    n_cls = sc.shape[1]
    out = torch.empty_like(ac)
    step = _cluster_chunk(cfg, k, nc)
    eye = torch.arange(nc, device=Xc.device)
    counts = mask.sum(dim=1).cpu()
    for c0 in range(0, k, step):
        sl = slice(c0, min(k, c0 + step))
        mi = mask[sl]
        Kz = _cluster_grams(cfg, Xc, counts, sl, use_kernels, Xcb, lbc)
        for r in range(n_cls):
            Q = Kz if r == n_cls - 1 else Kz.clone()
            _signed_gram_(Q, sc[sl, r])
            Q[:, eye, eye] += (~mi).to(Q.dtype)        # unit pad diagonal
            ai = torch.where(mi, ac[sl, r], 0.0)
            kw = dict(alpha0=ai, tol=cfg.tol, max_iters=cfg.max_iters,
                      active_mask=mi, p=pc[sl, r])
            if aeq is not None:
                eq = (torch.where(mi, cc[sl, r], 0.0),
                      torch.where(mi, aeq[sl, r], 0.0), deq[sl, r])
                kw.update(gid=geq[sl, r], n_groups=n_groups)
                if cfg.eq_block_size > 1:
                    res = S.solve_eq_qp_block(Q, *eq, block=cfg.eq_block_size,
                                              sweeps=cfg.sweeps, **kw)
                else:
                    res = S.solve_eq_qp(Q, *eq, **kw)
            elif 0 < cfg.block < nc:
                res = S.solve_box_qp_block(Q, cc[sl, r], block=cfg.block,
                                           sweeps=cfg.sweeps, **kw)
            else:
                res = S.solve_box_qp(Q, cc[sl, r], **kw)
            out[sl, r] = res.alpha
            del Q
        del Kz
    return out


def _solve_subset(cfg: DCSVMConfig, td: TaskDual, alpha: torch.Tensor,
                  idx: torch.Tensor, use_kernels: bool = False
                  ) -> torch.Tensor:
    """Refine pass: solve the sub-QP restricted to ``idx`` (the level-1
    support vectors, dual coordinates) with one shared subset Gram.  An
    equality task keeps the frozen complement's a'u: each group's target
    is d_g less the complement's share."""
    Xs = td.Xd[idx]
    Ks = gram(cfg.kernel, Xs, Xs, use_kernels=use_kernels,
              compute_dtype=cfg.compute_dtype).to(Xs.dtype)
    ds = None
    if td.has_equality:
        G = td.n_groups
        oh = td.group_ids[..., None] == torch.arange(G, device=idx.device)
        au = (td.A * alpha)[..., None] * oh                 # (n_rows, nd, G)
        ds = td.Deq - torch.sum(au, dim=1) + torch.sum(au[:, idx], dim=1)
    alpha = alpha.clone()
    for r in range(td.n_rows):
        Qs = Ks if r == td.n_rows - 1 else Ks.clone()
        _signed_gram_(Qs, td.S[r, idx])
        kw = dict(alpha0=alpha[r, idx], tol=cfg.tol, max_iters=cfg.max_iters,
                  p=td.P[r, idx])
        if ds is not None:
            eq = (td.Cvec[r, idx], td.A[r, idx], ds[r])
            kw.update(gid=td.group_ids[r, idx], n_groups=td.n_groups)
            if cfg.eq_block_size > 1:
                res = S.solve_eq_qp_block(Qs, *eq, block=cfg.eq_block_size,
                                          sweeps=cfg.sweeps, **kw)
            else:
                res = S.solve_eq_qp(Qs, *eq, **kw)
        elif cfg.block > 0:
            res = S.solve_box_qp_block(Qs, td.Cvec[r, idx],
                                       block=min(cfg.block, Qs.shape[0]),
                                       sweeps=cfg.sweeps, **kw)
        else:
            res = S.solve_box_qp(Qs, td.Cvec[r, idx], **kw)
        alpha[r, idx] = res.alpha
        del Qs
    return alpha


def _stack(results: List[S.SolveResult]) -> S.SolveResult:
    """Per-class results stacked along a new leading axis, field by field
    (a trace ring leaf by leaf), as the reference's class ``vmap``."""
    def stack(vals):
        if vals[0] is None:
            return None
        if isinstance(vals[0], ConvTrace):
            return ConvTrace(*(torch.stack(v) for v in zip(*vals)))
        return torch.stack(vals)
    return S.SolveResult(*(stack([getattr(r, f) for r in results])
                           for f in S.SolveResult._fields))


def _solve_full(cfg: DCSVMConfig, td: TaskDual, alpha: torch.Tensor,
                use_kernels: bool = False) -> S.SolveResult:
    """Level-0 solve on the whole dual, warm-started; class-stacked
    (n_rows, n_dual) results.  Dense Gram + shrinking up to
    ``full_gram_threshold``, the Gram-free engines above it.  A task with
    duplicated dual rows takes the dedup view (``cfg.gram_dedup``): the
    dense Gram over the base rows gathered, or the operator's view.
    ``host_spill`` takes the box family out of core even under the dense
    threshold (``gramop.solve_box_qp_spill``, the device budget split over
    the rows); ``col_cache_cap`` gives the Gram-free box engine a column
    cache sized within ``gram_budget``.  ``cfg.trace`` gives each class's
    engine a fresh ring."""
    n = td.n_dual
    cd = cfg.compute_dtype

    def _tr():
        return (trace_init(cfg.trace, device=td.Xd.device) if cfg.trace
                else None)

    dedup = cfg.gram_dedup and td.n_base != n and not td.has_equality
    Xb, bidx = td.base_view() if dedup else (None, None)
    eq = [(td.A[r], td.Deq[r], td.group_ids[r]) for r in range(td.n_rows)] \
        if td.has_equality else None
    # the flag means "never materialise the level-0 Gram"; the equality
    # family stays on its dense and Gram-free engines
    spill = cfg.host_spill and not td.has_equality
    n_cls = td.n_rows
    results = []
    if n <= cfg.full_gram_threshold and not spill:
        if dedup:
            K = gram(cfg.kernel, Xb, Xb, use_kernels=use_kernels,
                     compute_dtype=cd).to(Xb.dtype)[bidx][:, bidx]
        else:
            K = gram(cfg.kernel, td.Xd, td.Xd, use_kernels=use_kernels,
                     compute_dtype=cd).to(td.Xd.dtype)
        for r in range(td.n_rows):
            Q = K if r == td.n_rows - 1 else K.clone()
            _signed_gram_(Q, td.S[r])
            kw = dict(alpha0=alpha[r], tol=cfg.tol, max_iters=cfg.max_iters,
                      rounds=cfg.shrink_rounds, p=td.P[r])
            if eq is not None:
                a, d, gid = eq[r]
                results.append(S.solve_eq_qp_shrink(
                    Q, td.Cvec[r], a, d, block=cfg.eq_block_size,
                    sweeps=cfg.sweeps, gid=gid, n_groups=td.n_groups,
                    trace=_tr(), **kw))
            else:
                results.append(S.solve_with_shrinking(
                    Q, td.Cvec[r], block=cfg.block, trace=_tr(), **kw))
            del Q
        return _stack(results)
    for r in range(td.n_rows):
        if eq is not None:
            a, d, gid = eq[r]
            results.append(S.solve_eq_qp_matvec(
                td.Xd, td.S[r], cfg.kernel, td.Cvec[r], a, d,
                alpha0=alpha[r], tol=cfg.tol, max_iters=cfg.max_iters,
                use_kernels=use_kernels, p=td.P[r], block=cfg.eq_block_size,
                sweeps=cfg.sweeps, gid=gid, n_groups=td.n_groups,
                compute_dtype=cd, trace=_tr()))
            continue
        op = gramop.GramOperator(Xd=td.Xd, s=td.S[r], Xb=Xb, bidx=bidx,
                                 kernel=cfg.kernel, use_kernels=use_kernels,
                                 compute_dtype=cd,
                                 budget_bytes=cfg.gram_budget)
        kw = dict(alpha0=alpha[r], tol=cfg.tol, max_iters=cfg.max_iters,
                  block=max(cfg.block, 64), sweeps=cfg.sweeps, p=td.P[r],
                  trace=_tr())
        if spill:
            # gram_budget is the DEVICE byte budget of the panels
            results.append(gramop.solve_box_qp_spill(
                op, td.Cvec[r], device_budget_bytes=cfg.gram_budget
                // max(n_cls, 1), **kw))
            continue
        # the cache buffers count against the same byte budget as the
        # cluster Grams: bf16 storage fits twice the f32 rows
        store = op.storage_dtype(torch.float32).itemsize
        cache_cap = min(cfg.col_cache_cap, n,
                        cfg.gram_budget // max(op.kwidth * n_cls * store, 1))
        results.append(S.solve_box_qp_op(op, td.Cvec[r], cache_cap=cache_cap,
                                         **kw))
    return _stack(results)


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------

def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _dedup_slots(partition: Partition, dpart: Partition,
                 base_index: np.ndarray, n: int, device) -> torch.Tensor:
    """The dedup view's slot map: each dual slot of ``dpart`` -> its base
    point's slot inside the base partition's cluster (the mirrored pair
    shares a cluster by construction); 0 on pad slots."""
    pos = np.zeros(n, np.int64)
    ci, si = np.nonzero(partition.mask)
    pos[partition.idx[ci, si]] = si
    didx = dpart.idx
    return torch.as_tensor(np.where(dpart.mask,
                                    pos[base_index[np.maximum(didx, 0)]], 0),
                           device=device)


def _fit_algorithm1(cfg: DCSVMConfig, X: torch.Tensor, td: TaskDual,
                    callback=None, draws: Optional[Draws] = None):
    """Algorithm 1 for any task's dual.  Returns ``(alpha (n_rows,
    n_dual), base partition, stats, is_early)``."""
    n = X.shape[0]
    nd = td.n_dual
    base_index = np.asarray(td.base_index)
    use_kernels = resolve_use_kernels(cfg.use_kernels, X.device)
    gen = torch.Generator().manual_seed(cfg.seed)
    alpha = torch.zeros(td.S.shape, dtype=X.dtype, device=X.device)
    sv_idx: Optional[np.ndarray] = None     # dual coordinates with alpha > 0
    sv_base: Optional[np.ndarray] = None    # their base points
    stats: List[Dict[str, Any]] = []
    partition: Optional[Partition] = None
    rng = np.random.default_rng(cfg.seed)

    for l in range(cfg.levels, 0, -1):
        kl = cfg.k ** l
        if kl >= n // 2:   # degenerate level (clusters of ~1 point): skip
            continue
        t0 = time.perf_counter()
        sample_idx = init_perm = None
        if cfg.adaptive and sv_base is not None and len(sv_base) > kl:
            sample_idx = rng.choice(sv_base, size=min(cfg.m, len(sv_base)),
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
        # the base partition expanded to dual coordinates: SVR's mirrored
        # pair inherits its sample's cluster
        dpart = partition if nd == n else Partition.build(
            partition.assign[base_index].astype(np.int32), kl,
            partition.model)
        t_cluster = time.perf_counter() - t0

        t0 = time.perf_counter()
        with span(f"divide/level{l}/solve"):
            Xcb = lbc = None
            if cfg.gram_dedup and nd != n:
                lbc = _dedup_slots(partition, dpart, base_index, n, X.device)
                Xcb = partition.gather(X)
            Xc = dpart.gather(td.Xd)
            mask = torch.as_tensor(dpart.mask, device=X.device)
            sc = dpart.gather(td.S.T).transpose(1, 2)     # (k, n_rows, nc)
            pc = dpart.gather(td.P.T).transpose(1, 2)
            cc = dpart.gather(td.Cvec.T).transpose(1, 2)
            ac = dpart.gather(alpha.T).transpose(1, 2)
            ac = torch.where(mask[:, None, :], ac, 0.0)
            aeqc = geqc = deqc = None
            if td.has_equality:
                aeqc = dpart.gather(td.A.T).transpose(1, 2)
                geqc = dpart.gather(td.group_ids.T).transpose(1, 2)
                deqc = _split_eq_targets(aeqc, cc, mask, geqc, td.Deq,
                                         td.n_groups)
            ac = _solve_clusters(cfg, Xc, sc, pc, cc, ac, mask,
                                 use_kernels=use_kernels, aeq=aeqc, geq=geqc,
                                 deq=deqc, n_groups=max(td.n_groups, 1),
                                 Xcb=Xcb, lbc=lbc)
            alpha = dpart.scatter(ac.transpose(1, 2), nd).T.contiguous()
            _sync(alpha)
        t_train = time.perf_counter() - t0

        sv_idx = np.nonzero((alpha > 0).any(dim=0).cpu().numpy())[0]
        sv_base = np.unique(base_index[sv_idx])
        st = dict(level=l, clusters=kl, cluster_time=t_cluster,
                  train_time=t_train, n_sv=int(len(sv_base)))
        stats.append(st)
        if callback is not None:
            callback(l, alpha, st)
        if cfg.early_stop_level == l:
            return alpha, partition, stats, True

    # ---- level 0: refine + full solve -----------------------------------
    t0 = time.perf_counter()
    if cfg.refine and sv_idx is not None and 0 < len(sv_idx) < nd:
        with span("conquer/refine"):
            alpha = _solve_subset(cfg, td, alpha,
                                  torch.as_tensor(sv_idx, device=X.device),
                                  use_kernels=use_kernels)
            _sync(alpha)
    with span("conquer/solve"):
        res = _solve_full(cfg, td, alpha, use_kernels=use_kernels)
        alpha = res.alpha
        _sync(alpha)
    sv0 = (alpha > 0).any(dim=0).cpu().numpy()
    st = dict(level=0, clusters=1, cluster_time=0.0,
              train_time=time.perf_counter() - t0,
              n_sv=int(len(np.unique(base_index[sv0]))),
              iters=int(res.iters.sum()),
              pg_max=float(res.pg_max.max()))
    if res.cache_hits is not None:
        hits, misses = int(res.cache_hits.sum()), int(res.cache_misses.sum())
        st.update(cache_hits=hits, cache_misses=misses,
                  cache_hit_rate=hits / max(hits + misses, 1))
    for name in ("cache_evictions", "spills", "spill_hits"):
        v = getattr(res, name)
        if v is not None:
            st[name] = int(v.sum())
    if res.trace is not None:
        # the one device-to-host copy of the fit's traces
        st["trace"] = trace_fetch(res.trace)
        st["trace_summary"] = trace_summary(st["trace"])
    stats.append(st)
    if callback is not None:
        callback(0, alpha, st)
    return alpha, partition, stats, False


def _recover_rho_clusters(cfg: DCSVMConfig, td: TaskDual, task: Task,
                          alpha: torch.Tensor, partition: Partition
                          ) -> torch.Tensor:
    """Per-cluster decision offsets of an early-stopped equality model:
    each cluster's sub-QP carried its own constraint(s), so its offset is
    its local multiplier combination (``task.recover_offset`` on the
    cluster's gradient, one masked Gram matvec a cluster, in batches the
    Gram budget holds).  Equality tasks have n_dual == n_base, so the base
    partition indexes the dual coordinates."""
    use_kernels = resolve_use_kernels(cfg.use_kernels, alpha.device)
    Xc = partition.gather(td.Xd)
    mask = torch.as_tensor(partition.mask, device=alpha.device)
    sc, pc, cc, aq, gq, uc = (partition.gather(v[0]) for v in (
        td.S, td.P, td.Cvec, td.A, td.group_ids, alpha))
    counts = mask.sum(dim=1).cpu()
    k = partition.k
    out = []
    for c0 in range(0, k, _cluster_chunk(cfg, k, partition.nc)):
        sl = slice(c0, min(k, c0 + _cluster_chunk(cfg, k, partition.nc)))
        mi = mask[sl]
        Kz = _cluster_grams(cfg, Xc, counts, sl, use_kernels)
        ui = torch.where(mi, uc[sl], 0.0)
        gi = sc[sl] * S._mv(Kz, sc[sl] * ui) + pc[sl]
        out.append(task.recover_offset(ui, gi, torch.where(mi, cc[sl], 0.0),
                                       torch.where(mi, aq[sl], 0.0), gq[sl],
                                       active_mask=mi))
        del Kz
    return torch.cat(out)


def _recover_rho(cfg: DCSVMConfig, td: TaskDual, task: Task,
                 alpha: torch.Tensor) -> float:
    """Decision offset rho at the returned dual: one kernel matvec for the
    full gradient, then the task's reading of the multiplier bracket(s)."""
    s = td.S[0]
    g = s * gram_matvec(cfg.kernel, td.Xd, s * alpha[0],
                        use_kernels=resolve_use_kernels(cfg.use_kernels,
                                                        alpha.device),
                        compute_dtype=cfg.compute_dtype) + td.P[0]
    return float(task.recover_offset(alpha[0], g, td.Cvec[0], td.A[0],
                                     td.group_ids[0]))


def fit(cfg: DCSVMConfig, X, y=None, callback=None,
        task: Optional[Task] = None, device: DeviceLike = None,
        draws: Optional[Draws] = None, dtype: torch.dtype = torch.float32
        ) -> DCSVMModel:
    """Train DC-SVM on any task of ``core.tasks`` (default: C-SVC on +/-1
    labels) on ``device`` (default ``cuda``), in ``dtype`` (the CUDA
    kernels take float32).  For regression ``y`` holds real targets; a
    label-free task (one-class SVM) takes ``y=None``.  ``callback(level,
    alpha, stats)`` fires after each level (level 0 = final solve) with the
    dual vector (2n coordinates for SVR).  ``draws`` injects each level's
    k-means draws (see ``Draws``); by default they come from a generator
    seeded with ``cfg.seed``."""
    task = resolve_task(task)
    if type(task).build is Task.build:
        raise NotImplementedError(f"task {task.name!r} is not ported")
    dev = resolve_device(device)
    X = as_tensor(X, dev, dtype).contiguous()
    if y is None:
        if not task.label_free:
            raise ValueError(f"task {task.name!r} requires labels y")
        y = torch.zeros(X.shape[0], dtype=X.dtype, device=dev)
    y = as_tensor(y, dev, X.dtype)
    td = task.build(X, y[None, :], cfg.C)
    cb = None if callback is None else (lambda l, a, st: callback(l, a[0], st))
    alpha, partition, stats, is_early = _fit_algorithm1(cfg, X, td, cb, draws)
    beta = td.collapse(alpha)[0]
    rho = rho_clusters = None
    if task.has_rho_offset:
        rho = _recover_rho(cfg, td, task, alpha)
        if is_early and partition is not None:
            rho_clusters = _recover_rho_clusters(cfg, td, task, alpha,
                                                 partition)
    return DCSVMModel(cfg, X, y, alpha[0], partition, is_early, stats,
                      task=task, beta=beta, rho=rho,
                      rho_clusters=rho_clusters)


def objective_value(cfg: DCSVMConfig, X: torch.Tensor, y: torch.Tensor,
                    alpha: torch.Tensor, num_chunks: Optional[int] = None,
                    p=-1.0) -> torch.Tensor:
    """f(alpha) = 1/2 alpha' Q alpha + p' alpha on the full dual, without
    materialising Q (the streaming ``kernel_matvec`` kernel with
    ``use_kernels``, budget-sized plain chunks otherwise)."""
    Kv = gram_matvec(cfg.kernel, X, y * alpha, num_chunks=num_chunks,
                     use_kernels=resolve_use_kernels(cfg.use_kernels,
                                                     X.device),
                     budget_bytes=cfg.gram_budget,
                     compute_dtype=cfg.compute_dtype)
    pvec = torch.as_tensor(p, dtype=alpha.dtype,
                           device=alpha.device).broadcast_to(alpha.shape)
    return 0.5 * torch.dot(alpha, y * Kv) + torch.dot(pvec, alpha)
