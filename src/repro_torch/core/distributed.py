"""Distributed DC-SVM (port of ``repro.core.distributed``): the divide step
sharded over the ranks of a conquer mesh (``launch.mesh``), and the
communication-efficient parallel block minimisation conquer (CE-PBM;
Hsieh, Si & Dhillon 2016) over ``torch.distributed``.

Both run on the box dual ``min 1/2 u'Qu + p'u, 0 <= u <= c`` with
``Q = (s s') ∘ K`` (C-SVC, weighted C-SVC, epsilon-SVR):

1. ``divide_step``: the k clusters fall into P equal shares, one a rank;
   a rank solves its k/P clusters against their own Grams (``kermat``
   with ``use_kernels``), as one batch when they fit ``gram_budget``, else
   one cluster at a time, and one all-gather returns every cluster's
   alpha to every rank.  No other communication: DC-SVM's subproblems are
   independent.
2. ``conquer_step``: the rows of (X, s, alpha, g) fall into P shards.  A
   round: every rank takes its local top-B coordinates by |projected
   gradient| and solves its own B x B sub-QP; one all-gather ships the P
   blocks (rows, signs, proposed steps, and each rank's g'Δ and largest
   score); the combination step γ* = clip(-g'Δ / Δ'QΔ, 0, 1)
   (``solver.combination_step_size``) comes from the replicated (PB, PB)
   Gram and the sum of the gathered g'Δ; steps a block solve aimed at a
   box bound snap onto it within an O(tol) band; a second all-gather
   ships the applied steps, and every rank adds the rank-PB update to its
   gradient shard (``cd_column_update``, or the rows of the column
   cache).  ``mode="replicated"`` is the baseline: every rank solves the
   same global top-B block.

Every rank passes the whole inputs, takes its shard and returns the whole
result, as the reference's ``shard_map`` takes and gives global arrays
(so the initial gradient reads the rows the reference all-gathers from
the rank's own copy).  The loop condition is the same on every rank: the
round's ``pg`` is the largest gathered score (the reference's pmax) and
``g'Δ`` the sum of the gathered ones (its psum), so every rank runs the
same rounds and the same collectives.  The rounds run eagerly; as in
``core.solver`` a ``running`` flag on the device freezes a finished
problem and the host reads it every ``SYNC_EVERY`` rounds, so ``rounds``
is the reference's count.  On a CUDA device the B x B sub-solve replays as
one CUDA graph (``solver._Stepper``): its ``sweeps * B`` scalar steps are
five launches each.

``fit_distributed`` runs the multilevel pipeline: the clustering on every
rank (rank 0's partition broadcast, so the ranks agree), the divide step
a level, the support-vector mass on the device, the conquer.  The
reference draws its k-means sample, init permutation and adaptive sample
from ``jax.random``, which torch cannot reproduce, so they are injected
(``draws`` as in ``core.dcsvm.fit``, ``sv_draws``) or drawn from a
generator seeded with ``cfg.seed``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import colcache, gramop
from repro_torch.core import solver as S
from repro_torch.core.dcsvm import Draws
from repro_torch.core.kernels import Kernel, gram, resolve_use_kernels
from repro_torch.core.kkmeans import Partition, two_step_kernel_kmeans
from repro_torch.core.solver import (SYNC_EVERY, combination_step_size,
                                     proj_grad)
from repro_torch.core.tasks import Task, resolve_task
from repro_torch.device import as_tensor
from repro_torch.kernels.ops import as_dtype, resolve_compute_dtype
from repro_torch.obs.spans import span
from repro_torch.obs.trace import (trace_fetch, trace_init, trace_record,
                                   trace_summary)

# ``sv_draws(level, sv_mask, m) -> idx``: the adaptive k-means sample of a
# level, m indices with every support vector first (random order) and a
# random non-SV fill (the reference's ``_sv_sample``).
SvDraws = Callable[[int, torch.Tensor, int], torch.Tensor]


# ---------------------------------------------------------------------------
# divide step
# ---------------------------------------------------------------------------

def divide_step(mesh, axis: str, cfg, Xc, sc, pc, cc, ac, mask
                ) -> torch.Tensor:
    """Solve one level's clusters of the box dual, sharded over ``axis``.

    ``Xc``: (k, nc, d), k a multiple of the axis size; ``sc``/``pc``/
    ``cc``/``ac``/``mask``: (k, nc) sign vectors, linear terms, boxes,
    warm starts and pad masks.  A rank builds and solves the Grams of its
    own k/P clusters: as one batch when ``(k/P) nc^2`` f32 entries fit
    ``cfg.gram_budget``, else one cluster at a time (the same solve on a
    batch of one, the same bits from a zero warm start).  Returns the
    (k, nc) alpha of every cluster, on every rank."""
    dev = mesh.device
    use_kernels = resolve_use_kernels(cfg.use_kernels, dev)
    P_ = mesh.shape[axis]
    k, nc, _ = Xc.shape
    if k % P_ != 0:
        raise ValueError(
            f"cluster count {k} must be a multiple of the mesh axis size "
            f"{P_} (fit_distributed rounds k up for you)")
    kl = k // P_
    # per-rank residency decided on the byte budget (f32 cluster Grams)
    resident = gramop.fits_budget(kl * nc * nc, cfg.gram_budget)
    mine = slice(mesh.rank * kl, (mesh.rank + 1) * kl)
    Xl = as_tensor(Xc, dev)[mine].contiguous()
    sl, pl, cl, al = (as_tensor(t, dev, Xl.dtype)[mine]
                      for t in (sc, pc, cc, ac))
    ml = as_tensor(mask, dev, torch.bool)[mine]

    def solve(b: slice) -> torch.Tensor:
        Xi, si, mi = Xl[b], sl[b], ml[b]
        # one Gram a cluster (one kermat launch each): a cluster's Gram is
        # then the same bits in a batch or alone (the kernels' mean shift
        # is a reduction whose order follows the batch's shape)
        Ki = Xi.new_empty((Xi.shape[0], nc, nc))
        for j in range(Xi.shape[0]):
            Ki[j] = gram(cfg.kernel, Xi[j], Xi[j], use_kernels=use_kernels,
                         compute_dtype=cfg.compute_dtype)
        mm = mi[:, :, None] & mi[:, None, :]
        Qi = (si[:, :, None] * si[:, None, :]) * torch.where(mm, Ki, 0.0)
        Qi = Qi + torch.diag_embed((~mi).to(Qi.dtype))
        ai = torch.where(mi, al[b], 0.0)
        kw = dict(alpha0=ai, tol=cfg.tol, max_iters=cfg.max_iters,
                  active_mask=mi, p=pl[b])
        if 0 < cfg.block < nc:
            res = S.solve_box_qp_block(Qi, cl[b], block=cfg.block,
                                       sweeps=cfg.sweeps, **kw)
        else:
            res = S.solve_box_qp(Qi, cl[b], **kw)
        return res.alpha

    if resident:
        out = solve(slice(0, kl))
    else:
        out = torch.cat([solve(slice(j, j + 1)) for j in range(kl)])
    return mesh.all_gather(out).reshape(k, nc)


# ---------------------------------------------------------------------------
# conquer step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConquerConfig:
    kernel: Kernel
    C: float = 1.0           # scalar box; per coordinate: conquer_step(c=)
    tol: float = 1e-3
    max_iters: int = 2_000   # communication-round cap
    block: int = 64          # per-rank block size B
    sweeps: int = 4
    mode: str = "parallel"   # "parallel" = CE-PBM (P local blocks a round);
                             # "replicated" = the global top-B baseline
    use_kernels: Optional[bool] = None  # None = CUDA kernels on cuda
    cache_cap: int = 0       # LRU slots for (P*B, n_local) Q-row slices;
                             # 0 = fused recompute (parallel mode only)
    grad_chunks: int = 16    # row chunks of the plain initial gradient
    compute_dtype: Optional[str] = None  # Gram operand precision (bf16
                             # operands, f32 accumulation); cached Q-row
                             # slices store in this dtype too
    trace_cap: int = 0       # convergence-trace ring capacity (obs.trace);
                             # > 0 records one sample a round and
                             # conquer_step returns a 4th ConvTrace


class _SubSolve:
    """The B x B sub-solve of a round (``solver._solve_small_qp``) over
    static buffers: eager off CUDA, a CUDA graph replay on CUDA (captured
    thread-locally: NCCL's watchdog thread calls CUDA meanwhile).  Every
    call is a real solve, so graphed and eager rounds agree bit for bit."""

    def __init__(self, B: int, sweeps: int, acc: torch.dtype,
                 dtype: torch.dtype, device: torch.device):
        self.Q = torch.zeros((1, B, B), dtype=acc, device=device)
        self.g = torch.zeros((1, B), dtype=acc, device=device)
        self.a = torch.zeros((1, B), dtype=acc, device=device)
        self.c = torch.zeros((1, B), dtype=dtype, device=device)
        self.out = torch.zeros((1, B), dtype=acc, device=device)

        Q, g, a, c, out = self.Q, self.g, self.a, self.c, self.out

        # fn holds the buffers, not self: a cycle through self would leave
        # this graph to the cyclic collector, which can free it while a
        # later conquer captures its own graph, and that ends the capture
        def fn():
            out.copy_(S._solve_small_qp(Q, g, a, c, sweeps))
        self.step = S._Stepper(fn, device, device.type == "cuda",
                               capture_mode="thread_local")

    def __call__(self, Qbb, gb, ab, cb) -> torch.Tensor:
        for buf, v in ((self.Q, Qbb), (self.g, gb), (self.a, ab),
                       (self.c, cb)):
            buf[0].copy_(v)
        self.step()
        return self.out[0].clone()


def _pad(t: torch.Tensor, pad: int, value) -> torch.Tensor:
    return torch.cat([t, t.new_full((pad,) + tuple(t.shape[1:]), value)])


def conquer_step(mesh, axis: str, cfg: ConquerConfig, X, s, alpha0, p=-1.0,
                 c=None, valid=None,
                 counters: Optional[Dict[str, torch.Tensor]] = None):
    """Distributed conquer on the whole box dual, warm-started.

    ``X``: (n, d) dual points, ``s``/``alpha0``: (n,) sign vector and warm
    start, any n: the rows are padded with inert coordinates (c = 0,
    never selected) to a multiple of the axis size and the first n
    returned.  ``p`` and ``c`` are scalars or (n,) vectors; ``valid``
    masks coordinates out of selection.  Returns ``(alpha, rounds,
    pg_max)`` on the mesh's device: ``rounds`` the communication rounds,
    ``pg_max`` the projected-gradient residual at the returned alpha.
    With ``cfg.trace_cap > 0`` one sample a round (the round's pg, the
    objective and free-set size after it, γ*, the rows the cache served)
    goes into a device ring, returned fourth (``ConvTrace``; the same on
    every rank).  ``counters`` (a dict), with the cache on, receives its
    ``cache_hits``, ``cache_misses`` and ``cache_evictions`` (rows, device
    scalars)."""
    if cfg.mode not in ("parallel", "replicated"):
        raise ValueError(f"unknown conquer mode {cfg.mode!r} "
                         f"(expected 'parallel' or 'replicated')")
    kernel = cfg.kernel
    dev = mesh.device
    use_kernels = resolve_use_kernels(cfg.use_kernels, dev)
    cdt = cfg.compute_dtype
    P_ = mesh.shape[axis]
    me = mesh.rank
    X = as_tensor(X, dev)
    n0, d = X.shape
    dtype = X.dtype
    acc = torch.promote_types(dtype, torch.float32)
    s = as_tensor(s, dev, dtype)
    alpha0 = as_tensor(alpha0, dev, dtype)
    cvec = torch.as_tensor(cfg.C if c is None else c, dtype=dtype,
                           device=dev).broadcast_to((n0,))
    pvec = torch.as_tensor(p, dtype=dtype, device=dev).broadcast_to((n0,))
    vvec = (torch.ones(n0, dtype=torch.bool, device=dev) if valid is None
            else as_tensor(valid, dev, torch.bool))

    # ---- pad to a multiple of the rank count with inert coordinates -----
    pad = (-n0) % P_
    if pad:
        X, s, alpha0 = _pad(X, pad, 0.0), _pad(s, pad, 1.0), \
            _pad(alpha0, pad, 0.0)
        cvec, pvec = _pad(cvec, pad, 0.0), _pad(pvec, pad, 0.0)
        vvec = _pad(vvec, pad, False)
    n = n0 + pad
    n_l = n // P_
    B = max(1, min(cfg.block, n_l))
    cache_cap = 0 if cfg.mode != "parallel" else cfg.cache_cap
    if cache_cap > 0:
        cache_cap = max(cache_cap, P_ * B)   # insert needs one full block

    mine = slice(me * n_l, (me + 1) * n_l)
    X = X.contiguous()
    Xl = X[mine]
    sl, pl, cl, vl = (t[mine].contiguous() for t in (s, pvec, cvec, vvec))
    al = alpha0[mine].clone()
    if use_kernels:
        from repro_torch.kernels import ops

    def pairwise(A, Bm):
        return kernel.pairwise(A, Bm, compute_dtype=cdt)

    # what the kernels read: the rows packed once under a bf16 policy (as
    # GramOperator.prepare), else the rows themselves
    packed = use_kernels and resolve_compute_dtype(cdt, dtype) is not None
    Xk = ops.pack_bf16(X) if packed else X
    Xlk = Xk.index(mine) if packed else Xl

    def cross_matvec(w):
        """K(X_l, X) @ w without the (n_l, n) block."""
        if use_kernels:
            return ops.kernel_matvec(Xlk, Xk, w.contiguous(), kernel,
                                     compute_dtype=cdt)
        chunks = max(1, min(cfg.grad_chunks, n_l))
        rows = -(-n_l // chunks)
        return torch.cat([pairwise(Xl[i:i + rows], X).to(w.dtype) @ w
                          for i in range(0, n_l, rows)])

    # ---- initial local gradient: g_l = Q[l, :] @ alpha + p ---------------
    g = (sl * cross_matvec(s * alpha0)).to(acc) + pl.to(acc)

    def scores_of():
        # pads (and caller-invalidated rows) never enter selection
        return torch.abs(torch.where(vl, proj_grad(al, g, cl), 0.0))

    def qdelta(Xsel, ssel, w):
        """(QΔ) on the local rows: s_l ∘ (K(X_l, X_sel) @ w), the rank-PB
        skinny product (the fused ``cd_column_update`` with kernels)."""
        if use_kernels:
            return ops.cd_column_update(Xlk, sl, Xsel, w.contiguous(), kernel,
                                        compute_dtype=cdt).to(acc)
        return (sl * (pairwise(Xl, Xsel).to(w.dtype) @ w)).to(acc)

    def q_rows_local(Xsel, ssel, skip):
        """(PB, n_l) Q-row slices of the selected block against the local
        shard, the cache-refill unit (``kermat``'s row form, which returns
        at once on the device flag ``skip``)."""
        if use_kernels:
            return ops.q_rows(Xlk, sl, Xsel, ssel, kernel, compute_dtype=cdt,
                              skip=skip).to(acc)
        return ((ssel[:, None] * sl[None, :])
                * pairwise(Xsel, Xl)).to(acc)

    sub = _SubSolve(B, cfg.sweeps, acc, dtype, dev)

    def propose():
        """One CE-PBM proposal: the local top-B block, its B x B solve, one
        all-gather of the P blocks, the combination step size, the snap,
        and the all-gather of the applied steps."""
        sc_ = scores_of()
        ib = S._top_block(sc_, B)
        Xb, sb, ab, gb, cb = Xl[ib], sl[ib], al[ib], g[ib], cl[ib]
        ab_acc = ab.to(acc)
        Qbb = ((sb[:, None] * sb[None, :]) * pairwise(Xb, Xb)).to(acc)
        target = sub(Qbb, gb, ab_acc, cb)
        delta = target - ab_acc
        gTd_l = torch.dot(gb.to(acc), delta)
        own = torch.stack([gTd_l, torch.max(sc_)]).expand(B, 2)
        gath = mesh.all_gather(torch.cat(
            [Xb.to(acc), sb.to(acc)[:, None], delta[:, None], own], 1))
        Xsel = gath[..., :d].reshape(P_ * B, d).to(dtype).contiguous()
        ssel = gath[..., d].reshape(-1).to(dtype)
        dsel = gath[..., d + 1].reshape(-1)
        gTd = torch.sum(gath[:, 0, d + 2])      # the reference's psum
        pg = torch.max(gath[:, 0, d + 3])        # and its pmax
        Qsel = ((ssel[:, None] * ssel[None, :])
                * pairwise(Xsel, Xsel)).to(acc)
        dQd = torch.dot(dsel, Qsel @ dsel)
        gamma = combination_step_size(gTd, dQd)
        a_new = (ab_acc + gamma * delta).to(dtype)
        eps = (0.1 * cfg.tol * (1.0 + cb)).to(dtype)
        a_new = torch.where((target <= 0.0) & (a_new <= eps), 0.0, a_new)
        a_new = torch.where((target >= cb.to(acc)) & (a_new >= cb - eps),
                            cb, a_new)
        applied = a_new.to(acc) - ab_acc
        asel = mesh.all_gather(applied).reshape(-1)
        return ib, ab, a_new, Xsel, ssel, asel, pg, gamma

    tcap = cfg.trace_cap
    tr = trace_init(tcap, device=dev) if tcap > 0 else None
    it = torch.zeros((), dtype=torch.int64, device=dev)
    pg_state = mesh.pmax(torch.max(scores_of()))
    running = (pg_state > cfg.tol) & (it < cfg.max_iters)

    def finish_round(pg, gamma=None, cache_hits=None):
        """The loop state after a round, and its trace sample (post-update
        objective and free-set size, summed over ranks)."""
        pg_state.copy_(torch.where(running, pg, pg_state))
        it.add_(running)
        if tr is not None:
            alc = al.to(acc)
            local = torch.stack([
                0.5 * torch.dot(alc, g) + 0.5 * torch.dot(pl.to(acc), alc),
                torch.sum((al > 0.0) & (al < cl) & vl).to(acc)])
            tot = mesh.psum(local)
            trace_record(tr, pg_max=pg, objective=tot[0], n_free=tot[1],
                         gamma=gamma, cache_hits=cache_hits, where=running)
        running.logical_and_((pg_state > cfg.tol) & (it < cfg.max_iters))

    cache = None
    if cfg.mode == "parallel" and cache_cap == 0:
        def round_():
            ib, ab, a_new, Xsel, ssel, asel, pg, gamma = propose()
            g.copy_(torch.where(running, g + qdelta(Xsel, ssel, ssel * asel),
                                g))
            al[ib] = torch.where(running, a_new, ab)
            finish_round(pg, gamma)

    elif cfg.mode == "parallel":
        # cached Q-row slices store in the policy dtype: a bf16 policy fits
        # twice the rows of f32 under the same byte budget
        store = as_dtype(cdt) if cdt is not None else acc
        cache = colcache.init(cache_cap, n, dtype=store, width=n_l,
                              device=dev)
        offsets = torch.arange(P_, device=dev)[:, None] * n_l

        def round_():
            ib, ab, a_new, Xsel, ssel, asel, pg, gamma = propose()
            gidx = (offsets + mesh.all_gather(ib)).reshape(-1)
            hits0 = cache.hits.clone()
            slots, hit = colcache.lookup(cache, gidx)
            served = torch.all(hit)
            # both sides as device work, torch.where selecting (the
            # reference branches with lax.cond): kermat's row form skips
            # its work when the cache serves the block
            gathered = cache.cols[torch.where(hit, slots, 0)].to(acc)
            Qrows = torch.where(served, gathered,
                                q_rows_local(Xsel, ssel, served))
            colcache.assign_(cache, colcache.update(
                cache, gidx, Qrows, served, slots, hit, active=running))
            g.copy_(torch.where(running, g + asel @ Qrows, g))
            al[ib] = torch.where(running, a_new, ab)
            finish_round(pg, gamma, cache.hits - hits0)

    else:   # replicated: the exact global top-B baseline
        ext = torch.empty(n_l + 1, dtype=dtype, device=dev)

        def round_():
            sc_ = scores_of()
            ib = S._top_block(sc_, B)                   # local candidates
            cand = torch.cat([Xl[ib].to(acc), sc_[ib][:, None],
                              g[ib][:, None], al[ib].to(acc)[:, None],
                              sl[ib].to(acc)[:, None],
                              cl[ib].to(acc)[:, None]], 1)
            gath = mesh.all_gather(cand).reshape(P_ * B, d + 5)
            flat = gath[:, d]
            sel = S._top_block(flat, B)                 # the global top-B
            xb = gath[sel, :d].to(dtype).contiguous()
            gb, ab = gath[sel, d + 1], gath[sel, d + 2].to(dtype)
            yb, cb = gath[sel, d + 3].to(dtype), gath[sel, d + 4].to(dtype)
            owner = sel // B
            lidx = mesh.all_gather(ib).reshape(-1)[sel]
            Qbb = ((yb[:, None] * yb[None, :])
                   * kernel.pairwise(xb, xb)).to(acc)
            new_ab = sub(Qbb, gb, ab.to(acc), cb)
            delta = (new_ab - ab).to(acc)
            g.copy_(torch.where(running, g + qdelta(xb, yb, yb * delta), g))
            # only the owner adds the step: the others' land on a spare
            # slot past the shard
            ext[:n_l] = al
            ext.index_add_(0, torch.where((owner == me) & running, lidx, n_l),
                           delta.to(dtype))
            al.copy_(ext[:n_l])
            # the largest gathered score is every rank's largest local one
            finish_round(torch.max(flat))

    for step in range(cfg.max_iters):
        if step % SYNC_EVERY == 0 and not bool(running):
            break
        round_()

    # residual at the RETURNED alpha, not the pre-update stopping value
    pg_exit = mesh.pmax(torch.max(scores_of()))
    if counters is not None and cache is not None:
        counters.update(cache_hits=cache.hits, cache_misses=cache.misses,
                        cache_evictions=cache.evictions)
    alpha = mesh.all_gather(al).reshape(n)[:n0]
    if tr is not None:
        return alpha, it, pg_exit, tr
    return alpha, it, pg_exit


# ---------------------------------------------------------------------------
# the distributed DC-SVM driver
# ---------------------------------------------------------------------------

def _seeded_draws(seed: int):
    """``(draws, sv_draws)`` from one generator seeded with ``seed``: a
    level's k-means sample and init permutation as ``fit`` draws them, and
    the adaptive sample with the reference's rule (every SV first in
    random order, a random non-SV fill)."""
    gen = torch.Generator().manual_seed(seed)

    def draws(level, n, m_sample):
        return (torch.randperm(n, generator=gen)[:m_sample].numpy(),
                torch.randperm(m_sample, generator=gen).numpy())

    def sv_draws(level, sv_mask, m):
        u = torch.rand(sv_mask.shape[0], generator=gen,
                       dtype=torch.float64).to(sv_mask.device)
        return S._top_block(torch.where(sv_mask, 1.0 + u, u), m)

    return draws, sv_draws


def fit_distributed(cfg, mesh, axis: str, X, y=None,
                    task: Optional[Task] = None, conquer_block: int = 64,
                    conquer_iters: int = 5_000, mode: str = "parallel",
                    cache_cap: int = 0, draws: Optional[Draws] = None,
                    sv_draws: Optional[SvDraws] = None,
                    dtype: torch.dtype = torch.float32):
    """Multilevel DC-SVM with every level's cluster solves sharded over
    ``axis`` and the final conquer running parallel block minimisation.

    ``cfg`` is a ``core.dcsvm.DCSVMConfig``; ``task`` any single-row task
    of the box family (C-SVC default, WeightedCSVC, EpsilonSVR).  Cluster
    counts are rounded up to a multiple of the axis size, so every rank
    gets equal work; any n works (the conquer pads).  Between levels the
    support-vector mass stays on the device.  ``draws(level, n, m)`` gives
    a level's k-means sample and init permutation (``core.dcsvm.Draws``),
    ``sv_draws(level, sv_mask, m)`` its adaptive sample; both default to a
    generator seeded with ``cfg.seed``.  ``X`` and ``y`` go to the mesh's
    device in ``dtype``.  Returns ``(alpha (n_dual,), stats list)``."""
    task = resolve_task(task)
    dev = mesh.device
    X = as_tensor(X, dev, dtype).contiguous()
    n = X.shape[0]
    if y is None:
        if not task.label_free:
            raise ValueError(f"task {task.name!r} requires labels y")
        y = torch.zeros(n, dtype=X.dtype, device=dev)
    y = as_tensor(y, dev, X.dtype)
    td = task.build(X, y[None, :], cfg.C)
    if td.has_equality:
        raise NotImplementedError(
            f"distributed fit covers the box dual family (svc / "
            f"weighted-svc / svr); task {task.name!r} carries an equality "
            f"constraint -- use core.dcsvm.fit")
    if td.n_rows != 1:
        raise ValueError("distributed fit is single-row (binary labels or "
                         f"regression); got n_rows={td.n_rows}")
    nd = td.n_dual
    base_index = np.asarray(td.base_index)
    bidx = torch.as_tensor(base_index, device=dev)
    s1, p1, c1 = td.S[0], td.P[0], td.Cvec[0]
    use_kernels = resolve_use_kernels(cfg.use_kernels, dev)
    P_ = mesh.shape[axis]
    seeded = _seeded_draws(cfg.seed)
    draws = draws or seeded[0]
    sv_draws = sv_draws or seeded[1]
    alpha = torch.zeros(nd, dtype=X.dtype, device=dev)
    sv_base = None            # (n,) SV mass a base point, on the device
    stats = []

    for l in range(cfg.levels, 0, -1):
        kl = max(cfg.k ** l, P_)
        kl = -(-kl // P_) * P_          # a multiple of the rank count
        if kl >= n // 2:
            continue
        m = min(cfg.m, n)
        sample_idx, init_perm = draws(l, n, m)
        if cfg.adaptive and sv_base is not None:
            # m indices to the host, as the k-means step takes its sample
            sample_idx = torch.as_tensor(sv_draws(l, sv_base > 0, m)
                                         ).cpu().numpy()
        with span(f"divide/level{l}/cluster"):
            part = two_step_kernel_kmeans(cfg.kernel, X, kl, m=cfg.m,
                                          iters=cfg.kmeans_iters,
                                          sample_idx=sample_idx,
                                          balanced=True,
                                          use_kernels=use_kernels,
                                          init_perm=init_perm)
            # the ranks cluster alike; rank 0's partition makes it certain
            assign = mesh.broadcast(torch.as_tensor(part.assign,
                                                    dtype=torch.int64,
                                                    device=dev))
            part = Partition.build(assign.cpu().numpy().astype(np.int32),
                                   kl, part.model)
        # the base partition expanded to dual coordinates (SVR's mirrored
        # pair of a sample shares its cluster)
        dpart = part if nd == n else Partition.build(
            part.assign[base_index].astype(np.int32), kl, part.model)
        mask = torch.as_tensor(dpart.mask, device=dev)
        ac = torch.where(mask, dpart.gather(alpha), 0.0)
        with span(f"divide/level{l}/solve"):
            ac = divide_step(mesh, axis, cfg, dpart.gather(td.Xd),
                             dpart.gather(s1), dpart.gather(p1),
                             dpart.gather(c1), ac, mask)
            alpha = dpart.scatter(ac, nd)
        # the box family keeps alpha >= 0: mass > 0 <=> some SV
        sv_base = torch.zeros(n, dtype=X.dtype,
                              device=dev).index_add_(0, bidx, alpha)
        stats.append(dict(level=l, clusters=kl,
                          n_sv=torch.sum(sv_base > 0)))

    trace_cap = cfg.trace or 0
    ccfg = ConquerConfig(kernel=cfg.kernel, C=cfg.C, tol=cfg.tol,
                         max_iters=conquer_iters, block=conquer_block,
                         sweeps=cfg.sweeps, mode=mode,
                         use_kernels=cfg.use_kernels, cache_cap=cache_cap,
                         compute_dtype=cfg.compute_dtype,
                         trace_cap=trace_cap)
    with span("conquer/distributed"):
        out = conquer_step(mesh, axis, ccfg, td.Xd, s1, alpha, p=p1, c=c1)
        alpha, rounds, pg = out[:3]
    sv_base = torch.zeros(n, dtype=X.dtype,
                          device=dev).index_add_(0, bidx, alpha)
    st0 = dict(level=0, rounds=rounds, pg_max=pg,
               n_sv=torch.sum(sv_base > 0))
    if trace_cap > 0:
        # the one device-to-host copy of the round trace
        st0["trace"] = trace_fetch(out[3])
        st0["trace_summary"] = trace_summary(st0["trace"])
    stats.append(st0)
    return alpha, _finalize_stats(stats)


def _finalize_stats(stats):
    """One host read at the end: the device scalars to Python numbers."""
    out = []
    for st in stats:
        fin = {}
        for k2, v in st.items():
            if isinstance(v, torch.Tensor):
                v = v.item()
                v = int(v) if float(v).is_integer() else float(v)
            fin[k2] = v
        out.append(fin)
    return out


def fit_distributed_model(cfg, mesh, axis: str, X, y=None,
                          task: Optional[Task] = None,
                          dtype: torch.dtype = torch.float32, **kw):
    """``fit_distributed`` as a ``DCSVMModel`` (beta collapsed over the base
    points), so the prediction and serving paths take it as they are."""
    from repro_torch.core.dcsvm import DCSVMModel

    task = resolve_task(task)
    X = as_tensor(X, mesh.device, dtype).contiguous()
    y = (torch.zeros(X.shape[0], dtype=X.dtype, device=X.device) if y is None
         else as_tensor(y, X.device, X.dtype))
    alpha, stats = fit_distributed(cfg, mesh, axis, X, y, task=task,
                                   dtype=dtype, **kw)
    td = task.build(X, y[None, :], cfg.C)
    beta = td.collapse(alpha[None, :])[0]
    return DCSVMModel(cfg, X, y, alpha, None, False, stats, task=task,
                      beta=beta)


__all__ = ["ConquerConfig", "SvDraws", "conquer_step", "divide_step",
           "fit_distributed", "fit_distributed_model"]
