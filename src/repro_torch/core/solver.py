"""QP solvers of the two dual families (port of ``repro.core.solver``).

    min_u  f(u) = 1/2 u' Q u + p' u     s.t.  0 <= u <= c   [, a'u = d]

with per-coordinate ``p`` and ``c`` (scalars broadcast).  Single-coordinate
updates are exact in closed form: ``u_i <- clip(u_i - g_i / Q_ii, 0, c_i)``
with ``g = Q u + p``.

* ``solve_box_qp``        -- greedy (Gauss-Southwell) CD, the paper's solver.
* ``solve_box_qp_block``  -- top-B greedy block CD with a cyclic B x B
                             sub-solve and a rank-B gradient update.
* ``solve_box_qp_matvec`` -- block CD with kernel columns computed on the
                             fly (``solve_box_qp_op`` over a GramOperator);
                             never materialises Q.
* ``solve_with_shrinking`` -- LIBSVM-style outer shrinking rounds.

The equality family (one-class SVM, nu-SVC; one constraint a problem, or
one a coordinate group) moves maximal violating pairs along
e_i/a_i - e_j/a_j, which keeps every a'u: ``solve_eq_qp`` (pairwise),
``solve_eq_qp_block`` (B pairs a step, a coupled 2B x 2B sub-QP),
``solve_eq_qp_shrink`` and ``solve_eq_qp_matvec`` (Gram-free).  On a CUDA
device each of their steps, and level 0's iteration, replays as a CUDA
graph (``_Stepper``).

The dense solvers take a leading batch of independent problems, the
counterpart of the reference's ``vmap`` over ``lax.while_loop``: the whole
batch stays on the device, a per-problem ``running`` mask freezes the
problems that have stopped (``torch.where``), and the host reads the mask
only every ``SYNC_EVERY`` steps.  Each problem's ``iters`` is therefore the
count the reference's own loop gives.  Top-B selection is a stable
descending sort, so ties go to the lower index as in ``lax.top_k``.

Every solver takes ``trace`` (an ``obs.trace.ConvTrace``, or ``None``)
where the reference does, records one sample an (outer) iteration of a
running problem into it on the device, inside the CUDA graphs too, and
returns it on ``SolveResult.trace``; with ``trace=None`` it makes no ring
tensor and runs no extra op.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import colcache, gramop
from repro_torch.core.kernels import Kernel
from repro_torch.obs.trace import ConvTrace, trace_batch, trace_record

# Steps between host reads of the running mask (the only host syncs of the
# solver loops).  A stopped problem is frozen on the device at once, so the
# value bounds only the wasted steps after the last problem stops.
SYNC_EVERY = 64


class SolveResult(NamedTuple):
    alpha: torch.Tensor
    grad: torch.Tensor      # g = Q a + p at the returned alpha
    iters: torch.Tensor     # outer iterations executed, per problem
    pg_max: torch.Tensor    # final max |projected gradient|, per problem
    cache_hits: Optional[torch.Tensor] = None       # column-cache rows served
    cache_misses: Optional[torch.Tensor] = None     # rows recomputed
    cache_evictions: Optional[torch.Tensor] = None  # live rows/panels displaced
    spills: Optional[torch.Tensor] = None       # panels written to the host tier
    spill_hits: Optional[torch.Tensor] = None   # panels re-loaded from it
    trace: Optional[ConvTrace] = None           # convergence ring (obs.trace)


def _broadcast(v, shape, like: torch.Tensor) -> torch.Tensor:
    """Scalar-or-tensor parameter -> a tensor of ``shape`` (copied)."""
    t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return t.broadcast_to(shape).clone()


def _mv(Q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (Q @ v[..., None])[..., 0]


def objective(alpha: torch.Tensor, grad: torch.Tensor, p=-1.0) -> torch.Tensor:
    """f(u) = 1/2 u'g + 1/2 p'u from the maintained gradient g = Qu + p."""
    pu = torch.sum(torch.as_tensor(p, dtype=alpha.dtype, device=alpha.device)
                   * alpha, dim=-1)
    return 0.5 * torch.sum(alpha * grad, dim=-1) + 0.5 * pu


def _n_free(alpha: torch.Tensor, cvec: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Free-set size (strictly interior coordinates) a problem, for the
    trace."""
    free = (alpha > 0.0) & (alpha < cvec)
    if mask is not None:
        free &= mask
    return torch.sum(free, dim=-1)


def _trace_for(trace: Optional[ConvTrace], lead: tuple, device
               ) -> Optional[ConvTrace]:
    return None if trace is None else trace_batch(trace, lead, device)


def proj_grad(alpha: torch.Tensor, grad: torch.Tensor, C) -> torch.Tensor:
    """Projected gradient of the box QP (the KKT residual)."""
    pg = torch.where(alpha <= 0.0, torch.clamp(grad, max=0.0), grad)
    return torch.where(alpha >= C, torch.clamp(grad, min=0.0), pg)


def kkt_residual(Q: torch.Tensor, alpha: torch.Tensor, C, p=-1.0
                 ) -> torch.Tensor:
    g = _mv(Q, alpha) + torch.as_tensor(p, dtype=alpha.dtype,
                                        device=alpha.device)
    return torch.amax(torch.abs(proj_grad(alpha, g, C)), dim=-1)


def combination_step_size(gTd: torch.Tensor, dQd: torch.Tensor
                          ) -> torch.Tensor:
    """CE-PBM's combined step size (Hsieh, Si & Dhillon 2016; the
    distributed conquer, ``core.distributed``): the exact line search of the
    dual quadratic along the sum Δ of the P block proposals,

        γ* = argmin_γ f(α + γΔ) = -g'Δ / Δ'QΔ,   clipped to [0, 1],

    and 1 where Δ'QΔ <= 0 (for a PSD Q only where Δ vanishes, a no-op).  The
    blocks touch disjoint coordinates and α, α + Δ are both feasible, so
    every γ in [0, 1] is; each block solve decreases its own sub-model, so
    g'Δ <= 0 and the unclipped γ* is not negative.  Takes the two reduced
    scalars, so the distributed caller sums them over ranks instead of
    gathering gradients."""
    pos = dQd > 0.0
    gamma = torch.where(pos, -gTd / torch.where(pos, dQd, 1.0), 1.0)
    return torch.clamp(gamma, 0.0, 1.0)


def _top_block(scores: torch.Tensor, block: int) -> torch.Tensor:
    """Indices of the ``block`` largest scores per row, ties to the lower
    index (the order of ``lax.top_k``)."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :block]


class _Batch(NamedTuple):
    Q: torch.Tensor        # (b, n, n)
    alpha: torch.Tensor    # (b, n), a fresh copy
    cvec: torch.Tensor
    pvec: torch.Tensor
    mask: torch.Tensor
    lead: tuple


def _batch(Q, C, alpha0, active_mask, p) -> _Batch:
    n = Q.shape[-1]
    lead = tuple(Q.shape[:-2])
    shape = lead + (n,)
    Qb = Q.reshape(-1, n, n)
    b = Qb.shape[0]
    alpha = (torch.zeros(shape, dtype=Q.dtype, device=Q.device)
             if alpha0 is None else _broadcast(alpha0, shape, Q))
    mask = (torch.ones(shape, dtype=torch.bool, device=Q.device)
            if active_mask is None
            else torch.as_tensor(active_mask, device=Q.device).broadcast_to(shape))
    return _Batch(Qb, alpha.reshape(b, n), _broadcast(C, shape, Q).reshape(b, n),
                  _broadcast(p, shape, Q).reshape(b, n), mask.reshape(b, n), lead)


def _result(bt: _Batch, alpha, g, it, pg_max, tr=None) -> SolveResult:
    n = alpha.shape[-1]
    return SolveResult(alpha.reshape(bt.lead + (n,)), g.reshape(bt.lead + (n,)),
                       it.reshape(bt.lead), pg_max.reshape(bt.lead), trace=tr)


def _masked_pg(alpha, g, cvec, mask):
    return torch.where(mask, proj_grad(alpha, g, cvec), 0.0)


def solve_box_qp(Q: torch.Tensor, C, alpha0: Optional[torch.Tensor] = None,
                 tol: float = 1e-3, max_iters: int = 10_000,
                 active_mask: Optional[torch.Tensor] = None, p=-1.0,
                 trace: Optional[ConvTrace] = None) -> SolveResult:
    """Greedy coordinate descent on a dense Q of shape (..., n, n).

    ``active_mask`` freezes coordinates (shrinking, pad slots): masked-out
    coordinates are never selected and count as 0 for stopping.  ``trace``
    records (pg_max, objective, n_free) of the iterate before each update,
    as the stopping value."""
    bt = _batch(Q, C, alpha0, active_mask, p)
    tr = _trace_for(trace, bt.lead, Q.device)
    Qb, alpha, cvec, mask = bt.Q, bt.alpha, bt.cvec, bt.mask
    b, n = alpha.shape
    rows = torch.arange(b, device=Q.device)
    zero = torch.zeros(b, dtype=Q.dtype, device=Q.device)
    diag = torch.clamp(torch.diagonal(Qb, dim1=-2, dim2=-1), min=1e-12)
    g = _mv(Qb, alpha) + bt.pvec
    # one priming evaluation so a problem at its optimum stops at once
    pg_max = torch.amax(torch.abs(_masked_pg(alpha, g, cvec, mask)), dim=-1)
    it = torch.zeros(b, dtype=torch.int64, device=Q.device)
    running = (pg_max > tol) & (it < max_iters)
    for step in range(max_iters):
        if step % SYNC_EVERY == 0 and not bool(running.any()):
            break
        sc = torch.abs(_masked_pg(alpha, g, cvec, mask))
        step_max, i = torch.max(sc, dim=-1)
        if tr is not None:
            trace_record(tr, pg_max=step_max,
                         objective=objective(alpha, g, bt.pvec),
                         n_free=_n_free(alpha, cvec, mask), where=running)
        i1 = i[:, None]
        ai = alpha.gather(-1, i1)[:, 0]
        # clip(a_i - g_i / Q_ii, 0, c_i), with a - q computed as a + (-1) q
        new_ai = torch.clamp(torch.addcdiv(ai, g.gather(-1, i1)[:, 0],
                                           diag.gather(-1, i1)[:, 0],
                                           value=-1.0),
                             min=zero, max=cvec.gather(-1, i1)[:, 0])
        new_ai = torch.where(running, new_ai, ai)
        alpha.scatter_(-1, i1, new_ai[:, None])
        # row i of the symmetric Q: one contiguous read instead of a
        # strided column
        g.addcmul_((new_ai - ai)[:, None], Qb[rows, i])
        pg_max = torch.where(running, step_max, pg_max)
        it += running
        running &= (pg_max > tol) & (it < max_iters)
    return _result(bt, alpha, g, it, pg_max, tr)


def _solve_small_qp(Qbb: torch.Tensor, gb: torch.Tensor, ab: torch.Tensor,
                    cb: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Cyclic CD on a batch of B x B subproblems: Qbb (b, B, B), gb/ab/cb
    (b, B).  ``gb`` is the gradient at entry, maintained locally.  Returns
    the new a_b.  ``sweeps * B`` sequential scalar steps (launch-bound in
    eager PyTorch)."""
    B = Qbb.shape[-1]
    diag = torch.clamp(torch.diagonal(Qbb, dim1=-2, dim2=-1), min=1e-12)
    a, g = ab.clone(), gb.clone()
    zero = torch.zeros_like(a[:, 0])
    # per-coordinate views made once: a step is then five launches
    a_j, g_j, d_j, c_j = a.unbind(1), g.unbind(1), diag.unbind(1), cb.unbind(1)
    q_j = [col[:, :, None] for col in Qbb.unbind(2)]          # Qbb[:, :, j]
    gcol = g[:, :, None]
    for t in range(sweeps * B):
        j = t % B
        # clip(a_j - g_j / Q_jj, 0, c_j), with a - q computed as a + (-1) q
        new_aj = torch.clamp(torch.addcdiv(a_j[j], g_j[j], d_j[j], value=-1.0),
                             min=zero, max=c_j[j])
        delta = new_aj - a_j[j]
        a_j[j].copy_(new_aj)
        gcol.addcmul_(q_j[j], delta[:, None, None])
    return a


def solve_box_qp_block(Q: torch.Tensor, C, alpha0: Optional[torch.Tensor] = None,
                       tol: float = 1e-3, max_iters: int = 2_000,
                       block: int = 32, sweeps: int = 4,
                       active_mask: Optional[torch.Tensor] = None, p=-1.0,
                       trace: Optional[ConvTrace] = None) -> SolveResult:
    """Top-B greedy block CD on a dense Q of shape (..., n, n): each outer
    iteration moves the B coordinates of largest |projected gradient|.
    ``trace`` records a sample an outer iteration, before its update."""
    bt = _batch(Q, C, alpha0, active_mask, p)
    tr = _trace_for(trace, bt.lead, Q.device)
    Qb, alpha, cvec, mask = bt.Q, bt.alpha, bt.cvec, bt.mask
    b, n = alpha.shape
    if block > n:
        raise ValueError(f"block {block} larger than the problem size {n}")
    g = _mv(Qb, alpha) + bt.pvec
    pg_max = torch.amax(torch.abs(_masked_pg(alpha, g, cvec, mask)), dim=-1)
    it = torch.zeros(b, dtype=torch.int64, device=Q.device)
    running = (pg_max > tol) & (it < max_iters)
    for step in range(max_iters):
        if step % SYNC_EVERY == 0 and not bool(running.any()):
            break
        sc = torch.abs(_masked_pg(alpha, g, cvec, mask))
        idx = _top_block(sc, block)                                  # (b, B)
        step_max = sc.gather(-1, idx[:, :1])[:, 0]
        if tr is not None:
            trace_record(tr, pg_max=step_max,
                         objective=objective(alpha, g, bt.pvec),
                         n_free=_n_free(alpha, cvec, mask), where=running)
        Qrows = Qb.gather(1, idx[:, :, None].expand(b, block, n))   # Q[idx]
        Qbb = Qrows.gather(2, idx[:, None, :].expand(b, block, block))
        ab = alpha.gather(-1, idx)
        new_ab = _solve_small_qp(Qbb, g.gather(-1, idx), ab,
                                 cvec.gather(-1, idx), sweeps)
        delta = torch.where(running[:, None], new_ab - ab, 0.0)
        alpha.scatter_(-1, idx, torch.where(running[:, None], new_ab, ab))
        Qcols = Qb.gather(2, idx[:, None, :].expand(b, n, block))   # Q[:, idx]
        g = g + _mv(Qcols, delta)
        pg_max = torch.where(running, step_max, pg_max)
        it += running.long()
        running &= (pg_max > tol) & (it < max_iters)
    return _result(bt, alpha, g, it, pg_max, tr)


def solve_box_qp_matvec(X: torch.Tensor, y: torch.Tensor, kernel: Kernel, C,
                        alpha0: Optional[torch.Tensor] = None,
                        tol: float = 1e-3, max_iters: int = 500,
                        block: int = 64, sweeps: int = 4,
                        grad_chunks: int = 16, use_kernels: bool = False,
                        cache_cap: int = 0, p=-1.0, compute_dtype=None,
                        Xbase: Optional[torch.Tensor] = None,
                        base_index: Optional[torch.Tensor] = None,
                        trace: Optional[ConvTrace] = None) -> SolveResult:
    """Block greedy CD where the Q columns are recomputed from (X, y) at
    every step; ``y`` is the sign vector of Q = (y y') ∘ K.  With
    ``use_kernels`` the rank-B update is the fused ``cd_column_update``
    kernel and the initial gradient the streaming ``kernel_matvec``.
    ``cache_cap > 0`` keeps a device LRU of raw kernel rows
    (``core.colcache``, in the operator's storage dtype): a block whose
    rows are all cached is served from it, else its rows are recomputed
    (``kermat``) and inserted; the hit, miss and eviction row counts come
    back on the result.  ``compute_dtype`` is the operator's precision
    policy; ``Xbase``/``base_index`` (``X == Xbase[base_index]``) select
    the base-indexed view of ``gramop`` (SVR's mirrored rows); ``trace``
    as in ``solve_box_qp_op``."""
    op = gramop.GramOperator(Xd=X, s=y, Xb=Xbase, bidx=base_index,
                             kernel=kernel, use_kernels=use_kernels,
                             compute_dtype=compute_dtype)
    return solve_box_qp_op(op, C, alpha0=alpha0, tol=tol, max_iters=max_iters,
                           block=block, sweeps=sweeps, grad_chunks=grad_chunks,
                           cache_cap=cache_cap, p=p, trace=trace)


def _cached_rows(op: "gramop.GramOperator", cache: colcache.ColumnCache,
                 idx, running, acc):
    """Signed Q rows (B, n) of block ``idx`` through the column cache.
    Served (every row cached): gathered from the cache, and the ``kermat``
    launch returns at once on the device flag; else recomputed and
    inserted.  Both sides run as device work selected by ``torch.where``,
    so a CUDA graph replays it (the reference branches with ``lax.cond``)."""
    keys = op.cache_keys(idx)
    slots, hit = colcache.lookup(cache, keys)
    served = torch.all(hit)
    gathered = cache.cols[torch.where(hit, slots, 0)].to(acc)
    computed = op.kernel_rows(idx, skip=served).to(acc)
    kr = torch.where(served, gathered, computed)
    colcache.assign_(cache, colcache.update(cache, keys, kr, served, slots,
                                            hit, active=running))
    return op.expand_rows(kr, idx)


def _op_step(op: "gramop.GramOperator", alpha, g, cvec, pg_max, it, running,
             tol: float, max_iters: int, block: int, sweeps: int, acc,
             cache: Optional[colcache.ColumnCache] = None,
             tr: Optional[ConvTrace] = None, pvec=None):
    """One iteration of the level-0 block CD, in place on the state tensors
    (alpha, g, pg_max, it, running, the cache's and the trace's): what the
    CUDA graph captures and the eager loop runs.  With ``tr``, a running
    iteration records its pg_max and the objective and free-set size before
    its update (and, cached, the rows the cache served)."""
    sc = torch.abs(proj_grad(alpha, g, cvec))
    idx = _top_block(sc, block)
    step_max = sc.gather(0, idx[:1])[0]
    if tr is not None:
        obj, free = objective(alpha, g, pvec), _n_free(alpha, cvec)
        hits0 = None if cache is None else cache.hits.clone()
    ab = alpha[idx]
    if cache is not None:
        Qrows = _cached_rows(op, cache, idx, running, acc)   # (B, n) signed
        Qbb = Qrows[:, idx]
    elif op.use_kernels:
        # fused: the (n, B) column block never reaches device memory; only
        # the (B, B) working-set block is formed
        Qbb = op.qbb(idx).to(acc)
    else:
        Qb = op.q_block(idx).to(acc)            # (n, B) on the fly
        Qbb = Qb[idx]
    new_ab = _solve_small_qp(Qbb[None], g[idx][None], ab[None],
                             cvec[idx][None], sweeps)[0]
    delta = torch.where(running, new_ab - ab, 0.0)
    alpha[idx] = torch.where(running, new_ab, ab)
    if cache is not None:
        g.add_(delta @ Qrows)
    else:
        g.copy_(op.col_update(g, idx, delta) if op.use_kernels
                else g + Qb @ delta)
    pg_max.copy_(torch.where(running, step_max, pg_max))
    it += running
    if tr is not None:
        trace_record(tr, pg_max=step_max, objective=obj, n_free=free,
                     cache_hits=None if cache is None else cache.hits - hits0,
                     where=running)
    running &= (pg_max > tol) & (it < max_iters)


# Eager iterations before the capture of the graphed loop (on a side
# stream, as PyTorch asks of a capture's warm-up); they are real iterations.
GRAPH_WARMUP = 2


def _use_graph(graph: Optional[bool], device: torch.device) -> bool:
    """``None``: a CUDA graph on a CUDA device, the eager loop elsewhere;
    ``True`` off a CUDA device raises."""
    if graph is None:
        return device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError("a CUDA graph needs a CUDA device")
    return bool(graph)


class _Stepper:
    """Runs ``fn``, a solver step that updates static state tensors in
    place: eagerly, or (``graph``) ``GRAPH_WARMUP`` times eagerly on a side
    stream, as PyTorch asks of a capture's warm-up, then as the replay of
    one captured CUDA graph.  Every call is a real step, so a graphed loop
    gives the eager loop's results bit for bit.  Kernel launches inside
    the graph are counted once a replay (``ops.recording``).
    ``capture_mode`` is ``torch.cuda.graph``'s ``capture_error_mode``:
    "thread_local" where another thread of the process may call CUDA
    during the capture (the NCCL process group's watchdog)."""

    def __init__(self, fn, device: torch.device, graph: bool,
                 capture_mode: str = "global"):
        self.fn, self.device, self.graph = fn, device, graph
        self.capture_mode = capture_mode
        self.calls, self.cuda_graph, self.per_replay = 0, None, {}

    def __call__(self) -> None:
        if not self.graph:
            self.fn()
            return
        from repro_torch.kernels import ops

        if self.calls < GRAPH_WARMUP:
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self.fn()
            main.wait_stream(side)
        else:
            if self.cuda_graph is None:
                self.cuda_graph = torch.cuda.CUDAGraph()
                with ops.recording() as self.per_replay, \
                        torch.cuda.graph(
                            self.cuda_graph,
                            capture_error_mode=self.capture_mode):
                    self.fn()
            self.cuda_graph.replay()
            ops.add_launches(self.per_replay)
        self.calls += 1


def solve_box_qp_op(op: "gramop.GramOperator", C,
                    alpha0: Optional[torch.Tensor] = None, tol: float = 1e-3,
                    max_iters: int = 500, block: int = 64, sweeps: int = 4,
                    grad_chunks: int = 16, cache_cap: int = 0, p=-1.0,
                    graph: Optional[bool] = None,
                    trace: Optional[ConvTrace] = None) -> SolveResult:
    """The engine behind ``solve_box_qp_matvec``: block greedy CD against a
    ``GramOperator`` (one problem), with a column cache of
    ``max(cache_cap, block)`` rows when ``cache_cap > 0``.

    ``graph`` (default: on a CUDA device) captures one iteration into a
    CUDA graph after ``GRAPH_WARMUP`` eager ones and replays it
    (``_Stepper``); the state lives in static tensors and the host still
    reads ``running`` every ``SYNC_EVERY`` iterations, so the results equal
    the eager loop's bit for bit.  ``graph=False`` runs the eager loop (the
    CPU's); a failed capture raises.  ``trace`` records a sample an
    iteration (``_op_step``) inside the graph: its ring is made before the
    capture and updated in place."""
    X = op.Xd
    n = op.n_dual
    if block > n:
        raise ValueError(f"block {block} larger than the problem size {n}")
    graph = _use_graph(graph, X.device)
    acc = torch.promote_types(X.dtype, torch.float32)
    alpha = (torch.zeros(n, dtype=X.dtype, device=X.device) if alpha0 is None
             else _broadcast(alpha0, (n,), X))
    cvec = _broadcast(C, (n,), X)
    pvec = _broadcast(p, (n,), X)
    op.prepare()
    g = (op.matvec(alpha, num_chunks=grad_chunks) + pvec).to(acc)
    pg_max = torch.amax(torch.abs(proj_grad(alpha, g, cvec)))
    it = torch.zeros((), dtype=torch.int64, device=X.device)
    running = (pg_max > tol) & (it < max_iters)
    cache = None
    if cache_cap > 0:
        # must hold at least one full block
        cache = colcache.init(max(cache_cap, block), op.kwidth,
                              dtype=op.storage_dtype(acc), device=X.device)
    tr = _trace_for(trace, (), X.device)
    step = _Stepper(lambda: _op_step(op, alpha, g, cvec, pg_max, it, running,
                                     tol, max_iters, block, sweeps, acc,
                                     cache, tr, pvec), X.device, graph)
    for k in range(max_iters):
        if k % SYNC_EVERY == 0 and not bool(running):
            break
        step()
    if cache is None:
        return SolveResult(alpha, g, it, pg_max, trace=tr)
    return SolveResult(alpha, g, it, pg_max, cache.hits, cache.misses,
                       cache_evictions=cache.evictions, trace=tr)


def solve_with_shrinking(Q: torch.Tensor, C,
                         alpha0: Optional[torch.Tensor] = None,
                         tol: float = 1e-3, max_iters: int = 10_000,
                         rounds: int = 3, shrink_margin: float = 10.0,
                         block: int = 0, p=-1.0,
                         trace: Optional[ConvTrace] = None) -> SolveResult:
    """Outer shrinking rounds around the CD solver (dense Q, batchable).

    Each round solves on the active set to ``tol``; variables pinned at a
    bound with |g| > shrink_margin * tol leave the active set for the next
    round; the final round re-activates everything.  ``pg_max`` is
    recomputed at the returned alpha on the full problem.  One ``trace``
    ring records through every round."""
    if rounds < 1:
        raise ValueError(f"shrinking needs rounds >= 1, got {rounds}")
    n = Q.shape[-1]
    shape = tuple(Q.shape[:-2]) + (n,)
    alpha = (torch.zeros(shape, dtype=Q.dtype, device=Q.device)
             if alpha0 is None else _broadcast(alpha0, shape, Q))
    cvec = _broadcast(C, shape, Q)
    mask = torch.ones(shape, dtype=torch.bool, device=Q.device)
    total = torch.zeros(shape[:-1], dtype=torch.int64, device=Q.device)
    res, tr = None, trace
    for r in range(rounds):
        m = torch.ones_like(mask) if r == rounds - 1 else mask
        if block <= 0:
            res = solve_box_qp(Q, C, alpha0=alpha, tol=tol,
                               max_iters=max_iters, active_mask=m, p=p,
                               trace=tr)
        else:
            res = solve_box_qp_block(Q, C, alpha0=alpha, tol=tol,
                                     max_iters=max_iters, block=block,
                                     active_mask=m, p=p, trace=tr)
        tr = res.trace
        alpha, g = res.alpha, res.grad
        total = total + res.iters
        strongly_lo = (alpha <= 0.0) & (g > shrink_margin * tol)
        strongly_hi = (alpha >= cvec) & (g < -shrink_margin * tol)
        mask = ~(strongly_lo | strongly_hi)
    pg_full = kkt_residual(Q, res.alpha, cvec, p=p)
    return SolveResult(res.alpha, res.grad, total, pg_full, trace=tr)


# ---------------------------------------------------------------------------
# Equality-constrained dual: pairwise (SMO-style) maximal-violating-pair CD
#
#     min 1/2 u'Qu + p'u   s.t.  0 <= u <= c,  sum_{i in g} a_i u_i = d_g
#
# KKT: per group g a multiplier rho_g with h_i = g_i / a_i equal to rho_g on
# free coordinates and one-sided at the bounds; optimality <=> every
# group's bracket [rho_lo, rho_hi] is non-empty.  A step moves the maximal
# violating pair (i = argmin of the upper bounds, j = argmax of the lower
# bounds, within the group of the widest gap) to the exact minimiser along
# e_i/a_i - e_j/a_j, which keeps every a'u.  All functions take a leading
# batch of independent problems, as the reference's vmaps do.
# ---------------------------------------------------------------------------

def _safe_a(avec: torch.Tensor) -> torch.Tensor:
    return torch.where(avec == 0.0, 1.0, avec)


def _clip(x: torch.Tensor, lo, hi: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: min(max(x, lo), hi), lo a scalar."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


def _eq_direction_sets(alpha, cvec, avec, mask):
    """Slot membership of the pairwise step u += t (e_i/a_i - e_j/a_j),
    t > 0: ``i_plus`` can take the i slot (room to move by +t/a_i),
    ``i_minus`` the j slot; a == 0 coordinates take neither."""
    ok = mask & (avec != 0.0)
    up = alpha < cvec
    dn = alpha > 0.0
    return (ok & torch.where(avec > 0, up, dn),
            ok & torch.where(avec > 0, dn, up))


def _as_gid(gid, shape, device) -> torch.Tensor:
    """``None``-or-array group ids -> int64 of ``shape`` (group 0)."""
    if gid is None:
        return torch.zeros(shape, dtype=torch.int64, device=device)
    return torch.as_tensor(gid, device=device).long().broadcast_to(shape)


def _broadcast_d(d, lead: tuple, n_groups: int, like) -> torch.Tensor:
    """Scalar-or-vector equality target(s) -> ``lead + (n_groups,)``."""
    t = torch.as_tensor(d, dtype=like.dtype, device=like.device)
    if t.dim() == 0:
        t = t.reshape(1)
    return t.broadcast_to(lead + (n_groups,)).clone()


def _in_groups(gid: torch.Tensor, n_groups: int) -> torch.Tensor:
    """(..., n) group ids -> (..., G, n) membership."""
    return gid[..., None, :] == torch.arange(n_groups, device=gid.device
                                             )[:, None]


def equality_interval_grouped(alpha, grad, C, a, gid, n_groups: int,
                              active_mask=None):
    """Per-group brackets ``(rho_lo, rho_hi)`` of the equality multipliers
    at ``alpha``, each (..., n_groups); an empty side gives -inf / +inf."""
    cvec = _broadcast(C, alpha.shape, alpha)
    avec = _broadcast(a, alpha.shape, alpha)
    mask = (torch.ones(alpha.shape, dtype=torch.bool, device=alpha.device)
            if active_mask is None else active_mask)
    ingrp = _in_groups(_as_gid(gid, alpha.shape, alpha.device), n_groups)
    i_plus, i_minus = _eq_direction_sets(alpha, cvec, avec, mask)
    h = (grad / _safe_a(avec))[..., None, :]
    rho_lo = torch.amax(torch.where(ingrp & i_minus[..., None, :], h,
                                    -torch.inf), dim=-1)
    rho_hi = torch.amin(torch.where(ingrp & i_plus[..., None, :], h,
                                    torch.inf), dim=-1)
    return rho_lo, rho_hi


def equality_interval(alpha, grad, C, a, active_mask=None):
    """Bracket ``(rho_lo, rho_hi)`` of the single equality multiplier; KKT
    holds iff rho_lo <= rho_hi."""
    lo, hi = equality_interval_grouped(alpha, grad, C, a, None, 1,
                                       active_mask=active_mask)
    return lo[..., 0], hi[..., 0]


def kkt_residual_eq(Q: torch.Tensor, alpha: torch.Tensor, C, a, p=0.0,
                    gid=None, n_groups: int = 1) -> torch.Tensor:
    """Maximal-violating-pair gap at ``alpha`` on the full problem, the
    largest over the groups; 0 at a KKT point."""
    g = _mv(Q, alpha) + torch.as_tensor(p, dtype=alpha.dtype,
                                        device=alpha.device)
    lo, hi = equality_interval_grouped(alpha, g, C, a, gid, n_groups)
    return torch.clamp(torch.amax(lo - hi, dim=-1), min=0.0)


def _finite_mid(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    mid = 0.5 * (lo + hi)
    return torch.where(torch.isfinite(mid), mid,
                       torch.where(torch.isfinite(lo), lo,
                                   torch.where(torch.isfinite(hi), hi, 0.0)))


def equality_rho_grouped(alpha, grad, C, a, gid, n_groups: int,
                         active_mask=None) -> torch.Tensor:
    """Per-group multipliers (..., n_groups): the bracket midpoints, or the
    finite side when a side is empty (0 when both are)."""
    return _finite_mid(*equality_interval_grouped(
        alpha, grad, C, a, gid, n_groups, active_mask=active_mask))


def equality_rho(alpha, grad, C, a, active_mask=None) -> torch.Tensor:
    """The single equality multiplier (one-class SVM's decision offset)."""
    return _finite_mid(*equality_interval(alpha, grad, C, a,
                                          active_mask=active_mask))


def project_box_equality(alpha: torch.Tensor, C, a, d, active_mask=None,
                         iters: int = 64) -> torch.Tensor:
    """Project onto {0 <= u <= c} ∩ {a'u = d} by moving along ``a``: the
    residual of ``clip(u - t a, 0, c)`` is monotone in t, so t comes from
    ``iters`` bisection steps on [-T, T] (T saturates every moving
    coordinate).  Coordinates outside ``active_mask`` (and a == 0 ones)
    keep their clipped values and their a'u share.  A start feasible to the
    rounding noise of a'u is returned as it is (clipped).  Leading batch
    dimensions; ``d`` is one target a problem."""
    cvec = _broadcast(C, alpha.shape, alpha)
    avec = _broadcast(a, alpha.shape, alpha)
    mask = (torch.ones(alpha.shape, dtype=torch.bool, device=alpha.device)
            if active_mask is None else active_mask)
    amove = torch.where(mask, avec, 0.0)
    base = _clip(alpha, 0.0, cvec)
    d = torch.as_tensor(d, dtype=alpha.dtype,
                        device=alpha.device).broadcast_to(alpha.shape[:-1])

    def at_t(t):
        return _clip(base - t[..., None] * amove, 0.0, cvec)

    def resid(t):
        return torch.sum(avec * at_t(t), dim=-1) - d

    T = torch.amax(torch.where(amove != 0.0, cvec / torch.clamp(
        torch.abs(amove), min=1e-12), 0.0), dim=-1) + 1.0
    lo, hi = -T, T
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        go_right = resid(mid) > 0.0
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    noise = 8.0 * torch.finfo(alpha.dtype).eps * (
        torch.sum(torch.abs(avec * base), dim=-1) + torch.abs(d) + 1.0)
    keep = torch.abs(resid(torch.zeros_like(d))) <= noise
    return torch.where(keep[..., None], base, at_t(0.5 * (lo + hi)))


def _project_grouped(alpha, cvec, avec, dvec, gid, n_groups, mask,
                     iters: int = 64):
    """Project onto the box and every group's hyperplane; the groups are
    disjoint, so the per-group projections commute."""
    for g in range(n_groups):
        sel = gid == g
        alpha = project_box_equality(alpha, cvec,
                                     torch.where(sel, avec, 0.0),
                                     dvec[..., g], active_mask=mask & sel,
                                     iters=iters)
    return alpha


def _pair_step(ui, uj, ci, cj, ai, aj, t):
    """The pairwise step of length ``t >= 0`` along e_i/a_i - e_j/a_j,
    clipped to both boxes, on gathered values.  The coordinate whose cap
    binds lands exactly on its bound and the other is slaved to its
    realised delta (a step driven from one fixed side stalls when t is
    below the other coordinate's ulp).  Returns (new_ui, di, new_uj, dj)."""
    t_hi_i = torch.where(ai > 0, ai * (ci - ui), -ai * ui)
    t_hi_j = torch.where(aj > 0, aj * uj, aj * (uj - cj))
    t = _clip(t, 0.0, torch.minimum(t_hi_i, t_hi_j))
    hit_i = t >= t_hi_i
    hit_j = t >= t_hi_j
    bound_i = torch.where(ai > 0, ci, 0.0)
    bound_j = torch.where(aj > 0, 0.0, cj)
    ai_from_j = _clip(ui - (aj * (bound_j - uj)) / ai, 0.0, ci)
    ai_from_t = torch.where(hit_i, bound_i, _clip(ui + t / ai, 0.0, ci))
    new_ui = torch.where(hit_j, ai_from_j, ai_from_t)
    di = new_ui - ui
    new_uj = torch.where(hit_j, bound_j, _clip(uj - (ai * di) / aj, 0.0, cj))
    return new_ui, di, new_uj, new_uj - uj


def _restore_equality(alpha, grad, q_row, cvec, avec, d, mask):
    """Absorb the accumulated rounding drift of a'u - d into one coordinate
    a problem: a strictly interior one that stays interior (moving a bound
    coordinate off its bound would re-enter it into the KKT sets), else any
    maskable one.  ``q_row(k)`` gives row k of Q, (b, n), for the gradient
    fix-up.  (b, n) in, (b, n) out."""
    rows = torch.arange(alpha.shape[0], device=alpha.device)
    r = torch.sum(avec * alpha, dim=-1) - d
    cand = _clip(alpha - r[:, None] / _safe_a(avec), 0.0, cvec)
    resid = r[:, None] + avec * (cand - alpha)
    ok = mask & (avec != 0.0)
    interior = ok & (alpha > 0.0) & (alpha < cvec) & (cand > 0.0) \
        & (cand < cvec)
    score_int = torch.where(interior, torch.abs(resid), torch.inf)
    s_int, k_int = torch.min(score_int, dim=-1)
    k_any = torch.argmin(torch.where(ok, torch.abs(resid), torch.inf), dim=-1)
    k = torch.where(torch.isfinite(s_int), k_int, k_any)
    delta = cand[rows, k] - alpha[rows, k]
    alpha = alpha.clone()
    alpha[rows, k] = cand[rows, k]
    return alpha, torch.addcmul(grad, delta[:, None], q_row(k))


def _restore_grouped(alpha, grad, q_row, cvec, avec, dvec, gid, n_groups,
                     mask):
    """Per-group drift restoration (``_restore_equality`` within each
    group's own coordinates)."""
    for g in range(n_groups):
        sel = gid == g
        alpha, grad = _restore_equality(alpha, grad, q_row, cvec,
                                        torch.where(sel, avec, 0.0),
                                        dvec[:, g], mask & sel)
    return alpha, grad


def _mvp_select(alpha, g, cvec, avec, safe, mask, ingrp):
    """The maximal violating pair of each problem: (i, j, gap), the pair of
    the group with the widest gap (ties to the lower group, then the lower
    index, as ``jnp.argmin``/``argmax``).  ``ingrp`` (b, G, n), or None for
    one group."""
    i_plus, i_minus = _eq_direction_sets(alpha, cvec, avec, mask)
    h = g / safe
    if ingrp is None:
        hv, i = torch.min(torch.where(i_plus, h, torch.inf), dim=-1)
        lv, j = torch.max(torch.where(i_minus, h, -torch.inf), dim=-1)
        return i, j, lv - hv
    hv, ig = torch.min(torch.where(ingrp & i_plus[:, None], h[:, None],
                                   torch.inf), dim=-1)
    lv, jg = torch.max(torch.where(ingrp & i_minus[:, None], h[:, None],
                                   -torch.inf), dim=-1)
    gaps = lv - hv                                           # (b, G)
    gs = torch.argmax(gaps, dim=-1, keepdim=True)
    return (ig.gather(-1, gs)[:, 0], jg.gather(-1, gs)[:, 0],
            gaps.gather(-1, gs)[:, 0])


def _groups_mask(gid: torch.Tensor, n_groups: int):
    return None if n_groups == 1 else _in_groups(gid, n_groups)


def _refresh_blocks(alpha, g, viol, running, tol, max_iters, refresh_every,
                    step, full_gap, full_grad, sync_every, graph=None):
    """The outer loop the equality engines share: per problem, a refresh
    block of up to ``refresh_every`` steps (``step(run)``, in place on
    alpha and g, returning the gap it selected at) while the last step's
    gap exceeds ``tol``, then a from-scratch gradient and the stopping test
    on it.  ``running``/``inner`` masks freeze finished problems; the steps
    of a block are one ``_Stepper`` (a CUDA graph on a CUDA device), and
    the host reads the masks every ``sync_every`` steps and once a block.
    Returns (iters, the last fresh-gradient gaps)."""
    dev = alpha.device
    b = alpha.shape[0]
    it = torch.zeros(b, dtype=torch.int64, device=dev)
    k = torch.zeros_like(it)
    blk = torch.zeros_like(it)
    inner = torch.zeros(b, dtype=torch.bool, device=dev)

    def one_step():
        v = step(inner)
        it.add_(inner)
        k.add_(inner)
        viol.copy_(torch.where(inner, v, viol))
        inner.logical_and_((viol > tol) & (k < blk))

    stepper = _Stepper(one_step, dev, _use_graph(graph, dev))
    while bool(running.any()):
        blk.copy_(torch.clamp(max_iters - it, max=refresh_every))
        k.zero_()
        inner.copy_(running & (viol > tol) & (k < blk))
        for s in range(refresh_every):
            if s % sync_every == 0 and s and not bool(inner.any()):
                break
            stepper()
        g.copy_(torch.where(running[:, None], full_grad(alpha), g))
        viol.copy_(torch.where(running, full_gap(alpha, g), viol))
        running.logical_and_((viol > tol) & (it < max_iters))
    return it


def _pairwise_mvp_loop(alpha, cvec, avec, mask, gid, n_groups, qdiag, qij_fn,
                       rank2_fn, full_grad, tol, max_iters, refresh_every,
                       graph=None, tr=None, pvec=None):
    """The pairwise maximal-violating-pair engine on a batch (b, n).

    As the reference: an outer loop of refresh blocks, each up to
    ``refresh_every`` rank-2 steps on the maintained gradient while the
    last step's gap exceeds ``tol``, then a from-scratch gradient and the
    stopping test on it (``_refresh_blocks``).  Returns (alpha, g, iters =
    pair steps, pg_max = the last fresh-gradient gap).  ``tr`` (a ring of
    the batch, with the linear term ``pvec``) records each step's gap with
    the objective and free-set size before it."""
    b, n = alpha.shape
    rows = torch.arange(b, device=alpha.device)
    safe = _safe_a(avec)
    ingrp = _groups_mask(gid, n_groups)
    alpha = alpha.clone()
    g = full_grad(alpha).clone()

    def gap(alpha, g):
        return torch.clamp(_mvp_select(alpha, g, cvec, avec, safe, mask,
                                       ingrp)[2], min=0.0)

    def step(run):
        if tr is not None:
            obj, free = objective(alpha, g, pvec), _n_free(alpha, cvec, mask)
        i, j, viol = _mvp_select(alpha, g, cvec, avec, safe, mask, ingrp)
        ai, aj = safe[rows, i], safe[rows, j]
        curv = qdiag[rows, i] / (ai * ai) + qdiag[rows, j] / (aj * aj) \
            - 2.0 * qij_fn(i, j) / (ai * aj)
        viol = torch.clamp(viol, min=0.0)
        t = viol / torch.clamp(curv, min=1e-12)
        ui, uj = alpha[rows, i], alpha[rows, j]
        new_ui, di, new_uj, dj = _pair_step(ui, uj, cvec[rows, i],
                                            cvec[rows, j], ai, aj, t)
        alpha[rows, i] = torch.where(run, new_ui, ui)
        alpha[rows, j] = torch.where(run, new_uj, alpha[rows, j])
        g.copy_(rank2_fn(g, i, j, torch.where(run, di, 0.0),
                         torch.where(run, dj, 0.0)))
        if tr is not None:
            trace_record(tr, pg_max=viol, objective=obj, n_free=free,
                         where=run)
        return viol

    viol = gap(alpha, g)
    running = (viol > tol) & (max_iters > 0)
    it = _refresh_blocks(alpha, g, viol, running, tol, max_iters,
                         refresh_every, step, gap, full_grad, SYNC_EVERY,
                         graph)
    return alpha, g, it, viol


class _EqBatch(NamedTuple):
    Q: torch.Tensor        # (b, n, n)
    alpha: torch.Tensor    # (b, n), projected feasible
    cvec: torch.Tensor
    avec: torch.Tensor
    pvec: torch.Tensor
    mask: torch.Tensor
    gid: torch.Tensor
    dvec: torch.Tensor     # (b, G)
    lead: tuple


def _eq_batch(Q, C, a, d, alpha0, active_mask, p, gid, n_groups) -> _EqBatch:
    n = Q.shape[-1]
    lead = tuple(Q.shape[:-2])
    shape = lead + (n,)
    Qb = Q.reshape(-1, n, n)
    b = Qb.shape[0]

    def flat(v):
        return _broadcast(v, shape, Q).reshape(b, n)

    cvec, avec, pvec = flat(C), flat(a), flat(p)
    mask = (torch.ones((b, n), dtype=torch.bool, device=Q.device)
            if active_mask is None else torch.as_tensor(
                active_mask, device=Q.device).broadcast_to(shape).reshape(b, n))
    gidv = _as_gid(gid, shape, Q.device).reshape(b, n)
    dvec = _broadcast_d(d, lead, n_groups, Q).reshape(b, n_groups)
    alpha = (torch.zeros((b, n), dtype=Q.dtype, device=Q.device)
             if alpha0 is None else flat(alpha0))
    alpha = _project_grouped(alpha, cvec, avec, dvec, gidv, n_groups, mask)
    return _EqBatch(Qb, alpha, cvec, avec, pvec, mask, gidv, dvec, lead)


def _eq_result(bt: _EqBatch, alpha, g, it, pg_max, tr=None) -> SolveResult:
    n = alpha.shape[-1]
    return SolveResult(alpha.reshape(bt.lead + (n,)),
                       g.reshape(bt.lead + (n,)), it.reshape(bt.lead),
                       pg_max.reshape(bt.lead), trace=tr)


def _dense_hooks(Qb: torch.Tensor, pvec: torch.Tensor):
    rows = torch.arange(Qb.shape[0], device=Qb.device)

    def q_row(k):           # row k of the symmetric Q: column k
        return Qb[rows, k]

    def full_grad(al):
        return _mv(Qb, al) + pvec

    return rows, q_row, full_grad


def solve_eq_qp(Q: torch.Tensor, C, a, d, alpha0=None, tol: float = 1e-3,
                max_iters: int = 10_000, active_mask=None, p=0.0,
                refresh_every: int = 256, gid=None, n_groups: int = 1,
                graph: Optional[bool] = None,
                trace: Optional[ConvTrace] = None) -> SolveResult:
    """Pairwise maximal-violating-pair CD on a dense Q of shape (..., n, n);
    every iterate stays on each group's hyperplane.  The warm start is
    first projected feasible (``project_box_equality``); ``active_mask``
    freezes coordinates, which keep their a'u share; ``d`` is (...,
    n_groups) or a scalar.  Stops when the largest gap, measured on a fresh
    gradient every ``refresh_every`` pair steps, drops below ``tol``.
    ``graph`` (default: on a CUDA device) replays each pair step as a CUDA
    graph, with the eager loop's results bit for bit.  ``trace`` records a
    sample a pair step (``_pairwise_mvp_loop``)."""
    bt = _eq_batch(Q, C, a, d, alpha0, active_mask, p, gid, n_groups)
    rows, q_row, full_grad = _dense_hooks(bt.Q, bt.pvec)
    Qb = bt.Q
    tr = _trace_for(trace, bt.lead, Q.device)

    def rank2(g, i, j, di, dj):
        # g + di Q_i + dj Q_j, fused multiply-adds as the reference's XLA
        # program computes it
        return torch.addcmul(torch.addcmul(g, di[:, None], Qb[rows, i]),
                             dj[:, None], Qb[rows, j])

    alpha, g, it, pg = _pairwise_mvp_loop(
        bt.alpha, bt.cvec, bt.avec, bt.mask, bt.gid, n_groups,
        torch.diagonal(Qb, dim1=-2, dim2=-1), lambda i, j: Qb[rows, i, j],
        rank2, full_grad, tol, max_iters, refresh_every, graph, tr, bt.pvec)
    alpha, g = _restore_grouped(alpha, g, q_row, bt.cvec, bt.avec, bt.dvec,
                                bt.gid, n_groups, bt.mask)
    return _eq_result(bt, alpha, g, it, pg, tr)


# finite tier-2 selection score: "no violation, but a real in-group
# coordinate": above the -inf non-candidates, below any real h score
_SELECT_BIG = 1e30


def _top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest scores along the last axis,
    ties to the lower index (``lax.top_k``'s order)."""
    idx = _top_block(scores, k)
    return scores.gather(-1, idx), idx


def _solve_small_eq_qp(Qbb, gb, ub, ab, cb, gidb, n_groups: int, active,
                       steps: int) -> torch.Tensor:
    """Grouped maximal-violating-pair steps on a batch of (m, m) sub-QPs
    around the entry point: ``steps`` rank-2 steps, each within one group,
    so every inner iterate stays on every group's hyperplane.  Slots outside
    ``active`` never move.  Returns the new u_b."""
    b = Qbb.shape[0]
    rows = torch.arange(b, device=Qbb.device)
    diag = torch.diagonal(Qbb, dim1=-2, dim2=-1)
    safe = _safe_a(ab)
    ingrp = _groups_mask(gidb, n_groups)
    u, g = ub.clone(), gb.clone()
    for _ in range(steps):
        i, j, viol = _mvp_select(u, g, cb, ab, safe, active, ingrp)
        ai, aj = safe[rows, i], safe[rows, j]
        curv = diag[rows, i] / (ai * ai) + diag[rows, j] / (aj * aj) \
            - 2.0 * Qbb[rows, i, j] / (ai * aj)
        t = torch.clamp(viol, min=0.0) / torch.clamp(curv, min=1e-12)
        new_ui, di, new_uj, dj = _pair_step(u[rows, i], u[rows, j],
                                            cb[rows, i], cb[rows, j], ai, aj,
                                            t)
        u[rows, i] = new_ui
        u[rows, j] = new_uj
        g = torch.addcmul(torch.addcmul(g, di[:, None], Qbb[rows, :, i]),
                          dj[:, None], Qbb[rows, :, j])
    return u


def _blocked_mvp_loop(alpha, cvec, avec, mask, gid, n_groups, block, sweeps,
                      qbb_fn, rank2b_fn, full_grad, tol, max_iters,
                      refresh_every, graph=None, tr=None, pvec=None):
    """The rank-2B blocked engine on a batch (b, n).

    Each outer iteration selects per group the ``block`` smallest i-slot
    bounds and, disjoint from them, the ``block`` largest j-slot bounds
    (so the maximal violating pair is inside); a side short of candidates
    is filled with other in-group coordinates (score -1e30), and slots
    that cannot be filled come back invalid and are frozen in the sub-QP,
    their writes routed onto one valid slot so duplicate writes carry
    identical values.  Outer structure and masks as
    ``_pairwise_mvp_loop``; ``iters`` counts outer iterations, and ``tr``
    records a sample each (the gap before it)."""
    b, n = alpha.shape
    dev = alpha.device
    safe = _safe_a(avec)
    ingrp = _in_groups(gid, n_groups)                         # (b, G, n)
    okg = ingrp & (mask & (avec != 0.0))[:, None]
    steps = 2 * sweeps * block
    big = torch.tensor(_SELECT_BIG, dtype=alpha.dtype, device=dev)
    alpha = alpha.clone()

    def sides(alpha, g):
        i_plus, i_minus = _eq_direction_sets(alpha, cvec, avec, mask)
        return (ingrp & i_plus[:, None], ingrp & i_minus[:, None],
                (g / safe)[:, None])

    def gap(up, dn, h):
        hi = torch.amin(torch.where(up, h, torch.inf), dim=-1)
        lo = torch.amax(torch.where(dn, h, -torch.inf), dim=-1)
        return torch.clamp(torch.amax(lo - hi, dim=-1), min=0.0)

    def step(run):
        if tr is not None:
            obj, free = objective(alpha, g, pvec), _n_free(alpha, cvec, mask)
        up, dn, h = sides(alpha, g)
        viol = gap(up, dn, h)
        sc_i = torch.where(up, -h, torch.where(okg, -big, -torch.inf))
        iv, ii = _top_k(sc_i, block)                           # (b, G, B)
        taken = torch.zeros((b, n), dtype=torch.int32, device=dev)
        taken.scatter_reduce_(-1, ii.reshape(b, -1),
                              torch.isfinite(iv).reshape(b, -1).int(), "amax")
        open_j = (taken == 0)[:, None]
        sc_j = torch.where(dn & open_j, h,
                           torch.where(okg & open_j, -big, -torch.inf))
        jv, jj = _top_k(sc_j, block)
        idx = torch.cat([ii, jj], dim=-1).reshape(b, -1)       # (b, G * 2B)
        valid = torch.cat([torch.isfinite(iv), torch.isfinite(jv)],
                          dim=-1).reshape(b, -1)
        ub = alpha.gather(-1, idx)
        new_ub = _solve_small_eq_qp(qbb_fn(idx), g.gather(-1, idx), ub,
                                    avec.gather(-1, idx), cvec.gather(-1, idx),
                                    gid.gather(-1, idx), n_groups, valid,
                                    steps)
        new_ub = torch.where(run[:, None], new_ub, ub)
        # invalid slots write the first valid slot's value onto its index,
        # so duplicate writes carry identical values
        s0 = torch.argmax(valid.int(), dim=-1, keepdim=True)
        alpha.scatter_(-1, torch.where(valid, idx, idx.gather(-1, s0)),
                       torch.where(valid, new_ub, new_ub.gather(-1, s0)))
        g.copy_(rank2b_fn(g, idx, torch.where(valid, new_ub - ub, 0.0)))
        if tr is not None:
            trace_record(tr, pg_max=viol, objective=obj, n_free=free,
                         where=run)
        return viol

    def full_gap(alpha, g):
        return gap(*sides(alpha, g))

    g = full_grad(alpha).clone()
    viol = full_gap(alpha, g)
    running = (viol > tol) & (max_iters > 0)
    # a block step costs 2 * sweeps * block pair steps: read the mask
    # every step
    it = _refresh_blocks(alpha, g, viol, running, tol, max_iters,
                         refresh_every, step, full_gap, full_grad, 1, graph)
    return alpha, g, it, viol


def solve_eq_qp_block(Q: torch.Tensor, C, a, d, alpha0=None, tol: float = 1e-3,
                      max_iters: int = 5_000, block: int = 8, sweeps: int = 4,
                      active_mask=None, p=0.0, refresh_every: int = 32,
                      gid=None, n_groups: int = 1,
                      graph: Optional[bool] = None,
                      trace: Optional[ConvTrace] = None) -> SolveResult:
    """Rank-2B blocked pairwise CD on a dense Q (..., n, n): each outer
    iteration takes the ``block`` maximal-violating pairs per group, solves
    the coupled 2B x 2B sub-QP by grouped pair steps and applies the rank-2B
    gradient update ``g += Q[:, idx] @ delta``; ``graph`` as in
    ``solve_eq_qp`` (one graph a whole blocked step); ``trace`` records a
    sample an outer iteration."""
    bt = _eq_batch(Q, C, a, d, alpha0, active_mask, p, gid, n_groups)
    rows, q_row, full_grad = _dense_hooks(bt.Q, bt.pvec)
    tr = _trace_for(trace, bt.lead, Q.device)
    Qb = bt.Q
    n = Qb.shape[-1]
    B = max(1, min(block, n // (2 * n_groups)))

    def qbb(idx):
        m = idx.shape[-1]
        Qrows = Qb.gather(1, idx[:, :, None].expand(-1, m, n))
        return Qrows.gather(2, idx[:, None, :].expand(-1, m, m))

    def rank2b(g, idx, delta):
        Qcols = Qb.gather(2, idx[:, None, :].expand(-1, n, idx.shape[-1]))
        return g + _mv(Qcols, delta)

    alpha, g, it, pg = _blocked_mvp_loop(
        bt.alpha, bt.cvec, bt.avec, bt.mask, bt.gid, n_groups, B, sweeps,
        qbb, rank2b, full_grad, tol, max_iters, refresh_every, graph, tr,
        bt.pvec)
    alpha, g = _restore_grouped(alpha, g, q_row, bt.cvec, bt.avec, bt.dvec,
                                bt.gid, n_groups, bt.mask)
    return _eq_result(bt, alpha, g, it, pg, tr)


def solve_eq_qp_shrink(Q: torch.Tensor, C, a, d, alpha0=None,
                       tol: float = 1e-3, max_iters: int = 10_000,
                       rounds: int = 3, shrink_margin: float = 10.0, p=0.0,
                       block: int = 0, sweeps: int = 4, gid=None,
                       n_groups: int = 1,
                       trace: Optional[ConvTrace] = None) -> SolveResult:
    """Outer shrinking rounds around the pairwise (``block <= 1``) or
    blocked engine: a coordinate at a bound whose h_i lies beyond its
    group's rho estimate by more than ``shrink_margin * tol`` is frozen for
    the next round (keeping its a'u share); the final round re-activates
    everything, and ``pg_max`` is the full problem's gap.  One ``trace``
    ring records through every round."""
    if rounds < 1:
        raise ValueError(f"shrinking needs rounds >= 1, got {rounds}")
    n = Q.shape[-1]
    shape = tuple(Q.shape[:-2]) + (n,)
    cvec = _broadcast(C, shape, Q)
    avec = _broadcast(a, shape, Q)
    gidv = _as_gid(gid, shape, Q.device)
    alpha = (torch.zeros(shape, dtype=Q.dtype, device=Q.device)
             if alpha0 is None else _broadcast(alpha0, shape, Q))
    mask = torch.ones(shape, dtype=torch.bool, device=Q.device)
    total = torch.zeros(shape[:-1], dtype=torch.int64, device=Q.device)
    res, tr = None, trace
    for r in range(rounds):
        m = torch.ones_like(mask) if r == rounds - 1 else mask
        kw = dict(alpha0=alpha, tol=tol, max_iters=max_iters, active_mask=m,
                  p=p, gid=gidv, n_groups=n_groups, trace=tr)
        res = (solve_eq_qp_block(Q, C, a, d, block=block, sweeps=sweeps, **kw)
               if block > 1 else solve_eq_qp(Q, C, a, d, **kw))
        tr = res.trace
        alpha, g = res.alpha, res.grad
        total = total + res.iters
        rho = equality_rho_grouped(alpha, g, cvec, avec, gidv,
                                   n_groups).gather(-1, gidv)
        h = g / _safe_a(avec)
        mtol = shrink_margin * tol
        lock_lo = (alpha <= 0.0) & torch.where(avec > 0, h > rho + mtol,
                                               h < rho - mtol)
        lock_hi = (alpha >= cvec) & torch.where(avec > 0, h < rho - mtol,
                                                h > rho + mtol)
        mask = ~(lock_lo | lock_hi)
    pg_full = kkt_residual_eq(Q, res.alpha, cvec, avec, p=p, gid=gidv,
                              n_groups=n_groups)
    return SolveResult(res.alpha, res.grad, total, pg_full, trace=tr)


def solve_eq_qp_matvec(X: torch.Tensor, y: torch.Tensor, kernel: Kernel, C,
                       a, d, alpha0=None, tol: float = 1e-3,
                       max_iters: int = 5_000, grad_chunks: int = 16,
                       use_kernels: bool = False, p=0.0,
                       refresh_every: int = 512, block: int = 1,
                       sweeps: int = 4, gid=None, n_groups: int = 1,
                       compute_dtype=None, graph: Optional[bool] = None,
                       trace: Optional[ConvTrace] = None) -> SolveResult:
    """Pairwise (``block <= 1``) or rank-2B blocked maximal-violating-pair
    CD with the kernel columns computed on the fly: Q = (y y') ∘ K(X, X)
    is never formed (one problem; ``y`` is the task's sign vector).  With
    ``use_kernels`` the rank-2 / rank-2B gradient update is the fused
    ``cd_column_update`` kernel (B = 2, or |idx| = n_groups * 2B columns)
    and every from-scratch gradient the streaming ``kernel_matvec``.
    ``refresh_every`` counts pair steps and is divided by 2B on the blocked
    path.  ``compute_dtype`` is the operator's precision policy.  ``graph``
    and ``trace`` as in ``solve_eq_qp``."""
    n = X.shape[0]
    shape = (1, n)
    cvec, avec, pvec = (_broadcast(v, (n,), X)[None] for v in (C, a, p))
    mask = torch.ones(shape, dtype=torch.bool, device=X.device)
    gidv = _as_gid(gid, (n,), X.device)[None]
    dvec = _broadcast_d(d, (1,), n_groups, X)
    alpha = (torch.zeros(shape, dtype=X.dtype, device=X.device)
             if alpha0 is None else _broadcast(alpha0, (n,), X)[None])
    alpha = _project_grouped(alpha, cvec, avec, dvec, gidv, n_groups, mask)
    op = gramop.GramOperator(Xd=X, s=y, kernel=kernel,
                             use_kernels=use_kernels,
                             compute_dtype=compute_dtype).prepare()
    acc = torch.promote_types(X.dtype, torch.float32)
    tr = _trace_for(trace, (), X.device)

    def full_grad(al):
        return (op.matvec(al[0], num_chunks=grad_chunks)
                + pvec[0]).to(acc)[None]

    def rank2b(g, idx, delta):
        return op.col_update(g[0], idx[0], delta[0])[None]

    if block > 1:
        B = max(1, min(block, n // (2 * n_groups)))
        alpha, g, it, pg = _blocked_mvp_loop(
            alpha, cvec, avec, mask, gidv, n_groups, B, sweeps,
            lambda idx: op.qbb(idx[0]).to(acc)[None], rank2b, full_grad,
            tol, max_iters, max(1, refresh_every // (2 * B)), graph, tr, pvec)
    else:
        def qij(i, j):
            return op.qbb(torch.cat([i, j]))[0, 1].to(acc)[None]

        def rank2(g, i, j, di, dj):
            return rank2b(g, torch.stack([i, j], dim=-1),
                          torch.stack([di, dj], dim=-1))

        alpha, g, it, pg = _pairwise_mvp_loop(
            alpha, cvec, avec, mask, gidv, n_groups, op.qdiag().to(acc)[None],
            qij, rank2, full_grad, tol, max_iters, refresh_every, graph, tr,
            pvec)

    def q_row(k):
        # one plain column under the operator's kernel and policy,
        # whatever the backend
        Kk = kernel.pairwise(X, X[k], compute_dtype=op._cd())[:, 0]
        return (y * y[k] * Kk).to(acc)[None]

    alpha, g = _restore_grouped(alpha, g, q_row, cvec, avec, dvec, gidv,
                                n_groups, mask)
    return SolveResult(alpha[0], g[0], it[0], pg[0], trace=tr)
