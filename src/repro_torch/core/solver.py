"""Box-constrained QP solvers (port of ``repro.core.solver``, box family).

    min_u  f(u) = 1/2 u' Q u + p' u     s.t.  0 <= u <= c

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

The dense solvers take a leading batch of independent problems, the
counterpart of the reference's ``vmap`` over ``lax.while_loop``: the whole
batch stays on the device, a per-problem ``running`` mask freezes the
problems that have stopped (``torch.where``), and the host reads the mask
only every ``SYNC_EVERY`` steps.  Each problem's ``iters`` is therefore the
count the reference's own loop gives.  Top-B selection is a stable
descending sort, so ties go to the lower index as in ``lax.top_k``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import gramop
from repro_torch.core.kernels import Kernel

# Steps between host reads of the running mask (the only host syncs of the
# solver loops).  A stopped problem is frozen on the device at once, so the
# value bounds only the wasted steps after the last problem stops.
SYNC_EVERY = 64


class SolveResult(NamedTuple):
    alpha: torch.Tensor
    grad: torch.Tensor      # g = Q a + p at the returned alpha
    iters: torch.Tensor     # outer iterations executed, per problem
    pg_max: torch.Tensor    # final max |projected gradient|, per problem


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


def proj_grad(alpha: torch.Tensor, grad: torch.Tensor, C) -> torch.Tensor:
    """Projected gradient of the box QP (the KKT residual)."""
    pg = torch.where(alpha <= 0.0, torch.clamp(grad, max=0.0), grad)
    return torch.where(alpha >= C, torch.clamp(grad, min=0.0), pg)


def kkt_residual(Q: torch.Tensor, alpha: torch.Tensor, C, p=-1.0
                 ) -> torch.Tensor:
    g = _mv(Q, alpha) + torch.as_tensor(p, dtype=alpha.dtype,
                                        device=alpha.device)
    return torch.amax(torch.abs(proj_grad(alpha, g, C)), dim=-1)


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


def _result(bt: _Batch, alpha, g, it, pg_max) -> SolveResult:
    n = alpha.shape[-1]
    return SolveResult(alpha.reshape(bt.lead + (n,)), g.reshape(bt.lead + (n,)),
                       it.reshape(bt.lead), pg_max.reshape(bt.lead))


def _masked_pg(alpha, g, cvec, mask):
    return torch.where(mask, proj_grad(alpha, g, cvec), 0.0)


def solve_box_qp(Q: torch.Tensor, C, alpha0: Optional[torch.Tensor] = None,
                 tol: float = 1e-3, max_iters: int = 10_000,
                 active_mask: Optional[torch.Tensor] = None, p=-1.0
                 ) -> SolveResult:
    """Greedy coordinate descent on a dense Q of shape (..., n, n).

    ``active_mask`` freezes coordinates (shrinking, pad slots): masked-out
    coordinates are never selected and count as 0 for stopping."""
    bt = _batch(Q, C, alpha0, active_mask, p)
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
    return _result(bt, alpha, g, it, pg_max)


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
                       active_mask: Optional[torch.Tensor] = None, p=-1.0
                       ) -> SolveResult:
    """Top-B greedy block CD on a dense Q of shape (..., n, n): each outer
    iteration moves the B coordinates of largest |projected gradient|."""
    bt = _batch(Q, C, alpha0, active_mask, p)
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
    return _result(bt, alpha, g, it, pg_max)


def solve_box_qp_matvec(X: torch.Tensor, y: torch.Tensor, kernel: Kernel, C,
                        alpha0: Optional[torch.Tensor] = None,
                        tol: float = 1e-3, max_iters: int = 500,
                        block: int = 64, sweeps: int = 4,
                        grad_chunks: int = 16, use_kernels: bool = False,
                        p=-1.0) -> SolveResult:
    """Block greedy CD where the Q columns are recomputed from (X, y) at
    every step; ``y`` is the sign vector of Q = (y y') ∘ K.  With
    ``use_kernels`` the rank-B update is the fused ``cd_column_update``
    kernel and the initial gradient the streaming ``kernel_matvec``."""
    op = gramop.GramOperator(Xd=X, s=y, kernel=kernel, use_kernels=use_kernels)
    return solve_box_qp_op(op, C, alpha0=alpha0, tol=tol, max_iters=max_iters,
                           block=block, sweeps=sweeps, grad_chunks=grad_chunks,
                           p=p)


def _op_step(op: "gramop.GramOperator", alpha, g, cvec, pg_max, it, running,
             tol: float, max_iters: int, block: int, sweeps: int, acc):
    """One iteration of the level-0 block CD, in place on the state tensors
    (alpha, g, pg_max, it, running): what the CUDA graph captures and the
    eager loop runs."""
    sc = torch.abs(proj_grad(alpha, g, cvec))
    idx = _top_block(sc, block)
    step_max = sc.gather(0, idx[:1])[0]
    ab = alpha[idx]
    if op.use_kernels:
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
    g.copy_(op.col_update(g, idx, delta) if op.use_kernels
            else g + Qb @ delta)
    pg_max.copy_(torch.where(running, step_max, pg_max))
    it += running
    running &= (pg_max > tol) & (it < max_iters)


# Eager iterations before the capture of the graphed loop (on a side
# stream, as PyTorch asks of a capture's warm-up); they are real iterations.
GRAPH_WARMUP = 2


def solve_box_qp_op(op: "gramop.GramOperator", C,
                    alpha0: Optional[torch.Tensor] = None, tol: float = 1e-3,
                    max_iters: int = 500, block: int = 64, sweeps: int = 4,
                    grad_chunks: int = 16, p=-1.0,
                    graph: Optional[bool] = None) -> SolveResult:
    """The engine behind ``solve_box_qp_matvec``: block greedy CD against a
    ``GramOperator`` (one problem).

    ``graph`` (default: on a CUDA device with ``op.use_kernels``) captures
    one iteration into a CUDA graph after ``GRAPH_WARMUP`` eager ones and
    replays it; the state lives in static tensors and the host still reads
    ``running`` every ``SYNC_EVERY`` iterations, so the results equal the
    eager loop's bit for bit.  ``graph=False`` runs the eager loop (the
    CPU's); a failed capture raises."""
    X = op.Xd
    n = op.n_dual
    if block > n:
        raise ValueError(f"block {block} larger than the problem size {n}")
    if graph is None:
        graph = X.device.type == "cuda" and op.use_kernels
    if graph and X.device.type != "cuda":
        raise ValueError("a CUDA graph needs a CUDA device")
    acc = torch.promote_types(X.dtype, torch.float32)
    alpha = (torch.zeros(n, dtype=X.dtype, device=X.device) if alpha0 is None
             else _broadcast(alpha0, (n,), X))
    cvec = _broadcast(C, (n,), X)
    pvec = _broadcast(p, (n,), X)
    g = (op.matvec(alpha, num_chunks=grad_chunks) + pvec).to(acc)
    pg_max = torch.amax(torch.abs(proj_grad(alpha, g, cvec)))
    it = torch.zeros((), dtype=torch.int64, device=X.device)
    running = (pg_max > tol) & (it < max_iters)

    def step():
        _op_step(op, alpha, g, cvec, pg_max, it, running, tol, max_iters,
                 block, sweeps, acc)

    if graph:
        from repro_torch.kernels import ops

        side = torch.cuda.Stream(X.device)
        cuda_graph, per_replay = None, {}
    for k in range(max_iters):
        if k % SYNC_EVERY == 0 and not bool(running):
            break
        if not graph:
            step()
        elif k < GRAPH_WARMUP:
            side.wait_stream(torch.cuda.current_stream(X.device))
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream(X.device).wait_stream(side)
        else:
            if cuda_graph is None:
                cuda_graph = torch.cuda.CUDAGraph()
                with ops.recording() as per_replay, \
                        torch.cuda.graph(cuda_graph):
                    step()
            cuda_graph.replay()
            ops.add_launches(per_replay)
    return SolveResult(alpha, g, it, pg_max)


def solve_with_shrinking(Q: torch.Tensor, C,
                         alpha0: Optional[torch.Tensor] = None,
                         tol: float = 1e-3, max_iters: int = 10_000,
                         rounds: int = 3, shrink_margin: float = 10.0,
                         block: int = 0, p=-1.0) -> SolveResult:
    """Outer shrinking rounds around the CD solver (dense Q, batchable).

    Each round solves on the active set to ``tol``; variables pinned at a
    bound with |g| > shrink_margin * tol leave the active set for the next
    round; the final round re-activates everything.  ``pg_max`` is
    recomputed at the returned alpha on the full problem."""
    if rounds < 1:
        raise ValueError(f"shrinking needs rounds >= 1, got {rounds}")
    n = Q.shape[-1]
    shape = tuple(Q.shape[:-2]) + (n,)
    alpha = (torch.zeros(shape, dtype=Q.dtype, device=Q.device)
             if alpha0 is None else _broadcast(alpha0, shape, Q))
    cvec = _broadcast(C, shape, Q)
    mask = torch.ones(shape, dtype=torch.bool, device=Q.device)
    total = torch.zeros(shape[:-1], dtype=torch.int64, device=Q.device)
    res = None
    for r in range(rounds):
        m = torch.ones_like(mask) if r == rounds - 1 else mask
        if block <= 0:
            res = solve_box_qp(Q, C, alpha0=alpha, tol=tol,
                               max_iters=max_iters, active_mask=m, p=p)
        else:
            res = solve_box_qp_block(Q, C, alpha0=alpha, tol=tol,
                                     max_iters=max_iters, block=block,
                                     active_mask=m, p=p)
        alpha, g = res.alpha, res.grad
        total = total + res.iters
        strongly_lo = (alpha <= 0.0) & (g > shrink_margin * tol)
        strongly_hi = (alpha >= cvec) & (g < -shrink_margin * tol)
        mask = ~(strongly_lo | strongly_hi)
    pg_full = kkt_residual(Q, res.alpha, cvec, p=p)
    return SolveResult(res.alpha, res.grad, total, pg_full)
