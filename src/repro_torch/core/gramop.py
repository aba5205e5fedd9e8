"""Kernel-operator layer (port of ``repro.core.gramop``): one Gram
abstraction for every consumer, with three concerns in one place.

A ``GramOperator`` holds the dual points ``Xd`` (n, d) and the sign vector
``s`` (n,) of ``Q = (s s') ∘ K(Xd, Xd)`` and gives the conquer solvers every
kernel access they need: row and column blocks, the working-set block, the
diagonal, the matvec and the rank-B gradient update.  Budgets are in BYTES.

1. Precision policy (``compute_dtype``).  ``None`` keeps every computation
   as it was.  ``"bfloat16"`` rounds the product operands to bf16 and
   accumulates in f32 (``core.kernels``); on the kernel path the operator
   packs its base rows once (``ops.pack_bf16``) and the bf16 forms read
   them, half the bytes of the f32 rows.  Cached and spilled rows are
   stored in the policy's dtype (``storage_dtype``).

2. Memory tiers.  The column cache (``core.colcache``, in the solver) and
   the host-RAM spill tier (``solve_box_qp_spill``): kernel-row panels
   computed once, written through to pinned host buffers, served from a
   device pool of panel slots, the next panel's copy overlapping the
   current panel's sub-solve on a side stream.

3. Base-indexed view (``Xb``/``bidx``, ``Xd == Xb[bidx]`` row for row):
   tasks with duplicated dual rows (epsilon-SVR's mirrored (alpha, alpha*)
   pair) compute kernel rows against the n_base base rows only and expand
   the signs at read, ``Q[i, j] = s_i K[i, bidx_j] s_j`` (exact: s is
   +/-1).  The fused rank-B update then runs ``cd_column_update`` over the
   base rows with an all-ones sign vector and gathers through ``bidx``.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Optional

import torch

from repro_torch.core.kernels import DEFAULT_GRAM_BUDGET, Kernel, gram_matvec
from repro_torch.kernels.ops import as_dtype, resolve_compute_dtype
from repro_torch.obs.spans import span

# Steps between host reads of a panel sub-solve's running flag.  A panel
# stops after about ten steps on the main path's data, so the level-0
# loop's SYNC_EVERY (64) would replay some fifty frozen steps a panel
# visit (110 ms of 115 at 32,768 rows on an H100); a stopped panel is
# frozen on the device, so the value changes the waste, not the counts.
PANEL_SYNC_EVERY = 8


def fits_budget(n_elems: int, budget_bytes: int, itemsize: int = 4,
                dtype: Optional[torch.dtype] = None) -> bool:
    """Does an ``n_elems``-element buffer (of ``dtype``, else of
    ``itemsize`` bytes an element) fit ``budget_bytes``?  The one predicate
    behind every Gram-residency decision."""
    if dtype is not None:
        itemsize = as_dtype(dtype).itemsize
    return int(n_elems) * int(itemsize) <= int(budget_bytes)


@dataclasses.dataclass(frozen=True)
class GramOperator:
    """Kernel + dual data + precision policy + base-index view + backend
    for ``Q = (s s') ∘ K``."""

    Xd: torch.Tensor
    s: torch.Tensor
    Xb: Optional[torch.Tensor] = None
    bidx: Optional[torch.Tensor] = None
    kernel: Kernel = Kernel("rbf", gamma=1.0)
    use_kernels: bool = False
    compute_dtype: Optional[str] = None
    budget_bytes: int = DEFAULT_GRAM_BUDGET

    # -- structure --------------------------------------------------------
    @property
    def n_dual(self) -> int:
        return self.Xd.shape[0]

    @property
    def dedup(self) -> bool:
        return self.bidx is not None

    @property
    def kwidth(self) -> int:
        """Width of a raw kernel row (n_base under the view): the unit the
        column cache and the spill panels store."""
        return self.Xb.shape[0] if self.dedup else self.n_dual

    def storage_dtype(self, acc: torch.dtype) -> torch.dtype:
        """Row-storage dtype of the cache and spill tiers: the policy's
        dtype when one is set, else the accumulator's."""
        if self.compute_dtype is not None:
            return as_dtype(self.compute_dtype)
        return acc

    def cache_keys(self, idx: torch.Tensor) -> torch.Tensor:
        """Row key of each selected dual coordinate: its base id under the
        view (mirrored SVR coordinates share one row), else itself."""
        return self.bidx[idx] if self.dedup else idx

    # -- operands ---------------------------------------------------------
    def _cd(self) -> Optional[torch.dtype]:
        return resolve_compute_dtype(self.compute_dtype, self.Xd.dtype)

    @property
    def _packed(self) -> bool:
        """The kernel path under a low-precision policy reads packed rows."""
        return self.use_kernels and self._cd() is not None

    @functools.cached_property
    def _base_packed(self):
        from repro_torch.kernels import ops

        base = self.Xb if self.dedup else self.Xd
        return ops.pack_bf16(base.contiguous())

    def prepare(self) -> "GramOperator":
        """Pack the base rows now (once a solve, before any CUDA graph
        capture); a no-op off the packed path."""
        if self._packed:
            self._base_packed
        return self

    def _base(self):
        """All base points, as the kernels read them."""
        if self._packed:
            return self._base_packed
        return self.Xb if self.dedup else self.Xd

    def _base_at(self, keys: torch.Tensor):
        """Base points ``keys``, as the kernels read them."""
        if self._packed:
            return self._base_packed.index(keys)
        return (self.Xb if self.dedup else self.Xd)[keys]

    def _dual(self):
        """All dual points, as the kernels read them."""
        if self._packed:
            return (self._base_packed.index(self.bidx) if self.dedup
                    else self._base_packed)
        return self.Xd

    # -- kernel access ----------------------------------------------------
    def kmat(self, A, B, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        """K(A, B) under the policy: the ``kermat`` kernel (``skip``: its
        device predicate) or the plain pairwise."""
        if self.use_kernels:
            from repro_torch.kernels import ops

            if isinstance(A, torch.Tensor):
                A = A.contiguous()
            if isinstance(B, torch.Tensor):
                B = B.contiguous()
            return ops.kernel_matrix(A, B, self.kernel,
                                     compute_dtype=self.compute_dtype,
                                     skip=skip)
        return self.kernel.pairwise(A, B, compute_dtype=self._cd())

    def base_rows(self, keys: torch.Tensor,
                  skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Raw (B, kwidth) kernel rows of base points ``keys`` against all
        base points."""
        return self.kmat(self._base_at(keys), self._base(), skip=skip)

    def kernel_rows(self, idx: torch.Tensor,
                    skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Raw (B, kwidth) kernel rows ``K(Xd[idx], base points)`` (the
        same values: ``Xd[idx] == base[cache_keys(idx)]``)."""
        return self.base_rows(self.cache_keys(idx), skip=skip)

    def expand_rows(self, kr: torch.Tensor, idx: torch.Tensor
                    ) -> torch.Tensor:
        """Raw rows (B, kwidth) -> signed Q rows (B, n_dual)."""
        cols = kr[:, self.bidx] if self.dedup else kr
        return self.s[idx][:, None] * (cols * self.s[None, :])

    def q_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Signed (B, n_dual) rows of Q for a selected block."""
        return self.expand_rows(self.kernel_rows(idx), idx)

    def q_block(self, idx: torch.Tensor) -> torch.Tensor:
        """Signed (n, B) columns of Q (the plain path's orientation)."""
        sel = self._base_at(self.cache_keys(idx))
        Kb = self.kmat(self._base(), sel)
        if self.dedup:
            Kb = Kb[self.bidx]
        return (self.s[:, None] * self.s[idx][None, :]) * Kb

    def qbb(self, idx: torch.Tensor) -> torch.Tensor:
        """The (B, B) working-set block of Q (plain torch, as in the
        reference)."""
        Xsel, ssel = self.Xd[idx], self.s[idx]
        Kbb = self.kernel.pairwise(Xsel, Xsel, compute_dtype=self._cd())
        return (ssel[:, None] * ssel[None, :]) * Kbb

    def qdiag(self) -> torch.Tensor:
        return self.s * self.s * self.kernel.diag(self.Xd)

    def matvec(self, v: torch.Tensor, num_chunks: Optional[int] = None,
               via_base: bool = False) -> torch.Tensor:
        """Q @ v without materialising Q.  ``via_base`` (under the view)
        first collapses the weights onto the base rows, an n_base-sized
        matvec that sums in another order; off by default."""
        if via_base and self.dedup:
            w = torch.zeros(self.Xb.shape[0], dtype=v.dtype,
                            device=v.device).index_add_(0, self.bidx,
                                                        self.s * v)
            return self.s * self._kmv(self._base(), self.Xb, w,
                                      num_chunks)[self.bidx]
        return self.s * self._kmv(self._dual(), self.Xd, self.s * v,
                                  num_chunks)

    def _kmv(self, P, X: torch.Tensor, v: torch.Tensor,
             num_chunks: Optional[int]) -> torch.Tensor:
        if self._packed:
            from repro_torch.kernels import ops

            return ops.kernel_matvec(P, P, v.contiguous(), self.kernel,
                                     compute_dtype=self.compute_dtype)
        return gram_matvec(self.kernel, X, v, num_chunks=num_chunks,
                           use_kernels=self.use_kernels,
                           budget_bytes=self.budget_bytes,
                           compute_dtype=self.compute_dtype)

    def col_update(self, g: torch.Tensor, idx: torch.Tensor,
                   delta: torch.Tensor) -> torch.Tensor:
        """g + Q[:, idx] @ delta, the rank-B gradient update: the fused
        ``cd_column_update`` kernel (over the base rows with y = 1 under
        the view, then gathered), or the plain column block."""
        if self.use_kernels:
            from repro_torch.kernels import ops

            sel = self._base_at(self.cache_keys(idx))
            if isinstance(sel, torch.Tensor):
                sel = sel.contiguous()
            w = (self.s[idx] * delta).contiguous()
            base = self._base()
            if isinstance(base, torch.Tensor):
                base = base.contiguous()
            if self.dedup:
                ones = torch.ones(self.Xb.shape[0], dtype=self.Xb.dtype,
                                  device=self.Xb.device)
                out = ops.cd_column_update(base, ones, sel, w, self.kernel,
                                           compute_dtype=self.compute_dtype)
                return g + (self.s * out[self.bidx]).to(g.dtype)
            return g + ops.cd_column_update(
                base, self.s.contiguous(), sel, w, self.kernel,
                compute_dtype=self.compute_dtype).to(g.dtype)
        return g + self.q_block(idx).to(g.dtype) @ delta


# ---------------------------------------------------------------------------
# Host-RAM spill tier: out-of-core block CD over kernel-row panels
# ---------------------------------------------------------------------------

class _PanelSolve:
    """Greedy block CD restricted to one device-resident panel of raw
    kernel rows, in place on static tensors (what a CUDA graph replays).
    The panel is slot ``slot`` of ``pool`` (rows_p, kwidth) starting at base
    row ``pstart``; both are device scalars set before each panel.
    Selection is Gauss-Southwell within the panel; the rank-B gradient
    update runs over all coordinates, so the maintained gradient stays
    exact across panel visits.  Panels live in base-row space: under the
    view a dual coordinate is in the panel when its base id is, so SVR's
    mirrored pair always shares one."""

    def __init__(self, op: GramOperator, pool: torch.Tensor, alpha, g, cvec,
                 tol: float, block: int, sweeps: int, inner: int,
                 rows_p: int):
        dev = alpha.device
        self.op, self.alpha, self.g, self.cvec = op, alpha, g, cvec
        self.tol, self.block, self.sweeps = tol, block, sweeps
        self.inner, self.rows_p = inner, rows_p
        self.flat = pool.view(-1, pool.shape[-1])
        self.key = (op.bidx if op.dedup
                    else torch.arange(alpha.shape[0], device=dev))
        self.pstart = torch.zeros((), dtype=torch.int64, device=dev)
        self.slot = torch.zeros((), dtype=torch.int64, device=dev)
        self.it = torch.zeros((), dtype=torch.int64, device=dev)
        self.pg = torch.zeros((), dtype=g.dtype, device=dev)
        self.running = torch.zeros((), dtype=torch.bool, device=dev)

    def _in_panel(self):
        return (self.key >= self.pstart) & (self.key < self.pstart
                                            + self.rows_p)

    def _panel_pg(self, in_panel):
        from repro_torch.core.solver import proj_grad

        return torch.amax(torch.where(
            in_panel, torch.abs(proj_grad(self.alpha, self.g, self.cvec)),
            0.0))

    def start(self, pstart: int, slot: int) -> None:
        """Set the panel and prime its loop state (eager)."""
        self.pstart.fill_(pstart)
        self.slot.fill_(slot)
        self.it.zero_()
        self.pg.copy_(self._panel_pg(self._in_panel()))
        self.running.copy_((self.pg > self.tol) & (self.it < self.inner))

    def step(self) -> None:
        from repro_torch.core.solver import _solve_small_qp, _top_block, \
            proj_grad

        op, alpha, g = self.op, self.alpha, self.g
        acc = g.dtype
        in_panel = self._in_panel()
        sc = torch.where(in_panel,
                         torch.abs(proj_grad(alpha, g, self.cvec)),
                         float("-inf"))
        sel = _top_block(sc, self.block)
        # the last panel may hold fewer than ``block`` coordinates: freeze
        # out-of-panel picks (box [0, 0]) so junk rows cannot move them
        valid = in_panel[sel]
        local = torch.clamp(self.key[sel] - self.pstart, 0, self.rows_p - 1)
        kr = self.flat.index_select(0, self.slot * self.rows_p
                                    + local).to(acc)
        Qrows = op.expand_rows(kr, sel)                     # (B, n) signed
        ab = torch.where(valid, alpha[sel], 0.0).to(acc)
        cb = torch.where(valid, self.cvec[sel], 0.0)
        new_ab = _solve_small_qp(Qrows[:, sel][None], g[sel][None], ab[None],
                                 cb[None], self.sweeps)[0]
        delta = torch.where(valid & self.running, new_ab - ab, 0.0)
        alpha.index_add_(0, sel, delta.to(alpha.dtype))
        g.add_(delta @ Qrows)
        self.it += self.running
        self.pg.copy_(torch.where(self.running, self._panel_pg(in_panel),
                                  self.pg))
        self.running &= (self.pg > self.tol) & (self.it < self.inner)


def solve_box_qp_spill(op: GramOperator, C,
                       alpha0: Optional[torch.Tensor] = None,
                       tol: float = 1e-3, max_iters: int = 500,
                       block: int = 64, sweeps: int = 4, p=-1.0,
                       device_budget_bytes: Optional[int] = None,
                       max_rounds: int = 512, timing: Optional[dict] = None,
                       trace=None, graph: Optional[bool] = None):
    """Out-of-core block CD for the box dual: the Gram is bounded by HOST
    memory.

    Raw kernel rows are computed once a panel (``rows_p`` rows sized to
    ``device_budget_bytes``), written through to a host buffer (pinned on
    a CUDA device: the spill tier) and served from a device pool of panel
    slots kept as an LRU.  Each outer round is a Gauss-Seidel sweep over
    the panels, a block-CD sub-solve a panel (``_PanelSolve``: a device
    loop with a ``running`` flag the host reads every ``PANEL_SYNC_EVERY``
    steps, replayed as a CUDA graph on a CUDA device), monotone in the
    global objective because the maintained gradient is exact; the NEXT
    panel's host-to-device copy is issued on a side stream before the
    current sub-solve, so the copy overlaps it.  After every sweep the
    gradient is recomputed from scratch (one streaming matvec) and
    convergence is judged on the full projected gradient.

    Counters on the returned ``SolveResult`` (panel units): ``cache_hits``
    / ``cache_misses`` = device-tier panel hits / panels computed,
    ``cache_evictions`` = device panels dropped, ``spills`` = panels
    written to the host tier, ``spill_hits`` = panels re-loaded from it.

    ``timing`` (a dict) is filled with the rounds and the panel layout, and
    on a CUDA device with the host-to-device bytes and milliseconds of the
    panel copies and the milliseconds of them that overlapped a sub-solve
    (CUDA events).

    ``trace`` (an ``obs.trace.ConvTrace``) records one sample an outer
    round, at the host sync the round ends with anyway: pg_max, the
    objective, the free-set size and the round's device-tier panel hits.
    ``graph`` as in ``solver.solve_box_qp_op`` (the panel step)."""
    from repro_torch.core.solver import (SolveResult, _broadcast, _n_free,
                                         _Stepper, _trace_for, _use_graph,
                                         objective, proj_grad)
    from repro_torch.obs.trace import trace_record

    X = op.Xd
    n = op.n_dual
    dev = X.device
    cuda = dev.type == "cuda"
    graph = _use_graph(graph, dev)
    acc = torch.promote_types(X.dtype, torch.float32)
    budget = (op.budget_bytes if device_budget_bytes is None
              else int(device_budget_bytes))
    store = op.storage_dtype(acc)
    nb = op.kwidth                  # panel row space: base ids under the view
    row_bytes = nb * store.itemsize
    block = max(1, min(block, n))
    rows_p = int(max(block, min(nb, budget // max(row_bytes, 1))))
    starts = list(range(0, nb, rows_p))
    cap_panels = max(1, budget // max(rows_p * row_bytes, 1))
    inner = max(4, rows_p // block)
    op.prepare()

    alpha = (torch.zeros(n, dtype=X.dtype, device=dev) if alpha0 is None
             else _broadcast(alpha0, (n,), X))
    cvec = _broadcast(C, (n,), X)
    pvec = _broadcast(p, (n,), X)

    def fresh_grad():
        return (op.matvec(alpha, via_base=op.dedup) + pvec).to(acc)

    g = fresh_grad()
    # the device tier: a pool of panel slots, at most cap_panels + 1 live
    # (the current panel and the prefetched one)
    nslots = min(cap_panels + 1, len(starts))
    pool = torch.empty((nslots, rows_p, nb), dtype=store, device=dev)
    free = list(range(nslots))
    host: dict = {}
    devt: "OrderedDict[int, int]" = OrderedDict()      # panel -> slot (LRU)
    hits = misses = evictions = spills = spill_hits = 0
    side = torch.cuda.Stream(dev) if cuda else None
    ready: dict = {}                                    # slot -> copy event
    copies, solves = [], []
    ev = (lambda: torch.cuda.Event(enable_timing=True)) if (
        cuda and timing is not None) else None
    t_ref = None
    if ev is not None:
        t_ref = ev()
        t_ref.record()

    def evict_to(cap):
        nonlocal evictions
        while len(devt) > cap:
            _, slot = devt.popitem(last=False)
            free.append(slot)
            evictions += 1

    def load(pid, slot):
        """Copy panel ``pid`` from the host tier into ``slot`` (on the side
        stream on a CUDA device, after the main stream's last use)."""
        dst = pool[slot]
        if not cuda:
            dst.copy_(host[pid])
            return
        main = torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            e0 = ev() if ev is not None else None
            if e0 is not None:
                e0.record()
            dst.copy_(host[pid], non_blocking=True)
            done = torch.cuda.Event(enable_timing=ev is not None)
            done.record()
        ready[slot] = done
        if e0 is not None:
            copies.append((e0, done, host[pid].numel() * store.itemsize))

    def fetch(pid) -> int:
        nonlocal hits, misses, spills, spill_hits
        if pid in devt:
            devt.move_to_end(pid)
            hits += 1
            return devt[pid]
        with span("spill/fetch_panel"):
            evict_to(cap_panels - 1)
            slot = free.pop()
            if pid in host:
                load(pid, slot)
                spill_hits += 1
            else:
                if slot in ready:      # a copy into it may be in flight
                    torch.cuda.current_stream(dev).wait_event(ready.pop(slot))
                keys = torch.clamp(starts[pid] + torch.arange(rows_p,
                                                              device=dev),
                                   0, nb - 1)
                pool[slot].copy_(op.base_rows(keys))
                # write-through host spill
                host[pid] = torch.empty((rows_p, nb), dtype=store,
                                        pin_memory=cuda).copy_(pool[slot])
                spills += 1
                misses += 1
        devt[pid] = slot
        return slot

    ps = _PanelSolve(op, pool, alpha, g, cvec, tol, block, sweeps, inner,
                     rows_p)
    stepper = _Stepper(ps.step, dev, graph)
    tr = _trace_for(trace, (), dev)
    it_total = 0
    pg = float(torch.amax(torch.abs(proj_grad(alpha, g, cvec))))
    rounds = hits_mark = 0
    while pg > tol and it_total < max_iters and rounds < max_rounds:
        for pid in range(len(starts)):
            slot = fetch(pid)
            nxt = (pid + 1) % len(starts)
            if len(starts) > 1 and nxt not in devt and nxt in host:
                # double buffer: the next panel's copy overlaps this
                # panel's sub-solve
                evict_to(cap_panels)
                nslot = free.pop()
                load(nxt, nslot)
                devt[nxt] = nslot
                spill_hits += 1
            if slot in ready:
                torch.cuda.current_stream(dev).wait_event(ready.pop(slot))
            with span("spill/panel_solve"):
                s0 = ev() if ev is not None else None
                if s0 is not None:
                    s0.record()
                ps.start(starts[pid], slot)
                for k in range(inner):
                    if k % PANEL_SYNC_EVERY == 0 and not bool(ps.running):
                        break
                    stepper()
                if s0 is not None:
                    s1 = ev()
                    s1.record()
                    solves.append((s0, s1))
                it_total += int(ps.it)
            if it_total >= max_iters:
                break
        # refresh from scratch: panel sweeps keep the gradient exact in
        # infinite precision, but rounding drift accumulates over rounds
        g.copy_(fresh_grad())
        pg = float(torch.amax(torch.abs(proj_grad(alpha, g, cvec))))
        rounds += 1
        if tr is not None:
            trace_record(tr, pg_max=pg, objective=objective(alpha, g, pvec),
                         n_free=_n_free(alpha, cvec),
                         cache_hits=hits - hits_mark)
            hits_mark = hits
    if timing is not None:
        timing.update(rounds=rounds, panels=len(starts), rows_p=rows_p,
                      cap_panels=cap_panels)
    if ev is not None:
        torch.cuda.synchronize(dev)
        at = lambda e: t_ref.elapsed_time(e)                       # noqa: E731
        spans_ = [(at(a), at(b)) for a, b in solves]
        h2d_ms = hidden = 0.0
        for a, b, _ in copies:
            c0, c1 = at(a), at(b)
            h2d_ms += c1 - c0
            hidden += sum(max(0.0, min(c1, s1) - max(c0, s0))
                          for s0, s1 in spans_)
        timing.update(h2d_bytes=sum(c[2] for c in copies), h2d_ms=h2d_ms,
                      hidden_ms=hidden)
    i64 = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)  # noqa
    return SolveResult(alpha, g, i64(it_total),
                       torch.tensor(pg, dtype=acc, device=dev),
                       cache_hits=i64(hits), cache_misses=i64(misses),
                       cache_evictions=i64(evictions), spills=i64(spills),
                       spill_hits=i64(spill_hits), trace=tr)
