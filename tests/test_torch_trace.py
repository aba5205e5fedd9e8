"""The observability layer: ``obs.trace``'s rings, the traced solvers,
``fit(trace=...)``, ``SpanTracer`` and the train CLI's trace flags, port
vs reference.

The rings are held to the reference's ``trace_fetch``: ``samples`` and
``dropped`` exactly, and every recorded column to 1e-6 relative (both
sides store float32 values of float64 iterates that follow the same path:
the solvers run under ``jax.enable_x64`` against torch float64, where the
CPU solver tests find the same iteration counts).  A traced solve must
give its untraced alpha bit for bit.  A batch of problems that stop at
different iterations records only while each problem runs, as the
reference's vmapped while-loop does.  The spill loop records once an
outer round; its rounds and panel hits are held exactly and its in-panel
paths to the spill tests' 1% (``tests/test_torch_spill.py``).  Sizes are
small (n <= 200).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gramop as JG
from repro.core import solver as JS
from repro.core.kernels import Kernel as JKernel
from repro.obs import trace as JTR
from repro_torch.core import dcsvm as D
from repro_torch.core import gramop
from repro_torch.core import solver as S
from repro_torch.core.kernels import Kernel, gram
from repro_torch.data import gaussian_mixture
from repro_torch.launch import train_svm
from repro_torch.obs import spans as SP
from repro_torch.obs import trace as TR



def _same(got, want, rtol=1e-6, atol=1e-7):
    """A fetched port trace against the reference's fetched trace."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, rtol, atol)
        return
    assert set(got) == set(want), (sorted(got), sorted(want))
    assert (got["samples"], got["dropped"]) == \
        (want["samples"], want["dropped"])
    for col in TR.TRACE_COLS:
        if col in want:
            np.testing.assert_allclose(got[col], want[col], rtol=rtol,
                                       atol=atol, err_msg=col)


def _problem(seed, n=80, d=6, gamma=4.0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    y = np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0)
    sq = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    return X, y, (y[:, None] * y[None, :]) * np.exp(-gamma * sq)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,k", [(8, 5), (8, 8), (8, 21)],
                         ids=["partial", "full", "wrapped"])
def test_ring_matches_reference(cap, k):
    """The same samples (gamma never recorded, cache_hits on odd steps
    only: NaN elsewhere) recorded into both rings: fetch and summary
    equal, chronological after a wrap, with its dropped count."""
    vals = np.random.default_rng(cap + k).uniform(size=(k, 4))
    jt, tt = JTR.trace_init(cap), TR.trace_init(cap)
    for i, (pg, obj, nf, hits) in enumerate(vals):
        h = hits if i % 2 else None
        jt = JTR.trace_record(jt, pg_max=pg, objective=obj, n_free=nf,
                              cache_hits=h)
        TR.trace_record(tt, pg_max=torch.tensor(pg), objective=obj,
                        n_free=torch.tensor(nf), cache_hits=h)
    want, got = JTR.trace_fetch(jt), TR.trace_fetch(tt)
    np.testing.assert_equal(got, want)          # NaN where not recorded
    assert got["dropped"] == max(0, k - cap) and "gamma" not in got
    assert TR.trace_summary(tt) == JTR.trace_summary(want)


def test_ring_batched_where_matches_stacked_reference():
    """A ring of three problems recording under a ``where`` mask equals the
    reference's per-problem rings stacked: nested fetch and merged
    summary."""
    cap, steps = 6, 11
    rng = np.random.default_rng(3)
    vals = rng.uniform(size=(steps, 3, 2))
    live = rng.uniform(size=(steps, 3)) < 0.6
    live[:, 2] = False                      # one problem never records
    tt = TR.trace_init(cap, lead=(3,))
    rings = [JTR.trace_init(cap) for _ in range(3)]
    for s in range(steps):
        TR.trace_record(tt, pg_max=torch.tensor(vals[s, :, 0]),
                        objective=torch.tensor(vals[s, :, 1]),
                        where=torch.tensor(live[s]))
        for b in range(3):
            if live[s, b]:
                rings[b] = JTR.trace_record(rings[b], pg_max=vals[s, b, 0],
                                            objective=vals[s, b, 1])
    stacked = JTR.ConvTrace(jnp.stack([r.buf for r in rings]),
                            jnp.stack([r.count for r in rings]))
    want = JTR.trace_fetch(stacked)
    got = TR.trace_fetch(tt)
    np.testing.assert_equal(got, want)
    assert got[2] == {"samples": 0, "dropped": 0}
    assert TR.trace_summary(got) == JTR.trace_summary(want)


@pytest.mark.parametrize("cap", [0, -3])
def test_ring_capacity_must_be_positive(cap):
    with pytest.raises(ValueError, match="positive"):
        JTR.trace_init(cap)
    with pytest.raises(ValueError, match="positive"):
        TR.trace_init(cap)


# ---------------------------------------------------------------------------
# traced solvers, float64
# ---------------------------------------------------------------------------

def _untraced_equal(traced, plain):
    for f in ("alpha", "grad", "iters", "pg_max"):
        assert torch.equal(getattr(traced, f), getattr(plain, f)), f


@pytest.mark.parametrize("cap", [4096, 40], ids=["all", "wrapped"])
def test_solve_box_qp_trace_matches_reference(cap):
    _, _, Q = _problem(0)
    kw = dict(tol=1e-6, max_iters=3000)
    with jax.enable_x64(True):
        jr = JS.solve_box_qp(jnp.asarray(Q), 2.0, trace=JTR.trace_init(cap),
                             **kw)
        want = JTR.trace_fetch(jr.trace)
        jit = int(jr.iters)
    Qt = torch.tensor(Q)
    got = S.solve_box_qp(Qt, 2.0, trace=TR.trace_init(cap), **kw)
    _untraced_equal(got, S.solve_box_qp(Qt, 2.0, **kw))
    assert int(got.iters) == jit == want["samples"] + want["dropped"]
    _same(TR.trace_fetch(got.trace), want)


@pytest.mark.parametrize("block", [0, 8], ids=["greedy", "block"])
def test_solve_with_shrinking_one_ring_through_rounds(block):
    _, _, Q = _problem(1)
    kw = dict(tol=1e-6, max_iters=3000, rounds=3, block=block)
    with jax.enable_x64(True):
        jr = JS.solve_with_shrinking(jnp.asarray(Q), 1.0,
                                     trace=JTR.trace_init(64), **kw)
        want = JTR.trace_fetch(jr.trace)
        jit = int(jr.iters)
    Qt = torch.tensor(Q)
    got = S.solve_with_shrinking(Qt, 1.0, trace=TR.trace_init(64), **kw)
    _untraced_equal(got, S.solve_with_shrinking(Qt, 1.0, **kw))
    assert int(got.iters) == jit == want["samples"] + want["dropped"]
    _same(TR.trace_fetch(got.trace), want)


def test_batched_solve_records_only_while_running():
    """Three problems stopping at different iterations (tens to hundreds,
    more than ``SYNC_EVERY`` apart): each ring holds its own problem's
    samples, as the reference's vmapped while-loop, not the steps the
    batch keeps taking until the next host read."""
    Qs = np.stack([_problem(s, n=40)[2] for s in range(3)])
    cs = np.array([0.05, 1.0, 4.0])
    kw = dict(tol=1e-7, max_iters=2000)
    with jax.enable_x64(True):
        res = jax.vmap(lambda q, c: JS.solve_box_qp(
            q, c, trace=JTR.trace_init(128), **kw))(jnp.asarray(Qs),
                                                    jnp.asarray(cs))
        want = JTR.trace_fetch(res.trace)
        its = np.asarray(res.iters)
    assert its.max() - its.min() > S.SYNC_EVERY
    got = S.solve_box_qp(torch.tensor(Qs), torch.tensor(cs)[:, None],
                         trace=TR.trace_init(128), **kw)
    np.testing.assert_array_equal(got.iters.numpy(), its)
    fetched = TR.trace_fetch(got.trace)
    assert [f["samples"] + f["dropped"] for f in fetched] == its.tolist()
    _same(fetched, want)


@pytest.mark.parametrize("cache_cap", [0, 48], ids=["uncached", "cached"])
def test_solve_box_qp_op_trace_matches_reference(cache_cap):
    rng = np.random.default_rng(5)
    n = 200
    X = rng.normal(size=(n, 5))
    y = np.sign(rng.normal(size=n))
    kw = dict(max_iters=400, block=16, cache_cap=cache_cap, tol=1e-5)
    with jax.enable_x64(True):
        jr = JS.solve_box_qp_matvec(jnp.asarray(X), jnp.asarray(y),
                                    JKernel("rbf", gamma=0.5), 1.0,
                                    trace=JTR.trace_init(100), **kw)
        want = JTR.trace_fetch(jr.trace)
        jit = int(jr.iters)
    args = (torch.tensor(X), torch.tensor(y), Kernel("rbf", gamma=0.5), 1.0)
    got = S.solve_box_qp_matvec(*args, trace=TR.trace_init(100), **kw)
    plain = S.solve_box_qp_matvec(*args, **kw)
    _untraced_equal(got, plain)
    assert int(got.iters) == jit
    fetched = TR.trace_fetch(got.trace)
    assert ("cache_hits" in fetched) == (cache_cap > 0)
    if cache_cap:
        assert torch.equal(got.cache_hits, plain.cache_hits)
        assert 0 < sum(want["cache_hits"]) <= int(jr.cache_hits)
    _same(fetched, want)


@pytest.mark.parametrize("engine", ["dense", "matvec"])
def test_equality_loop_trace_matches_reference(engine):
    """The pairwise engine (one sample a pair step: the gap, and the
    objective before the step), dense and Gram-free."""
    X, y, Q = _problem(2, n=60, gamma=16.0)
    d = np.array([0.3 * 60])
    kw = dict(tol=1e-5, max_iters=3000)
    with jax.enable_x64(True):
        if engine == "dense":
            jr = JS.solve_eq_qp(jnp.asarray(Q), 1.0, 1.0, jnp.asarray(d),
                                trace=JTR.trace_init(256), **kw)
        else:
            jr = JS.solve_eq_qp_matvec(jnp.asarray(X), jnp.asarray(y),
                                       JKernel("rbf", gamma=16.0), 1.0, 1.0,
                                       jnp.asarray(d),
                                       trace=JTR.trace_init(256), **kw)
        want = JTR.trace_fetch(jr.trace)
        jit = int(jr.iters)

    def run(trace=None):
        if engine == "dense":
            return S.solve_eq_qp(torch.tensor(Q), 1.0, 1.0, torch.tensor(d),
                                 trace=trace, **kw)
        return S.solve_eq_qp_matvec(torch.tensor(X), torch.tensor(y),
                                    Kernel("rbf", gamma=16.0), 1.0, 1.0,
                                    torch.tensor(d), trace=trace, **kw)

    got = run(TR.trace_init(256))
    _untraced_equal(got, run())
    assert int(got.iters) == jit == want["samples"] + want["dropped"]
    _same(TR.trace_fetch(got.trace), want)


def test_blocked_equality_and_shrinking_rings():
    """The blocked engine (held to the optimum, not the path, in the
    equality tests) records one sample an outer iteration, through every
    shrinking round, and changes nothing untraced."""
    _, _, Q = _problem(3, n=60, gamma=16.0)
    kw = dict(tol=1e-7, max_iters=3000, block=4, sweeps=2)
    Qt = torch.tensor(Q)
    got = S.solve_eq_qp_shrink(Qt, 1.0, 1.0, 18.0, trace=TR.trace_init(8),
                               **kw)
    _untraced_equal(got, S.solve_eq_qp_shrink(Qt, 1.0, 1.0, 18.0, **kw))
    f = TR.trace_fetch(got.trace)
    assert f["samples"] == 8 and f["samples"] + f["dropped"] == int(got.iters)
    assert set(f) == {"samples", "dropped", "pg_max", "objective", "n_free"}


def test_spill_trace_matches_reference():
    """One sample an outer round at its host sync (12 rounds, the cap):
    each round's device-tier panel hits exactly (they add up to the
    solve's), the objective to 2e-7 relative (an ulp of the float32 ring:
    the float64 objectives part in their last bits), the first round's
    pg_max to 1e-6 (the in-panel paths may part by ulps after it, as the
    spill tests find)."""
    rng = np.random.default_rng(14)
    n = 160
    X = rng.uniform(-0.7, 0.7, (n, 6))
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    kw = dict(tol=1e-4, max_iters=20_000, block=16, max_rounds=12,
              device_budget_bytes=48 * n * 8)
    with jax.enable_x64(True):
        jop = JG.GramOperator(Xd=jnp.asarray(X), s=jnp.asarray(y),
                              kernel=JKernel("rbf", gamma=0.5))
        jr = JG.solve_box_qp_spill(jop, 1.0, trace=JTR.trace_init(256), **kw)
        want = JTR.trace_fetch(jr.trace)
    top = gramop.GramOperator(Xd=torch.tensor(X), s=torch.tensor(y),
                              kernel=Kernel("rbf", gamma=0.5))
    got = gramop.solve_box_qp_spill(top, 1.0, trace=TR.trace_init(256), **kw)
    _untraced_equal(got, gramop.solve_box_qp_spill(top, 1.0, **kw))
    f = TR.trace_fetch(got.trace)
    assert set(f) == set(want)
    assert (f["samples"], f["dropped"]) == (want["samples"], want["dropped"])
    assert f["samples"] == 12 and f["dropped"] == 0
    assert f["cache_hits"] == want["cache_hits"]
    assert sum(f["cache_hits"]) == int(got.cache_hits)
    np.testing.assert_allclose(f["objective"], want["objective"], rtol=2e-7)
    np.testing.assert_allclose(f["pg_max"][0], want["pg_max"][0], rtol=1e-6)


# ---------------------------------------------------------------------------
# fit(trace=...)
# ---------------------------------------------------------------------------

CFG = dict(C=1.0, k=2, levels=1, m=40, tol=1e-3, max_iters=400, seed=3,
           refine=False)


def _data():
    return gaussian_mixture(np.random.default_rng(1), 120, d=4,
                            modes_per_class=2)


def test_fit_trace_matches_reference_x64():
    """Level 0's dense engine traced inside ``fit``: its fetched list of one
    class ring equals the reference's ring of the same engine
    (``solve_with_shrinking``, one ring through its rounds, stacked as the
    reference's class ``vmap`` stacks it) on the same Q and warm start (the
    fit's level-1 alpha; no refine pass), in float64, the summary too; and
    alpha is bit for bit the untraced fit's."""
    X, y = _data()
    kern = Kernel("rbf", gamma=1.0)
    level1 = {}
    tm = [D.fit(D.DCSVMConfig(kernel=kern, use_kernels=False, trace=t, **CFG),
                X, y, device="cpu", dtype=torch.float64,
                callback=lambda l, a, st, t=t: level1.setdefault(
                    (t, l), a.clone()))
          for t in (16, None)]
    assert torch.equal(tm[0].alpha, tm[1].alpha)
    st, st0 = tm[0].level_stats[-1], tm[1].level_stats[-1]
    assert "trace" not in st0 and "trace_summary" not in st0
    Xt = torch.tensor(X, dtype=torch.float64)
    yt = torch.tensor(y, dtype=torch.float64)
    Q = yt[:, None] * gram(kern, Xt, Xt) * yt[None, :]
    with jax.enable_x64(True):
        jr = JS.solve_with_shrinking(
            jnp.asarray(Q.numpy()), CFG["C"],
            alpha0=jnp.asarray(level1[16, 1].numpy()), tol=CFG["tol"],
            max_iters=CFG["max_iters"], rounds=3, trace=JTR.trace_init(16))
        want = JTR.trace_fetch(JTR.ConvTrace(jr.trace.buf[None],
                                             jr.trace.count[None]))
        assert st["iters"] == int(jr.iters) > 16
    assert isinstance(st["trace"], list) and len(st["trace"]) == 1
    _same(st["trace"], want)
    jsum = JTR.trace_summary(want)
    assert set(st["trace_summary"]) == set(jsum)
    np.testing.assert_allclose([st["trace_summary"][k] for k in sorted(jsum)],
                               [jsum[k] for k in sorted(jsum)], rtol=1e-6)


@pytest.mark.parametrize("extra", [{"full_gram_threshold": 32},
                                   {"full_gram_threshold": 32,
                                    "col_cache_cap": 64, "block": 16},
                                   {"host_spill": True,
                                    "gram_budget": 40 * 120 * 4,
                                    "max_iters": 40}],
                         ids=["matvec", "cached", "spill"])
def test_fit_trace_other_level0_engines(extra):
    """The Gram-free, cached and spill level-0 engines traced in a fit:
    alpha bit for bit the untraced fit's, one ring a class."""
    X, y = _data()
    cfg = dict(CFG, kernel=Kernel("rbf", gamma=1.0), use_kernels=False,
               **extra)
    m1 = D.fit(D.DCSVMConfig(trace=8, **cfg), X, y, device="cpu")
    m0 = D.fit(D.DCSVMConfig(**cfg), X, y, device="cpu")
    assert torch.equal(m1.alpha, m0.alpha)
    st = m1.level_stats[-1]
    (f,) = st["trace"]
    assert 0 < f["samples"] <= 8
    assert st["trace_summary"]["samples"] == f["samples"]
    if "host_spill" not in extra:
        assert f["samples"] + f["dropped"] == st["iters"]
    assert ("cache_hits" in f) == ("col_cache_cap" in extra
                                   or "host_spill" in extra)


# ---------------------------------------------------------------------------
# spans and the CLI
# ---------------------------------------------------------------------------

def test_span_tree_chrome_trace_schema(tmp_path):
    tracer, timer = SP.SpanTracer(), SP.SpanTimer()
    with tracer.activate(), timer.activate():
        with SP.span("fit"):
            with SP.span("divide/level1/solve"):
                pass
            with SP.span("conquer/solve"):
                pass
    with SP.span("outside"):                        # inactive: not recorded
        pass
    events = tracer.chrome_trace()["traceEvents"]
    assert [e["name"] for e in events][0] == "fit"
    assert {e["name"] for e in events} == {"fit", "divide/level1/solve",
                                           "conquer/solve"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert all(events[i]["ts"] <= events[i + 1]["ts"]
               for i in range(len(events) - 1))
    fit_ev = next(e for e in events if e["name"] == "fit")
    child_dur = sum(e["dur"] for e in events if e["name"] != "fit")
    assert fit_ev["dur"] >= child_dur * (1 - 1e-6)
    path = tmp_path / "trace.json"
    tracer.write_chrome_trace(str(path))
    assert json.loads(path.read_text())["traceEvents"]
    table = tracer.summary()
    assert "fit" in table and "conquer/solve" in table
    # the timer's totals still come with the tracer
    assert set(timer.totals) == {"fit", "divide/level1/solve",
                                 "conquer/solve"}


def test_span_nesting_restores_active_tracer():
    t1, t2 = SP.SpanTracer(), SP.SpanTracer()
    with t1.activate():
        with SP.span("outer"):
            with t2.activate():
                with SP.span("inner"):
                    pass
            with SP.span("outer2"):
                pass
    assert {s.name for s in t1.roots} == {"outer"}
    assert {s.name for s in t2.roots} == {"inner"}
    assert [c.name for c in t1.roots[0].children] == ["outer2"]
    assert SP._TRACER is None


def test_train_cli_trace_flags(tmp_path, capsys):
    trace, stats = tmp_path / "fit.json", tmp_path / "stats.json"
    train_svm.main(["--n", "300", "--levels", "1", "--device", "cpu",
                    "--trace", str(trace), "--trace-cap", "32",
                    "--stats-json", str(stats)])
    out = capsys.readouterr().out
    assert "chrome trace ->" in out and "conquer/solve" in out
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"divide/level1/cluster", "divide/level1/solve",
            "conquer/solve"} <= names
    payload = json.loads(stats.read_text())
    st = payload["levels"][-1]
    assert st["level"] == 0 and len(st["trace"]) == 1
    assert st["trace"][0]["samples"] == min(32, st["iters"])
    assert st["trace_summary"]["samples"] == st["trace"][0]["samples"]
