"""Every task the reference fits, through the port, vs the JAX reference.

The same numpy inputs go through ``repro`` and ``repro_torch``; the port
gets the reference's own k-means draws (``tests/test_torch_fit.py``'s
``jax_draws``), so both run the same Algorithm 1.

Fits, in float64 (``jax.enable_x64`` / ``dtype=torch.float64``): the box
tasks (weighted C-SVC, epsilon-SVR with its dedup view) and nu-SVC without
the bias take the reference's coordinate path at tol 1e-5: equal level-0
``iters`` and every level's alpha to 1e-8.  One-class SVM and nu-SVC with
the bias meet exact ties of the multiplier bounds h after pair steps, where
ulps decide the pair (their batched cluster solves differ by 2e-7 from the
reference's after ~30 steps at tol 1e-6), so they are held to the optimum
at tol 1e-9: alpha to 1e-8, rho to 1e-8.  Predictions are compared where
the decision is clear of 0 by 1e-6 (free support vectors of a task with an
offset sit on f = 0).  In float32 at tol 1e-5, alpha to 2e-4 (the f32
paths part early and stop at gaps below tol, at points 1e-4 apart along
the flattest directions) and the same predictions off the boundary.  The one-class data's
tight modes (spread 0.06) run at gamma 50, where K is far from singular:
at gamma 8 a mode's points have K ~ 0.97 and the dual's optimum is not
unique, so float32 rounding alone moves alpha by 1e-4 along flat directions.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds as JB
from repro.core import dcsvm as JD
from repro.core import gramop as JG
from repro.core import predict as JP
from repro.core import solver as JS
from repro.core import tasks as JT
from repro.core.kernels import Kernel as JKernel
from repro.core.kkmeans import assign_points as jassign
from repro_torch import convert, data
from repro_torch.core import bounds as B
from repro_torch.core import dcsvm as D
from repro_torch.core import gramop
from repro_torch.core import predict as P
from repro_torch.core import solver as S
from repro_torch.core import tasks as T
from repro_torch.core.kernels import Kernel
from repro_torch.core.kkmeans import assign_points

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_fit import jax_draws  # noqa: E402

CFG = dict(C=4.0, k=4, levels=2, m=120, max_iters=20000, seed=3)
BRANCHES = {"dense": {}, "matvec": {"full_gram_threshold": 64}}


def _datasets():
    rng = np.random.default_rng(0)
    return {
        "weighted-svc": (data.gaussian_mixture_imbalanced(
            rng, 400, d=8, pos_frac=0.2), 8.0,
            (JT.WeightedCSVC(w_pos=4.0), T.WeightedCSVC(w_pos=4.0))),
        "svr": (data.friedman1(rng, 300, d=6), 2.0,
                (JT.EpsilonSVR(eps=0.1), T.EpsilonSVR(eps=0.1))),
        "ocsvm": (data.gaussian_with_outliers(rng, 400), 50.0,
                  (JT.OneClassSVM(nu=0.2), T.OneClassSVM(nu=0.2))),
        "nu-svc": (data.gaussian_mixture(rng, 400, d=8, modes_per_class=4,
                                         spread=0.15), 8.0,
                   (JT.NuSVC(nu=0.3), T.NuSVC(nu=0.3))),
        "nu-svc-bias": (data.gaussian_mixture(rng, 400, d=8,
                                              modes_per_class=4,
                                              spread=0.15), 8.0,
                        (JT.NuSVC(nu=0.3, with_bias=True),
                         T.NuSVC(nu=0.3, with_bias=True))),
    }


DATA = _datasets()
EXACT = {"weighted-svc", "svr", "nu-svc"}     # the reference's path, tol 1e-5


def _fit_pair(name, x64, extra, tol=None):
    (X, y), gamma, (jt, tt) = DATA[name]
    if tol is None:
        tol = 1e-5 if (name in EXACT or not x64) else 1e-9
    yy = None if name == "ocsvm" else y
    jl, tl = {}, {}
    with jax.enable_x64(x64):
        jcfg = JD.DCSVMConfig(kernel=JKernel("rbf", gamma=gamma),
                              use_pallas=False, tol=tol, **CFG, **extra)
        Xj = X.astype(np.float64 if x64 else np.float32)
        jm = JD.fit(jcfg, Xj, yy, task=jt, callback=lambda l, a, st:
                    jl.__setitem__(l, (np.asarray(a), st.get("iters"))))
        jm = dataclasses.replace(jm, alpha=np.asarray(jm.alpha),
                                 beta=np.asarray(jm.beta))
    tcfg = D.DCSVMConfig(kernel=Kernel("rbf", gamma=gamma), use_kernels=False,
                         tol=tol, **CFG, **extra)
    tm = D.fit(tcfg, X, yy, task=tt, device="cpu",
               dtype=torch.float64 if x64 else torch.float32,
               draws=jax_draws(CFG["seed"], CFG["m"]),
               callback=lambda l, a, st: tl.__setitem__(
                   l, (a.numpy().copy(), st.get("iters"))))
    return jm, tm, jl, tl


@pytest.fixture(scope="module")
def x64_fits():
    return {(name, b): _fit_pair(name, True, extra)
            for name in DATA for b, extra in BRANCHES.items()}


# ---------------------------------------------------------------------------
# the reduction of every task
# ---------------------------------------------------------------------------

TASKS = [("svc", JT.CSVC(), T.CSVC()),
         ("weighted-svc", JT.WeightedCSVC(w_pos=3.0, w_neg=0.5,
                                          sample_weight=np.linspace(1, 2, 30)),
          T.WeightedCSVC(w_pos=3.0, w_neg=0.5,
                         sample_weight=np.linspace(1, 2, 30))),
         ("svr", JT.EpsilonSVR(eps=0.2), T.EpsilonSVR(eps=0.2)),
         ("ocsvm", JT.OneClassSVM(nu=0.3), T.OneClassSVM(nu=0.3)),
         ("nu-svc", JT.NuSVC(nu=0.4), T.NuSVC(nu=0.4)),
         ("nu-svc-bias", JT.NuSVC(nu=0.4, with_bias=True),
          T.NuSVC(nu=0.4, with_bias=True))]


@pytest.mark.parametrize("name,jt,tt", TASKS, ids=[t[0] for t in TASKS])
def test_task_reduction_matches_reference(name, jt, tt):
    """build, the dual's properties, base_view, collapse and recover_offset
    of every task, in float64."""
    rng = np.random.default_rng(1)
    X = rng.uniform(size=(30, 4))
    y = np.where(rng.uniform(size=30) < 0.5, 1.0, -1.0)
    if name == "svr":
        y = rng.standard_normal(30)
    with jax.enable_x64(True):
        jd = jt.build(jnp.asarray(X), jnp.asarray(y)[None], 2.0)
        nd = jd.n_dual
        u = rng.uniform(0, 1, nd) * np.asarray(jd.Cvec[0])
        g = rng.standard_normal(nd)
        want = {f: np.asarray(getattr(jd, f)) for f in ("Xd", "S", "P", "Cvec")}
        want.update(base_index=np.asarray(jd.base_index),
                    n_groups=jd.n_groups, has_equality=jd.has_equality,
                    n_base=jd.n_base, group_ids=np.asarray(jd.group_ids),
                    collapse=np.asarray(jd.collapse(jnp.asarray(u)[None])))
        Xb, bidx = jd.base_view()
        want.update(Xb=np.asarray(Xb), bidx=np.asarray(bidx))
        if jd.has_equality:
            want.update(A=np.asarray(jd.A), Deq=np.asarray(jd.Deq),
                        offset=float(jt.recover_offset(
                            jnp.asarray(u), jnp.asarray(g), jd.Cvec[0],
                            jd.A[0], jd.group_ids[0])))
    td = tt.build(torch.tensor(X), torch.tensor(y)[None], 2.0)
    got = {f: getattr(td, f).numpy() for f in ("Xd", "S", "P", "Cvec")}
    got.update(base_index=np.asarray(td.base_index), n_groups=td.n_groups,
               has_equality=td.has_equality, n_base=td.n_base,
               group_ids=td.group_ids.numpy(),
               collapse=td.collapse(torch.tensor(u)[None]).numpy())
    Xb, bidx = td.base_view()
    got.update(Xb=Xb.numpy(), bidx=bidx.numpy())
    if td.has_equality:
        got.update(A=td.A.numpy(), Deq=td.Deq.numpy(),
                   offset=float(tt.recover_offset(
                       torch.tensor(u), torch.tensor(g), td.Cvec[0], td.A[0],
                       td.group_ids[0])))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=0, atol=1e-12, err_msg=k)
    assert (tt.label_free, tt.is_regression, tt.has_rho_offset) == \
        (jt.label_free, jt.is_regression, jt.has_rho_offset)


def test_infeasible_nu_raises():
    y = torch.tensor([[1.0, -1.0, -1.0, -1.0]])
    with pytest.raises(ValueError, match="2 min"):
        T.NuSVC(nu=0.9, with_bias=True).build(torch.zeros(4, 2), y, 1.0)
    with pytest.raises(ValueError, match="nu must lie"):
        T.OneClassSVM(nu=0.0).build(torch.zeros(4, 2), y, 1.0)
    with pytest.raises(ValueError, match="requires labels"):
        D.fit(D.DCSVMConfig(), np.zeros((8, 2)), None, device="cpu",
              task=T.NuSVC())


def test_nu_svc_bias_offset_of_a_one_group_cluster():
    """A group with no coordinates (a one-class cluster of an early model)
    takes the present group's level: offset 0, as the reference."""
    u = torch.tensor([0.5, 0.2], dtype=torch.float64)
    g = torch.tensor([0.3, 0.3], dtype=torch.float64)
    one = torch.ones(2, dtype=torch.float64)
    off = T.NuSVC(nu=0.5, with_bias=True).recover_offset(
        u, g, one, one, torch.zeros(2, dtype=torch.long))
    with jax.enable_x64(True):
        want = JT.NuSVC(nu=0.5, with_bias=True).recover_offset(
            jnp.asarray(u.numpy()), jnp.asarray(g.numpy()), jnp.ones(2),
            jnp.ones(2), jnp.zeros(2, jnp.int32))
    assert float(off) == float(want) == 0.0


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("name", sorted(DATA))
def test_fit_matches_reference_x64(x64_fits, name, branch):
    jm, tm, jl, tl = x64_fits[name, branch]
    assert sorted(tl) == sorted(jl) == [0, 1, 2]
    for level in jl:
        np.testing.assert_allclose(tl[level][0], jl[level][0], rtol=0,
                                   atol=1e-8, err_msg=f"level {level}")
    if name in EXACT:
        assert tl[0][1] == jl[0][1]
    np.testing.assert_allclose(tm.beta.numpy(), jm.beta, rtol=0, atol=1e-8)
    assert (tm.rho is None) == (jm.rho is None)
    if jm.rho is not None:
        assert abs(tm.rho - jm.rho) <= 1e-8 * (1 + abs(jm.rho))
    assert [st["n_sv"] for st in tm.level_stats] == \
        [st["n_sv"] for st in jm.level_stats]
    (X, _), _, _ = DATA[name]
    Xq = X[:64]
    with jax.enable_x64(True):
        want = np.asarray(JP.decision_exact(jm, jnp.asarray(Xq, jnp.float64),
                                            use_pallas=False))
        want_pred = np.asarray(JP.predict_exact(jm, jnp.asarray(Xq,
                                                                jnp.float64)))
    got = P.decision_exact(tm, Xq).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    if name == "svr":           # the prediction is the decision
        np.testing.assert_allclose(P.predict_exact(tm, Xq).numpy(),
                                   want_pred, rtol=0, atol=1e-7)
    else:
        clear = np.abs(want) > 1e-6
        assert clear.sum() >= 48
        np.testing.assert_array_equal(P.predict_exact(tm, Xq).numpy()[clear],
                                      want_pred[clear])


@pytest.mark.parametrize("extra", [{}, {"eq_block_size": 4},
                                   {"eq_block_size": 4,
                                    "full_gram_threshold": 64}],
                         ids=["pairwise", "blocked-dense", "blocked-matvec"])
@pytest.mark.parametrize("name", ["ocsvm", "nu-svc-bias"])
def test_equality_fit_blocked_and_f32(name, extra):
    """The blocked engine (B = 4) in float64 at tol 1e-9, and float32 at
    tol 1e-5 (alpha to 2e-4, the same predictions off the boundary)."""
    if extra:
        jm, tm, jl, tl = _fit_pair(name, True, extra)
        for level in jl:
            np.testing.assert_allclose(tl[level][0], jl[level][0], rtol=0,
                                       atol=1e-8, err_msg=f"level {level}")
        assert abs(tm.rho - jm.rho) <= 1e-8 * (1 + abs(jm.rho))
        return
    jm, tm, jl, tl = _fit_pair(name, False, {})
    for level in jl:
        np.testing.assert_allclose(tl[level][0], jl[level][0], rtol=0,
                                   atol=2e-4, err_msg=f"level {level}")
    assert abs(tm.rho - jm.rho) <= 1e-4 * (1 + abs(jm.rho))
    (X, _), _, _ = DATA[name]
    want = np.asarray(JP.decision_exact(jm, jnp.asarray(X[:64]),
                                        use_pallas=False))
    got = P.decision_exact(tm, X[:64]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    clear = np.abs(want) > 1e-3
    np.testing.assert_array_equal(np.where(got >= 0, 1, -1)[clear],
                                  np.where(want >= 0, 1, -1)[clear])


@pytest.mark.parametrize("name", ["weighted-svc", "svr", "nu-svc"])
def test_box_and_bias_free_fits_f32(name):
    jm, tm, jl, tl = _fit_pair(name, False, BRANCHES["matvec"])
    for level in jl:
        np.testing.assert_allclose(tl[level][0], jl[level][0], rtol=0,
                                   atol=2e-4, err_msg=f"level {level}")
    np.testing.assert_allclose(tm.beta.numpy(), jm.beta, rtol=0, atol=2e-4)


@pytest.mark.parametrize("name", ["ocsvm", "nu-svc-bias", "svr"])
def test_early_model_matches_reference(name):
    """early_stop_level = 1: per-cluster offsets rho_c (equality tasks) and
    eq.-11 decisions, in float64; BCM with the same offsets."""
    jm, tm, _, _ = _fit_pair(name, True, {"early_stop_level": 1})
    assert tm.is_early and jm.is_early
    np.testing.assert_array_equal(tm.partition.assign,
                                  np.asarray(jm.partition.assign))
    if jm.rho_clusters is not None:
        assert tm.rho_clusters.shape == (tm.partition.k,)
        np.testing.assert_allclose(tm.rho_clusters.numpy(),
                                   np.asarray(jm.rho_clusters), rtol=0,
                                   atol=1e-8 * (1 + abs(jm.rho)))
    (X, _), _, _ = DATA[name]
    Xq = X[:96]
    with jax.enable_x64(True):
        Xj = jnp.asarray(Xq, jnp.float64)
        want = np.asarray(JP.decision_early(jm, Xj, use_pallas=False))
        want_bcm = np.asarray(JP.decision_bcm(jm, Xj))
    np.testing.assert_allclose(P.decision_early(tm, Xq).numpy(), want,
                               rtol=0, atol=1e-7)
    # the reference's BCM returns float32
    np.testing.assert_allclose(P.decision_bcm(tm, Xq).numpy(), want_bcm,
                               rtol=1e-5, atol=1e-5)


def test_fit_rejects_a_task_without_reduction():
    @dataclasses.dataclass(frozen=True)
    class NoBuild(T.Task):
        name = "none"

    with pytest.raises(NotImplementedError):
        D.fit(D.DCSVMConfig(), np.zeros((8, 2)), np.ones(8), device="cpu",
              task=NoBuild())


# ---------------------------------------------------------------------------
# the dedup view
# ---------------------------------------------------------------------------

def test_dedup_operator_matches_reference():
    """Every access of the base-indexed view against the reference's, on
    SVR's [X; X] dual in float64, and bit-equal to the direct operator."""
    rng = np.random.default_rng(2)
    X = rng.uniform(size=(20, 3))
    s = np.concatenate([np.ones(20), -np.ones(20)])
    Xd = np.concatenate([X, X])
    bidx = np.concatenate([np.arange(20), np.arange(20)])
    idx = np.array([3, 25, 7, 39])
    v = rng.standard_normal(40)
    delta = rng.standard_normal(4)
    kw = dict(kind="rbf", gamma=3.0)
    with jax.enable_x64(True):
        jop = JG.GramOperator(Xd=jnp.asarray(Xd), s=jnp.asarray(s),
                              Xb=jnp.asarray(X),
                              bidx=jnp.asarray(bidx, jnp.int32),
                              kernel=JKernel(**kw))
        ji = jnp.asarray(idx)
        want = {"kernel_rows": jop.kernel_rows(ji),
                "expand_rows": jop.expand_rows(jop.kernel_rows(ji), ji),
                "q_rows": jop.q_rows(ji), "q_block": jop.q_block(ji),
                "qbb": jop.qbb(ji), "qdiag": jop.qdiag(),
                "matvec": jop.matvec(jnp.asarray(v), num_chunks=3),
                "matvec_base": jop.matvec(jnp.asarray(v), via_base=True),
                "col_update": jop.col_update(jnp.asarray(v), ji,
                                             jnp.asarray(delta)),
                "cache_keys": jop.cache_keys(ji)}
        want = {k: np.asarray(w) for k, w in want.items()}
        kwidth = jop.kwidth
    top = gramop.GramOperator(Xd=torch.tensor(Xd), s=torch.tensor(s),
                              Xb=torch.tensor(X), bidx=torch.tensor(bidx),
                              kernel=Kernel(**kw))
    ti = torch.tensor(idx)
    got = {"kernel_rows": top.kernel_rows(ti),
           "expand_rows": top.expand_rows(top.kernel_rows(ti), ti),
           "q_rows": top.q_rows(ti), "q_block": top.q_block(ti),
           "qbb": top.qbb(ti), "qdiag": top.qdiag(),
           "matvec": top.matvec(torch.tensor(v), num_chunks=3),
           "matvec_base": top.matvec(torch.tensor(v), via_base=True),
           "col_update": top.col_update(torch.tensor(v), ti,
                                        torch.tensor(delta)),
           "cache_keys": top.cache_keys(ti)}
    assert top.kwidth == kwidth == 20 and top.dedup
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-12, err_msg=k)
    direct = gramop.GramOperator(Xd=torch.tensor(Xd), s=torch.tensor(s),
                                 kernel=Kernel(**kw))
    assert torch.equal(top.q_rows(ti), direct.q_rows(ti))
    # the kernel route (float32, as the kernels): cd_column_update over the
    # base rows with y = 1, gathered (the plain versions on the CPU)
    f32 = {f: getattr(top, f).float() for f in ("Xd", "s", "Xb")}
    kop = dataclasses.replace(top, use_kernels=True, **f32)
    np.testing.assert_allclose(
        kop.col_update(torch.tensor(v, dtype=torch.float32), ti,
                       torch.tensor(delta, dtype=torch.float32)).numpy(),
        want["col_update"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_box_matvec_under_dedup_matches_reference(use_kernels):
    """The Gram-free block CD on SVR's dual with the dedup view: float64
    plain (equal iters, alpha to 1e-8) and float32 through the kernel
    wrappers (alpha to 1e-5 of the box C = 2)."""
    X, y = data.friedman1(np.random.default_rng(4), 45, d=5)
    x64 = not use_kernels
    with jax.enable_x64(x64):
        jt = JT.EpsilonSVR(eps=0.1).build(jnp.asarray(X, jnp.float64 if x64
                                                      else jnp.float32),
                                          jnp.asarray(y)[None], 2.0)
        Xb, bidx = jt.base_view()
        res = JS.solve_box_qp_matvec(
            jt.Xd, jt.S[0], JKernel("rbf", gamma=2.0), jt.Cvec[0],
            tol=1e-5, max_iters=400, block=8, sweeps=2, grad_chunks=3,
            use_pallas=use_kernels, p=jt.P[0], Xbase=Xb, base_index=bidx)
        want_a, want_i = np.asarray(res.alpha), int(res.iters)
    td = T.EpsilonSVR(eps=0.1).build(
        torch.tensor(X, dtype=torch.float64 if x64 else torch.float32),
        torch.tensor(y)[None], 2.0)
    Xb, bidx = td.base_view()
    got = S.solve_box_qp_matvec(td.Xd, td.S[0], Kernel("rbf", gamma=2.0),
                                td.Cvec[0], tol=1e-5, max_iters=400, block=8,
                                sweeps=2, grad_chunks=3,
                                use_kernels=use_kernels, p=td.P[0],
                                Xbase=Xb, base_index=bidx)
    if x64:
        assert int(got.iters) == want_i
    np.testing.assert_allclose(got.alpha.numpy(), want_a, rtol=0,
                               atol=1e-8 if x64 else 2e-5)


# ---------------------------------------------------------------------------
# bounds, carried models, data
# ---------------------------------------------------------------------------

def test_bounds_match_reference():
    """Theorems 1-3 and the one-class early gap bound on an early and an
    exact one-class model, in float64; the measured bound holds."""
    jm_e, tm_e, _, _ = _fit_pair("ocsvm", True, {"early_stop_level": 1})
    jm, tm, _, _ = _fit_pair("ocsvm", True, {})
    (X, _), gamma, _ = DATA["ocsvm"]
    assign = tm_e.partition.assign
    subset = np.arange(0, 400, 3)
    X = X.astype(np.float64)
    Xq = X[:50]
    kern, jk = Kernel("rbf", gamma=gamma), JKernel("rbf", gamma=gamma)
    Xt = torch.tensor(X)
    cid = assign_points(kern, tm_e.partition.model, Xt[:50])[0].numpy()
    with jax.enable_x64(True):
        Xj = jnp.asarray(X)
        jcid = np.asarray(jassign(jk, jm_e.partition.model, Xj[:50])[0])
        want = [float(JB.d_pi(jk, Xj, jnp.asarray(assign))),
                float(JB.d_pi_subset(jk, Xj, jnp.asarray(assign),
                                     jnp.asarray(subset))),
                JB.theorem1_bound(jk, Xj, assign, 4.0),
                JB.theorem3_bound(jk, Xj, assign, 4.0, subset),
                JB.theorem2_margin(jk, Xj, assign, 4.0, 1e-3)]
        jgap = JB.oneclass_early_gap_bound(
            jk, Xj, assign, jm_e.alpha, jm.rho, jm_e.rho_clusters,
            Xj[:50], jcid, 1e-3, alpha_exact=jm.alpha)
    np.testing.assert_array_equal(cid, jcid)
    got = [float(B.d_pi(kern, Xt, assign)),
           float(B.d_pi_subset(kern, Xt, assign, subset)),
           B.theorem1_bound(kern, Xt, assign, 4.0),
           B.theorem3_bound(kern, Xt, assign, 4.0, subset),
           B.theorem2_margin(kern, Xt, assign, 4.0, 1e-3)]
    np.testing.assert_allclose(got, want, rtol=1e-10)
    gap = B.oneclass_early_gap_bound(kern, Xt, assign, tm_e.alpha, tm.rho,
                                     tm_e.rho_clusters, Xt[:50], cid, 1e-3,
                                     alpha_exact=tm.alpha)
    assert set(gap) == set(jgap)
    for k in jgap:
        assert abs(gap[k] - jgap[k]) <= 1e-7 * (1 + abs(jgap[k])), k
    err = np.abs(P.decision_early(tm_e, Xq).numpy()
                 - P.decision_exact(tm, Xq).numpy()).max()
    assert err <= gap["bound_measured"] <= gap["bound"]


@pytest.mark.parametrize("name", ["svr", "ocsvm", "nu-svc-bias"])
def test_carried_model_predicts_the_same(x64_fits, name):
    """A JAX-fitted model of each task carried over by
    ``convert.from_jax_arrays`` (task, beta, rho, rho_clusters)."""
    jm, _, _, _ = x64_fits[name, "dense"]
    _, gamma, (jt, _) = DATA[name]
    p = jm.partition
    arrays = {"X": jm.X, "y": jm.y, "alpha": jm.alpha, "beta": jm.beta,
              "assign": p.assign, "idx": p.idx, "mask": p.mask,
              "Xm": p.model.Xm, "W": p.model.W, "s": p.model.s,
              "rho": jm.rho, "rho_clusters": jm.rho_clusters}
    params = {f.name: getattr(jt, f.name) for f in dataclasses.fields(jt)}
    tm = convert.from_jax_arrays(
        {k: (None if v is None else np.asarray(v)) for k, v in arrays.items()},
        D.DCSVMConfig(kernel=Kernel("rbf", gamma=gamma), use_kernels=False,
                      **CFG), device="cpu", task=jt.name, task_params=params)
    assert tm.task == DATA[name][2][1]
    (X, _), _, _ = DATA[name]
    with jax.enable_x64(True):
        Xj = jnp.asarray(X[:64], jnp.float64)
        want = np.asarray(JP.decision_exact(jm, Xj, use_pallas=False))
        want_pred = np.asarray(JP.predict_exact(jm, Xj))
    got = P.decision_exact(tm, X[:64]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    pred = P.predict_exact(tm, X[:64]).numpy()
    if name == "svr":
        np.testing.assert_allclose(pred, want_pred, rtol=0, atol=1e-4)
    else:
        clear = np.abs(want) > 1e-3
        np.testing.assert_array_equal(pred[clear], want_pred[clear])


@pytest.mark.parametrize("name", ["gaussian_mixture_imbalanced",
                                  "gaussian_with_outliers", "sinc1d",
                                  "friedman1", "checkerboard", "two_spirals"])
def test_generators_have_the_reference_structure(name):
    """The numpy generators: float32 rows in the reference's ranges, the
    reference's label sets, reproducible from a seed."""
    X, y = getattr(data, name)(np.random.default_rng(7), 400)
    X2, y2 = getattr(data, name)(np.random.default_rng(7), 400)
    assert X.dtype == y.dtype == np.float32 and len(X) == len(y) == 400
    assert np.array_equal(X, X2) and np.array_equal(y, y2)
    if name in ("sinc1d", "friedman1"):
        assert np.unique(y).size > 100
    else:
        assert set(np.unique(y)) == {-1.0, 1.0}
    if name == "friedman1":
        assert abs(float(y.mean())) < 1e-5 and abs(float(y.std()) - 1) < 1e-4
    if name == "gaussian_mixture_imbalanced":
        assert 0.01 < float((y > 0).mean()) < 0.1
    if name == "gaussian_with_outliers":
        assert 0.01 < float((y < 0).mean()) < 0.1


def test_stratified_split_keeps_each_class_on_both_sides():
    X, y = data.gaussian_mixture_imbalanced(np.random.default_rng(8), 300)
    Xtr, ytr, Xte, yte = data.stratified_split(np.random.default_rng(9), X, y)
    assert len(Xtr) + len(Xte) == 300
    for side in (ytr, yte):
        assert set(np.unique(side)) == {-1.0, 1.0}
    frac = (yte > 0).sum() / max((y > 0).sum(), 1)
    assert 0.1 <= frac <= 0.35
