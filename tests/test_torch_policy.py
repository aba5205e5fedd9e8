"""The precision policy (``compute_dtype="bfloat16"``), port vs reference.

The reference's bf16 outputs (its Pallas kernels in interpret mode and its
plain pairwise, as ``tests/test_gramop.py`` runs them) against the port's
plain versions, with f32 and packed (``ops.pack_bf16``) operands, at 1e-5:
both round the same operands to bf16 and sum exact f32 products, so only
the order of the f32 sums differs.  The f32 policy is the plain path bit
for bit.  Fits: a bf16 fit against the reference's bf16 fit (objective to
1e-5 relative, labels equal where |f| >= 1e-3), and the reference's own
criterion, accuracy within 0.05 of the f32 fit.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dcsvm as JD
from repro.core import predict as JP
from repro.core.gramop import GramOperator as JGramOperator
from repro.core.kernels import Kernel as JKernel
from repro.kernels import ops as kops
from repro_torch.core import dcsvm as D
from repro_torch.core import gramop
from repro_torch.core import predict as P
from repro_torch.core.kernels import Kernel, gram_matvec
from repro_torch.data import gaussian_mixture, train_test_split
from repro_torch.kernels import ops

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_fit import jax_draws  # noqa: E402

KINDS = {
    "rbf": dict(kind="rbf", gamma=0.5),
    "poly": dict(kind="poly", gamma=0.5, degree=3, coef0=1.0),
    "linear": dict(kind="linear"),
}
BF = "bfloat16"
TOL = 1e-5


def _data(n, m, d, seed=0):
    """Mixed-sign data, n and m no multiples of any tile."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.7, 0.7, (n, d)).astype(np.float32),
            rng.uniform(-0.7, 0.7, (m, d)).astype(np.float32))


def _signs(n, seed=3):
    return np.where(np.random.default_rng(seed).random(n) < 0.5, 1.0,
                    -1.0).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _both(A):
    """The port's two operand forms: f32 rows and rows packed once."""
    t = torch.from_numpy(A)
    return {"f32": t, "packed": ops.pack_bf16(t)}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pairwise_bf16_matches_reference(kind):
    X, Y = _data(64, 37, 9, seed=5)
    want = JKernel(**KINDS[kind]).pairwise(jnp.asarray(X), jnp.asarray(Y),
                                           compute_dtype=BF)
    got = Kernel(**KINDS[kind]).pairwise(torch.from_numpy(X),
                                         torch.from_numpy(Y),
                                         compute_dtype=BF)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("form", ["f32", "packed"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kernel_matrix_bf16_matches_reference(kind, form):
    X, Y = _data(100, 53, 9)
    want = kops.kernel_matrix(jnp.asarray(X), jnp.asarray(Y),
                              JKernel(**KINDS[kind]), bm=64, bn=64,
                              compute_dtype=BF)
    got = ops.kernel_matrix(_both(X)[form], _both(Y)[form],
                            Kernel(**KINDS[kind]), compute_dtype=BF)
    _close(got, want)


@pytest.mark.parametrize("form", ["f32", "packed"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kernel_matvec_bf16_matches_reference(kind, form):
    X, Z = _data(75, 41, 9, seed=1)
    v = np.random.default_rng(7).normal(size=41).astype(np.float32)
    want = kops.kernel_matvec(jnp.asarray(X), jnp.asarray(Z), jnp.asarray(v),
                              JKernel(**KINDS[kind]), compute_dtype=BF)
    got = ops.kernel_matvec(_both(X)[form], _both(Z)[form],
                            torch.from_numpy(v), Kernel(**KINDS[kind]),
                            compute_dtype=BF)
    _close(got, want, TOL * (1 + float(np.abs(v).sum())))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_q_rows_bf16_matches_reference(kind):
    X, _ = _data(90, 1, 9, seed=2)
    y = _signs(90)
    idx = np.array([3, 17, 41, 88])
    want = kops.q_rows(jnp.asarray(X), jnp.asarray(y), jnp.asarray(X[idx]),
                       jnp.asarray(y[idx]), JKernel(**KINDS[kind]), bm=64,
                       bn=64, compute_dtype=BF)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    got = ops.q_rows(Xt, yt, Xt[idx], yt[idx], Kernel(**KINDS[kind]),
                     compute_dtype=BF)
    _close(got, want)
    # the operator's rows on the kernel path read the packed base rows
    op = gramop.GramOperator(Xd=Xt, s=yt, kernel=Kernel(**KINDS[kind]),
                             use_kernels=True, compute_dtype=BF)
    _close(op.q_rows(torch.from_numpy(idx)), want)


@pytest.mark.parametrize("form", ["f32", "packed"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cd_column_update_bf16_matches_reference(kind, form):
    X, _ = _data(85, 1, 9, seed=4)
    y = _signs(85)
    idx = np.array([0, 12, 60])
    w = (np.array([0.3, -0.2, 0.5]) * y[idx]).astype(np.float32)
    want = kops.cd_column_update(jnp.asarray(X), jnp.asarray(y),
                                 jnp.asarray(X[idx]), jnp.asarray(w),
                                 JKernel(**KINDS[kind]), compute_dtype=BF)
    got = ops.cd_column_update(_both(X)[form], torch.from_numpy(y),
                               _both(X[idx])[form], torch.from_numpy(w),
                               Kernel(**KINDS[kind]), compute_dtype=BF)
    _close(got, want)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_operator_bf16_matches_reference(kind):
    """GramOperator under the policy, plain and kernel paths: matvec,
    col_update and qbb against the reference operator's."""
    X, _ = _data(70, 1, 6, seed=9)
    y = _signs(70, seed=10)
    v = np.random.default_rng(11).normal(size=70).astype(np.float32)
    idx = np.array([2, 9, 33, 61])
    jop = JGramOperator(Xd=jnp.asarray(X), s=jnp.asarray(y),
                        kernel=JKernel(**KINDS[kind]), compute_dtype=BF)
    g0 = np.zeros(70, np.float32)
    delta = np.array([0.1, -0.3, 0.2, 0.05], np.float32)
    want_mv = jop.matvec(jnp.asarray(v))
    want_up = jop.col_update(jnp.asarray(g0), jnp.asarray(idx),
                             jnp.asarray(delta))
    want_bb = jop.qbb(jnp.asarray(idx))
    for use_kernels in (False, True):
        op = gramop.GramOperator(Xd=torch.from_numpy(X),
                                 s=torch.from_numpy(y),
                                 kernel=Kernel(**KINDS[kind]),
                                 use_kernels=use_kernels, compute_dtype=BF)
        ti = torch.from_numpy(idx)
        _close(op.matvec(torch.from_numpy(v)), want_mv,
               TOL * (1 + float(np.abs(v).sum())))
        _close(op.col_update(torch.from_numpy(g0), ti,
                             torch.from_numpy(delta)), want_up)
        _close(op.qbb(ti), want_bb)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_f32_policy_is_bit_identical(kind):
    """``compute_dtype`` None and "float32" give the same tensors: the
    policy normalises away."""
    X, Y = _data(70, 33, 9, seed=6)
    y = torch.from_numpy(_signs(70, seed=8))
    v = torch.from_numpy(np.random.default_rng(9).normal(size=70)
                         .astype(np.float32))
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    k = Kernel(**KINDS[kind])
    assert gramop.resolve_compute_dtype is ops.resolve_compute_dtype
    for cd in (None, "float32", torch.float32):
        assert gramop.resolve_compute_dtype(cd, torch.float32) is None
    assert gramop.resolve_compute_dtype(BF, torch.float32) == torch.bfloat16
    torch.testing.assert_close(k.pairwise(Xt, Yt, compute_dtype="float32"),
                               k.pairwise(Xt, Yt), rtol=0, atol=0)
    torch.testing.assert_close(
        ops.kernel_matrix(Xt, Yt, k, compute_dtype="float32"),
        ops.kernel_matrix(Xt, Yt, k), rtol=0, atol=0)
    torch.testing.assert_close(gram_matvec(k, Xt, v, compute_dtype="float32"),
                               gram_matvec(k, Xt, v), rtol=0, atol=0)
    torch.testing.assert_close(
        ops.cd_column_update(Xt, y, Xt[:5], v[:5], k,
                             compute_dtype="float32"),
        ops.cd_column_update(Xt, y, Xt[:5], v[:5], k), rtol=0, atol=0)


# --- fits ------------------------------------------------------------------

CFG = dict(C=4.0, k=4, levels=1, m=100, tol=1e-5, max_iters=20000, seed=3)
BRANCHES = {"dense": {}, "matvec": {"full_gram_threshold": 64},
            "early": {"early_stop_level": 1}}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X, y = gaussian_mixture(rng, 240, d=8, modes_per_class=4, spread=0.15,
                            label_noise=0.02)
    return train_test_split(rng, X, y)


@pytest.fixture(scope="module")
def reference_fits(data):
    Xtr, ytr, _, _ = data
    return {b: JD.fit(JD.DCSVMConfig(kernel=JKernel("rbf", gamma=8.0),
                                     use_pallas=False, compute_dtype=BF,
                                     **CFG, **extra), Xtr, ytr)
            for b, extra in BRANCHES.items()}


def _port_fit(data, branch, use_kernels):
    Xtr, ytr, _, _ = data
    cfg = D.DCSVMConfig(kernel=Kernel("rbf", gamma=8.0),
                        use_kernels=use_kernels, compute_dtype=BF, **CFG,
                        **BRANCHES[branch])
    return D.fit(cfg, Xtr, ytr, device="cpu",
                 draws=jax_draws(CFG["seed"], CFG["m"]))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("branch", ["dense", "matvec"])
def test_bf16_fit_matches_reference(data, reference_fits, branch,
                                    use_kernels):
    _, _, Xte, _ = data
    jm = reference_fits[branch]
    tm = _port_fit(data, branch, use_kernels)
    f_ref = float(JD.objective_value(jm.config, jm.X, jm.y, jm.alpha))
    f_got = float(D.objective_value(tm.config, tm.X, tm.y, tm.alpha))
    assert abs(f_got - f_ref) <= 1e-5 * abs(f_ref)
    fj = np.asarray(JP.decision_exact(jm, jnp.asarray(Xte)))
    ft = P.decision_exact(tm, Xte).numpy()
    clear = np.abs(fj) >= 1e-3
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.sign(ft[clear]), np.sign(fj[clear]))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_bf16_early_decisions_match_reference(data, reference_fits,
                                              use_kernels):
    _, _, Xte, _ = data
    jm = reference_fits["early"]
    tm = _port_fit(data, "early", use_kernels)
    fj = np.asarray(JP.decision_early(jm, jnp.asarray(Xte)))
    ft = P.decision_early(tm, Xte).numpy()
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-4)


def test_bf16_accuracy_within_reference_criterion(data):
    """The reference's own criterion (tests/test_gramop.py): a bf16 fit
    classifies within 0.05 of the f32 fit."""
    Xtr, ytr, Xte, yte = data
    acc = {}
    for cd in (None, BF):
        m = D.fit(D.DCSVMConfig(kernel=Kernel("rbf", gamma=8.0),
                                compute_dtype=cd, **CFG), Xtr, ytr,
                  device="cpu")
        acc[cd] = P.accuracy(yte, P.predict_exact(m, Xte))
    assert acc[BF] >= acc[None] - 0.05


@pytest.mark.parametrize("d,dp", [(1, 8), (54, 56), (256, 256), (300, 304)])
def test_pack_pads_rows_to_eight_columns(d, dp):
    """Packed rows: d rounded up to a multiple of 8 (whole 16-byte copies),
    zero columns past d, the f32 norms of the rounded rows."""
    X = torch.from_numpy(np.random.default_rng(d).normal(size=(5, d))
                         .astype(np.float32))
    P = ops.pack_bf16(X)
    q = X.to(torch.bfloat16)
    assert P.data.shape == (5, dp) and P.shape == (5, d)
    assert torch.equal(P.data[:, :d], q)
    assert not bool(P.data[:, d:].float().any())
    torch.testing.assert_close(P.norms, (q.float() ** 2).sum(-1), rtol=0,
                               atol=0)
