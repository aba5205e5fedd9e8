"""Port solvers vs the JAX reference on the same small random problems.

Under ``jax.enable_x64`` against torch float64 the two follow the same
coordinate path: identical ``iters`` and alpha to 1e-8.  In float32 the
sums round differently: alpha to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solver as JS
from repro.core.kernels import Kernel as JKernel
from repro_torch.core import solver as S
from repro_torch.core.kernels import Kernel


def _problem(seed, n=60, d=8, gamma=4.0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    y = np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0)
    sq = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    Q = (y[:, None] * y[None, :]) * np.exp(-gamma * sq)
    return X, y, Q


def _jax(fn, x64, *args, **kw):
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        args = [jnp.asarray(a, dt) if isinstance(a, np.ndarray) else a
                for a in args]
        res = fn(*args, **kw)
        return {f: np.asarray(getattr(res, f)) for f in ("alpha", "iters")}


def _check(got, want, x64):
    if x64:
        np.testing.assert_array_equal(np.asarray(got.iters), want["iters"])
        np.testing.assert_allclose(got.alpha.numpy(), want["alpha"],
                                   rtol=0, atol=1e-8)
    else:
        np.testing.assert_allclose(got.alpha.numpy(), want["alpha"],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("x64", [True, False], ids=["x64", "f32"])
def test_solve_box_qp_matches_reference(x64):
    _, _, Q = _problem(0)
    dt = torch.float64 if x64 else torch.float32
    want = _jax(JS.solve_box_qp, x64, Q, 2.0, tol=1e-4, max_iters=3000)
    got = S.solve_box_qp(torch.tensor(Q, dtype=dt), 2.0, tol=1e-4,
                         max_iters=3000)
    _check(got, want, x64)


def test_solve_box_qp_batch_matches_vmapped_reference():
    """A batch with per-problem masks and warm starts: each problem's iters
    equal the reference's vmapped while-loop, and stopped problems stay
    frozen while the others run."""
    Qs = np.stack([_problem(s, n=40)[2] for s in range(3)])
    rng = np.random.default_rng(9)
    mask = rng.uniform(size=(3, 40)) < 0.8
    a0 = np.where(mask, rng.uniform(0, 1, size=(3, 40)), 0.0)
    tols = dict(tol=1e-4, max_iters=2000)
    with jax.enable_x64(True):
        res = jax.vmap(lambda q, a, m: JS.solve_box_qp(
            q, 1.5, alpha0=a, active_mask=m, **tols))(
                jnp.asarray(Qs), jnp.asarray(a0), jnp.asarray(mask))
        want = {"alpha": np.asarray(res.alpha), "iters": np.asarray(res.iters)}
    got = S.solve_box_qp(torch.tensor(Qs), 1.5, alpha0=torch.tensor(a0),
                         active_mask=torch.tensor(mask), **tols)
    assert len(set(want["iters"].tolist())) > 1     # they stop apart
    _check(got, want, True)


@pytest.mark.parametrize("x64", [True, False], ids=["x64", "f32"])
def test_solve_box_qp_block_matches_reference(x64):
    _, _, Q = _problem(1)
    dt = torch.float64 if x64 else torch.float32
    want = _jax(JS.solve_box_qp_block, x64, Q, 1.0, tol=1e-4, max_iters=500,
                block=8, sweeps=3)
    got = S.solve_box_qp_block(torch.tensor(Q, dtype=dt), 1.0, tol=1e-4,
                               max_iters=500, block=8, sweeps=3)
    _check(got, want, x64)


@pytest.mark.parametrize("block", [0, 8])
@pytest.mark.parametrize("x64", [True, False], ids=["x64", "f32"])
def test_solve_with_shrinking_matches_reference(x64, block):
    _, _, Q = _problem(2)
    dt = torch.float64 if x64 else torch.float32
    want = _jax(JS.solve_with_shrinking, x64, Q, 4.0, tol=1e-4,
                max_iters=3000, block=block)
    got = S.solve_with_shrinking(torch.tensor(Q, dtype=dt), 4.0, tol=1e-4,
                                 max_iters=3000, block=block)
    _check(got, want, x64)


# the kernels are float32 only, so x64 runs the plain path alone
@pytest.mark.parametrize("x64,use_kernels", [(True, False), (False, False),
                                             (False, True)],
                         ids=["x64-plain", "f32-plain", "f32-kernels"])
def test_solve_box_qp_matvec_matches_reference(x64, use_kernels):
    X, y, _ = _problem(3, n=90)
    dt = torch.float64 if x64 else torch.float32
    kw = dict(tol=1e-4, max_iters=300, block=16, sweeps=2, grad_chunks=3)
    want = _jax(JS.solve_box_qp_matvec, x64, X, y, JKernel("rbf", gamma=4.0),
                2.0, use_pallas=use_kernels, **kw)
    got = S.solve_box_qp_matvec(torch.tensor(X, dtype=dt),
                                torch.tensor(y, dtype=dt),
                                Kernel("rbf", gamma=4.0), 2.0,
                                use_kernels=use_kernels, **kw)
    _check(got, want, x64)


def test_kkt_residual_and_objective_match_reference():
    _, _, Q = _problem(4, n=30)
    a = np.random.default_rng(5).uniform(0, 1, size=30)
    g = Q @ a - 1.0
    with jax.enable_x64(True):
        want_k = float(JS.kkt_residual(jnp.asarray(Q), jnp.asarray(a), 0.7))
        want_o = float(JS.objective(jnp.asarray(a), jnp.asarray(g)))
    Qt, at, gt = (torch.tensor(v) for v in (Q, a, g))
    assert abs(float(S.kkt_residual(Qt, at, 0.7)) - want_k) < 1e-12
    assert abs(float(S.objective(at, gt)) - want_o) < 1e-12
