"""The port's equality-family solvers vs the JAX reference.

Same small problems on both sides: Q = (y y') ∘ K for RBF at gamma 16 over
60 uniform points in [0, 1]^6 (K far from singular, so each problem has one
optimum), one constraint e'u = d or one per label group.  Tolerances follow
tests/test_torch_solver.py: in float64 the pairwise engines take the
reference's coordinate path, equal ``iters`` and alpha to 1e-8; in float32
alpha to 2e-5 (twice the stopping tolerance: f32 rounding moves the stopping
step).  The blocked engines run a fixed number of inner pair steps that are
not converged, and which pair each takes follows ulps (the reference's own
jitted and un-jitted runs differ by 2.5e-8 after one outer iteration), so
they are held to the optimum at a tight tolerance (alpha to 1e-8 at tol
1e-9) and to the reference's iteration count within 15% + 3; batches with
masks and warm starts likewise (pair steps meet exact h ties).
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

GAMMA = 16.0
N = 60


def _problem(seed, n=N, d=6):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    y = np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0)
    sq = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    return X, y, (y[:, None] * y[None, :]) * np.exp(-GAMMA * sq)


def _groups(y, G):
    """(gid, d) of one constraint (sum u = 0.3 n) or one per label group
    (0.15 n each, the two-constraint nu-SVC split)."""
    n = len(y)
    if G == 1:
        return None, np.array([0.3 * n])
    return (y < 0).astype(np.int64), np.array([0.15 * n, 0.15 * n])


def _jx(v, x64):
    if isinstance(v, np.ndarray):
        if v.dtype.kind == "f":
            return jnp.asarray(v, jnp.float64 if x64 else jnp.float32)
        if v.dtype.kind in "iu":
            return jnp.asarray(v, jnp.int32)
        return jnp.asarray(v)
    return v


def _tx(v, x64):
    if isinstance(v, np.ndarray):
        if v.dtype.kind == "f":
            return torch.tensor(v, dtype=torch.float64 if x64 else torch.float32)
        return torch.tensor(v)
    return v


def _pair(fn_name, x64, args, kw, vmap=False):
    """Run the reference and the port on the same numpy inputs."""
    with jax.enable_x64(x64):
        fn = getattr(JS, fn_name)
        jargs = [_jx(a, x64) for a in args]
        jkw = {k: _jx(v, x64) for k, v in kw.items()}
        if vmap:
            names = [k for k, v in jkw.items() if isinstance(v, jax.Array)]
            res = jax.vmap(lambda *a: fn(*a[:len(jargs)], **{
                **jkw, **dict(zip(names, a[len(jargs):]))}))(
                    *jargs, *[jkw[k] for k in names])
        else:
            res = fn(*jargs, **jkw)
        want = {f: np.asarray(getattr(res, f)) for f in ("alpha", "iters")}
    got = getattr(S, fn_name)(*[_tx(a, x64) for a in args],
                              **{k: _tx(v, x64) for k, v in kw.items()})
    return got, want


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got.iters), want["iters"])
    np.testing.assert_allclose(got.alpha.numpy(), want["alpha"], rtol=0,
                               atol=1e-8)


def _near(got, want, atol):
    np.testing.assert_allclose(got.alpha.numpy(), want["alpha"], rtol=0,
                               atol=atol)
    g, w = np.asarray(got.iters), want["iters"]
    assert np.all(np.abs(g - w) <= 0.15 * w + 3), (g, w)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("x64", [True, False], ids=["x64", "f32"])
def test_solve_eq_qp_matches_reference(x64, G):
    _, y, Q = _problem(0)
    gid, d = _groups(y, G)
    kw = dict(tol=1e-5, max_iters=3000, n_groups=G)
    if gid is not None:
        kw["gid"] = gid
    got, want = _pair("solve_eq_qp", x64, (Q, 1.0, 1.0, d), kw)
    if x64:
        _exact(got, want)
    else:
        np.testing.assert_allclose(got.alpha.numpy(), want["alpha"], rtol=0,
                                   atol=2e-5)
    # every iterate stays on each group's hyperplane
    gsel = np.zeros(N, int) if gid is None else gid
    for g in range(G):
        assert abs(float(got.alpha.numpy()[gsel == g].sum()) - d[g]) < 1e-4


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("x64", [True, False], ids=["x64", "f32"])
def test_solve_eq_qp_block_matches_reference(x64, G):
    _, y, Q = _problem(1)
    gid, d = _groups(y, G)
    kw = dict(tol=1e-9 if x64 else 1e-5, max_iters=3000, block=4, sweeps=2,
              n_groups=G)
    if gid is not None:
        kw["gid"] = gid
    got, want = _pair("solve_eq_qp_block", x64, (Q, 1.0, 1.0, d), kw)
    _near(got, want, 1e-8 if x64 else 2e-5)


@pytest.mark.parametrize("fn,extra", [("solve_eq_qp", {}),
                                      ("solve_eq_qp_block",
                                       dict(block=3, sweeps=2))],
                         ids=["pairwise", "blocked"])
def test_masked_batch_with_warm_starts_matches_vmapped_reference(fn, extra):
    """Three padded cluster problems (frozen pad slots with a = c = 0 and a
    unit diagonal, as the divide step builds them), each with its own
    target and warm start: the port's batched loop against the reference's
    vmapped one, in float64."""
    rng = np.random.default_rng(3)
    b, nc = 3, 24
    X = rng.uniform(size=(b, nc, 5))
    mask = np.arange(nc)[None, :] < np.array([24, 20, 17])[:, None]
    K = np.exp(-30.0 * ((X[:, :, None] - X[:, None]) ** 2).sum(-1))
    K = np.where(mask[:, :, None] & mask[:, None, :], K, 0.0) \
        + np.eye(nc) * (~mask)[:, :, None]
    cb = np.where(mask, 1.0, 0.0)
    d = 0.2 * mask.sum(1, keepdims=True).astype(float)
    a0 = np.where(mask, rng.uniform(0, 0.5, (b, nc)), 0.0)
    got, want = _pair(fn, True, (K, cb, cb.copy(), d),
                      dict(alpha0=a0, active_mask=mask, tol=1e-9,
                           max_iters=5000, **extra), vmap=True)
    assert len(set(want["iters"].tolist())) > 1      # they stop apart
    _near(got, want, 1e-8)
    assert np.all(got.alpha.numpy()[~mask] == 0.0)


@pytest.mark.parametrize("block", [0, 4], ids=["pairwise", "blocked"])
def test_solve_eq_qp_shrink_matches_reference(block):
    _, y, Q = _problem(2)
    gid, d = _groups(y, 2)
    got, want = _pair("solve_eq_qp_shrink", True, (Q, 1.0, 1.0, d),
                      dict(tol=1e-9, max_iters=3000, block=block, sweeps=2,
                           gid=gid, n_groups=2))
    _near(got, want, 1e-8)
    with jax.enable_x64(True):
        want_pg = float(JS.kkt_residual_eq(jnp.asarray(Q),
                                           jnp.asarray(want["alpha"]), 1.0,
                                           1.0, gid=jnp.asarray(gid, jnp.int32),
                                           n_groups=2))
    assert float(got.pg_max) <= 1e-8 and want_pg <= 1e-8


# the kernels are float32 only: x64 runs the plain path alone
MATVEC = [(True, False), (False, False), (False, True)]


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("block", [1, 4], ids=["pairwise", "blocked"])
@pytest.mark.parametrize("x64,use_kernels", MATVEC,
                         ids=["x64-plain", "f32-plain", "f32-kernels"])
def test_solve_eq_qp_matvec_matches_reference(x64, use_kernels, block, G):
    """The Gram-free engines; with ``use_kernels`` the rank-2 / rank-2B
    update and the refreshes go through the kernel wrappers (their plain
    versions on the CPU)."""
    X, y, _ = _problem(4)
    gid, d = _groups(y, G)
    tight = x64 and block > 1
    kw = dict(tol=1e-9 if tight else 1e-5, max_iters=2000, block=block,
              refresh_every=64, grad_chunks=3, n_groups=G,
              use_kernels=use_kernels)
    if gid is not None:
        kw["gid"] = gid
    with jax.enable_x64(x64):
        jd = jnp.float64 if x64 else jnp.float32
        res = JS.solve_eq_qp_matvec(
            jnp.asarray(X, jd), jnp.asarray(y, jd),
            JKernel("rbf", gamma=GAMMA), 1.0, 1.0, jnp.asarray(d, jd),
            **{k: (jnp.asarray(v, jnp.int32) if k == "gid" else v)
               for k, v in kw.items() if k != "use_kernels"},
            use_pallas=use_kernels)
        want = {"alpha": np.asarray(res.alpha), "iters": np.asarray(res.iters)}
    dt = torch.float64 if x64 else torch.float32
    got = S.solve_eq_qp_matvec(
        torch.tensor(X, dtype=dt), torch.tensor(y, dtype=dt),
        Kernel("rbf", gamma=GAMMA), 1.0, 1.0, torch.tensor(d, dtype=dt),
        **{k: (torch.tensor(v) if k == "gid" else v) for k, v in kw.items()})
    if x64 and block == 1:
        _exact(got, want)
    else:
        _near(got, want, 1e-8 if x64 else 2e-5)


def test_equality_helpers_match_reference():
    """project_box_equality (and its grouped form), the multiplier brackets
    and rho, kkt_residual_eq and the pair step, on random states with
    mixed-sign a, frozen coordinates and two groups, in float64."""
    rng = np.random.default_rng(5)
    n = 40
    _, _, Q = _problem(6, n=n)
    a = np.where(rng.uniform(size=n) < 0.3, -1.5, 0.7)
    c = rng.uniform(0.5, 2.0, n)
    u = rng.uniform(-0.2, 1.2, n) * c
    g = rng.standard_normal(n)
    mask = rng.uniform(size=n) < 0.8
    gid = (rng.uniform(size=n) < 0.5).astype(np.int64)
    with jax.enable_x64(True):
        J = {k: jnp.asarray(v) for k, v in dict(a=a, c=c, u=u, g=g, Q=Q,
                                                 mask=mask).items()}
        jg = jnp.asarray(gid, jnp.int32)
        want = {
            "proj": JS.project_box_equality(J["u"], J["c"], J["a"], 3.0,
                                            active_mask=J["mask"]),
            "proj_g": JS._project_box_equality_grouped(
                J["u"], J["c"], J["a"], jnp.asarray([2.0, -1.0]), jg, 2,
                J["mask"]),
            "interval": jnp.stack(JS.equality_interval_grouped(
                J["u"], J["g"], J["c"], J["a"], jg, 2, active_mask=J["mask"])),
            "rho_g": JS.equality_rho_grouped(J["u"], J["g"], J["c"], J["a"],
                                             jg, 2),
            "rho": JS.equality_rho(J["u"], J["g"], J["c"], J["a"]),
            "kkt": JS.kkt_residual_eq(J["Q"], jnp.clip(J["u"], 0, J["c"]),
                                      J["c"], J["a"], p=0.1, gid=jg,
                                      n_groups=2),
            "pair": jnp.stack(JS._pair_step(jnp.clip(J["u"], 0, J["c"]),
                                            J["c"], J["a"], 3, 7, 0.4)),
        }
        want = {k: np.asarray(v) for k, v in want.items()}
    T = {k: torch.tensor(v) for k, v in dict(a=a, c=c, u=u, g=g, Q=Q,
                                              mask=mask, gid=gid).items()}
    uc = torch.minimum(torch.clamp(T["u"], min=0.0), T["c"])
    got = {
        "proj": S.project_box_equality(T["u"], T["c"], T["a"], 3.0,
                                       active_mask=T["mask"]),
        "proj_g": S._project_grouped(T["u"], T["c"], T["a"],
                                     torch.tensor([2.0, -1.0],
                                                  dtype=torch.float64),
                                     T["gid"], 2, T["mask"]),
        "interval": torch.stack(S.equality_interval_grouped(
            T["u"], T["g"], T["c"], T["a"], T["gid"], 2,
            active_mask=T["mask"])),
        "rho_g": S.equality_rho_grouped(T["u"], T["g"], T["c"], T["a"],
                                        T["gid"], 2),
        "rho": S.equality_rho(T["u"], T["g"], T["c"], T["a"]),
        "kkt": S.kkt_residual_eq(T["Q"], uc, T["c"], T["a"], p=0.1,
                                 gid=T["gid"], n_groups=2),
        "pair": torch.stack(S._pair_step(
            uc[3], uc[7], T["c"][3], T["c"][7], T["a"][3], T["a"][7],
            torch.tensor(0.4, dtype=torch.float64))),
    }
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    # the projection lands on the hyperplane, inside the box
    p = got["proj"].numpy()
    assert abs(float((a * p).sum()) - 3.0) < 1e-9
    assert np.all(p >= 0) and np.all(p <= c)


def test_restore_keeps_bound_coordinates_on_their_bounds():
    """The drift restoration moves one strictly interior coordinate; at a
    vertex it falls back to any maskable one."""
    Q = torch.eye(4, dtype=torch.float64)[None]
    rows, q_row, _ = S._dense_hooks(Q, torch.zeros(1, 4, dtype=torch.float64))
    c = torch.ones(1, 4, dtype=torch.float64)
    a = torch.ones(1, 4, dtype=torch.float64)
    mask = torch.ones(1, 4, dtype=torch.bool)
    u = torch.tensor([[0.0, 1.0, 0.25, 0.75]], dtype=torch.float64)
    out, _ = S._restore_equality(u, torch.zeros_like(u), q_row, c, a,
                                 torch.tensor([2.0 + 1e-12], dtype=torch.float64),
                                 mask)
    assert out[0, 0] == 0.0 and out[0, 1] == 1.0
    assert abs(float(out.sum()) - (2.0 + 1e-12)) < 1e-15
