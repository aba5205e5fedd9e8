"""The comparison solvers (``repro_torch.baselines``), ``gram_blocks`` and
``convert.from_jax_baseline`` against the JAX reference.

Both sides fit the same numpy rows in float64 (``jax.enable_x64`` /
``dtype=torch.float64``), the port with the reference's own random draws
(``jax.random.choice`` for the k-means init rows, RFF's normal and uniform
draws from its split keys).  Alphas, weights and decisions are held to
1e-8.  LLSVM and RFF solve a rank-b dual by block CD, where the top-B
block meets near-ties of noise-level scores once fewer than B coordinates
violate (the reference's XLA product and torch's differ in ulps there), so
both run at tol 1e-9 and are held by their weights, which the optimum
fixes (their alphas are not unique).  The kernel route on the CPU (the
wrappers' plain versions, f32) is held to the plain f32 fit and counted.
"""
import numpy as np
import pytest
import torch

import jax
from repro import baselines as JB
from repro.core.kernels import Kernel as JKernel
from repro.core.kernels import gram_blocks as jgram_blocks
from repro_torch import baselines as TB
from repro_torch import convert
from repro_torch.core.kernels import Kernel, gram_blocks
from repro_torch.data import gaussian_mixture, train_test_split
from repro_torch.kernels import ops, ref

TOL = 1e-8
GAMMA, C, SEED = 8.0, 4.0, 0
B_LANDMARKS, D_FEATURES, U_UNITS = 32, 64, 48
F64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X, y = gaussian_mixture(rng, 400, d=8, modes_per_class=4, spread=0.15)
    return tuple(a.astype(np.float64)
                 for a in train_test_split(rng, X, y))


def _draws(n: int, d: int):
    """The reference's draws: its k-means init rows (``nystrom.py``,
    ``ltpu.py``) and RFF's normal and uniform draws (``rff.py``)."""
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(SEED)
        k1, k2 = jax.random.split(key)
        choice = {b: np.array(jax.random.choice(key, n, shape=(b,),
                                                replace=False))
                  for b in (B_LANDMARKS, U_UNITS)}
        return (choice, np.array(jax.random.normal(k1, (d, D_FEATURES))),
                np.array(jax.random.uniform(k2, (D_FEATURES,))))


# each case: its call (the package, the kernel, train X and y, the
# reference's draws, keywords), its keywords, the fields held
def _exact(mod, k, X, y, dr, **kw):
    return mod.train_exact(X, y, k, C, **kw)


def _cascade(mod, k, X, y, dr, **kw):
    return mod.train_cascade(X, y, k, C, levels=2, seed=SEED, **kw)


def _llsvm(mod, k, X, y, dr, **kw):
    if mod is TB:
        kw["init_idx"] = dr[0][B_LANDMARKS]
    return mod.train_llsvm(X, y, k, C, num_landmarks=B_LANDMARKS, seed=SEED,
                           **kw)


def _rff(mod, k, X, y, dr, **kw):
    if mod is TB:
        kw.update(normal=dr[1], uniform=dr[2])
    return mod.train_rff(X, y, k, C, num_features=D_FEATURES, seed=SEED,
                         **kw)


def _ltpu(mod, k, X, y, dr, **kw):
    if mod is TB:
        kw["init_idx"] = dr[0][U_UNITS]
    return mod.train_ltpu(X, y, k, num_units=U_UNITS, seed=SEED, **kw)


CASES = {
    "exact": (_exact, {"tol": 1e-4}, ("alpha",)),
    "exact-gram-free": (_exact, {"tol": 1e-4, "full_gram_threshold": 128},
                        ("alpha",)),
    "cascade": (_cascade, {"tol": 1e-4}, ("alpha_sv", "Xsv")),
    "llsvm": (_llsvm, {"tol": 1e-9}, ("landmarks", "whiten", "w")),
    "rff": (_rff, {"tol": 1e-9}, ("Wproj", "bias", "w")),
    "ltpu": (_ltpu, {}, ("centers", "w")),
}
KINDS = {"exact": "ExactSVM", "exact-gram-free": "ExactSVM",
         "cascade": "CascadeSVM", "llsvm": "LLSVM", "rff": "RFFSVM",
         "ltpu": "LTPU"}


@pytest.fixture(scope="module")
def fits(data):
    """Every case fitted by the reference and by the port, in float64."""
    Xtr, ytr, _, _ = data
    dr = _draws(*Xtr.shape)
    out = {}
    for name, (call, extra, _) in CASES.items():
        with jax.enable_x64(True):
            jm = call(JB, JKernel("rbf", gamma=GAMMA), Xtr, ytr, dr, **extra)
        tm = call(TB, Kernel("rbf", gamma=GAMMA), Xtr, ytr, dr, **extra,
                  **F64)
        out[name] = (jm, tm)
    return out


def _decisions(jm, tm, Xte):
    with jax.enable_x64(True):
        want = np.asarray(jm.decision(Xte))
    return want, tm.decision(Xte).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_baseline_matches_reference(data, fits, name):
    _, _, Xte, yte = data
    jm, tm = fits[name]
    for field in CASES[name][2]:
        got = getattr(tm, field)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jm, field)),
                                   rtol=0, atol=TOL, err_msg=field)
    if name.startswith("exact"):
        assert tm.iters == jm.iters
        assert abs(tm.pg_max - jm.pg_max) <= TOL
    if name == "cascade":
        np.testing.assert_array_equal(tm.sv_index, jm.sv_index)
        assert tm.survivors[-1] == len(tm.sv_index)
    want, got = _decisions(jm, tm, Xte)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.array_equal(tm.predict(Xte).numpy(), np.sign(want))
    # above chance: the larger class's share of the queries
    share = max(np.mean(yte > 0), np.mean(yte < 0))
    assert np.mean(np.sign(got) == yte) > share
    assert tm.train_time > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_from_jax_baseline_predicts_the_same(data, fits, name):
    """A model the reference trained, carried over, scores the queries as
    the reference does."""
    _, _, Xte, _ = data
    jm, _ = fits[name]
    fields = {k: np.asarray(v) for k, v in vars(jm).items()
              if k != "kernel"}
    got = convert.from_jax_baseline(KINDS[name], fields, jm.__dict__.get(
        "kernel", JKernel("rbf", gamma=GAMMA)), **F64)
    assert type(got).__name__ == KINDS[name]
    want, dec = _decisions(jm, got, Xte)
    np.testing.assert_allclose(dec, want, rtol=0, atol=TOL)


class _Count:
    """Wraps an ``ops`` wrapper and counts its calls (on the CPU the
    wrappers run their plain versions and count no launch)."""

    def __init__(self, monkeypatch, name):
        self.n, fn = 0, getattr(ops, name)

        def wrapped(*a, **kw):
            self.n += 1
            return fn(*a, **kw)

        monkeypatch.setattr(ops, name, wrapped)


# the wrappers each case's kernel route calls (RFF: none)
ROUTES = {"exact": ("kernel_matrix",),
          "exact-gram-free": ("kernel_matvec", "cd_column_update"),
          "cascade": ("kernel_matrix",), "llsvm": ("kernel_matrix",),
          "rff": (), "ltpu": ("kernel_matrix",)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_route_on_the_cpu(data, name, monkeypatch):
    """``use_kernels=True`` on CPU tensors goes through the wrappers (their
    plain versions, f32) and meets the plain f32 fit; RFF calls none."""
    Xtr, ytr, Xte, _ = data
    call, extra, _ = CASES[name]
    dr = _draws(*Xtr.shape)
    kern = Kernel("rbf", gamma=GAMMA)
    f32 = dict(device="cpu", dtype=torch.float32)
    if "tol" in extra:
        extra = dict(extra, tol=1e-3)       # within f32's reach
    plain = call(TB, kern, Xtr, ytr, dr, use_kernels=False, **extra, **f32)
    counts = {w: _Count(monkeypatch, w) for w in
              ("kernel_matrix", "kernel_matvec", "cd_column_update")}
    routed = call(TB, kern, Xtr, ytr, dr, use_kernels=True, **extra, **f32)
    dec = routed.decision(Xte)
    called = {w for w, c in counts.items() if c.n}
    assert called == set(ROUTES[name]) | ({"kernel_matrix"}
                                          if name != "rff" else set())
    assert dec.dtype == torch.float32
    np.testing.assert_allclose(dec.numpy(), plain.decision(Xte).numpy(),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", ["llsvm", "rff", "ltpu"])
def test_default_draws_follow_the_seed(data, name):
    """Without the reference's draws the port draws from a CPU generator
    seeded with ``seed``: the same seed, the same model."""
    Xtr, ytr, _, _ = data
    kern = Kernel("rbf", gamma=GAMMA)
    fn = {"llsvm": lambda s: TB.train_llsvm(Xtr, ytr, kern, C, 16, seed=s,
                                            max_iters=50, **F64),
          "rff": lambda s: TB.train_rff(Xtr, ytr, kern, C, 32, seed=s,
                                        max_iters=50, **F64),
          "ltpu": lambda s: TB.train_ltpu(Xtr, ytr, kern, 16, seed=s,
                                          **F64)}[name]
    a, b, c = fn(1), fn(1), fn(2)
    assert torch.equal(a.w, b.w) and not torch.equal(a.w, c.w)


def test_rff_refuses_a_kernel_it_cannot_approximate(data):
    Xtr, ytr, _, _ = data
    with pytest.raises(ValueError, match="rbf"):
        TB.train_rff(Xtr, ytr, Kernel("poly"), C, device="cpu")


@pytest.mark.parametrize("kind", ["rbf", "poly", "linear"])
def test_gram_blocks_matches_reference(kind):
    """(k, nc, d) -> (k, nc, nc): the reference's vmapped Grams in
    float64, and the kernel route (one batched kermat; on the CPU its plain
    version, f32) at kermat's 2e-5."""
    Xc = np.random.default_rng(1).uniform(size=(3, 40, 7))
    kw = dict(gamma=0.5) if kind != "linear" else {}
    with jax.enable_x64(True):
        want = np.asarray(jgram_blocks(JKernel(kind, **kw), Xc))
    kern = Kernel(kind, **kw)
    got = gram_blocks(kern, torch.from_numpy(Xc))
    assert got.shape == (3, 40, 40) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    routed = gram_blocks(kern, torch.from_numpy(Xc).float(),
                         use_kernels=True)
    torch.testing.assert_close(
        routed, ref.kermat_ref(torch.from_numpy(Xc).float(),
                               torch.from_numpy(Xc).float(), kind=kind,
                               gamma=kern.gamma, degree=kern.degree,
                               coef0=kern.coef0), rtol=0, atol=0)
    np.testing.assert_allclose(routed.numpy(), want, rtol=2e-5, atol=2e-5)
