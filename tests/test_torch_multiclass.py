"""One-vs-all DC-SVM: the port's fit_ova and OVA prediction vs the JAX
reference.

Both sides get the same numpy data, and the port gets the reference's own
k-means draws (its ``jax.random`` key chain, replayed here), so the two
run the same class-stacked Algorithm 1.  Tolerances are those of
tests/test_torch_fit.py: alpha 1e-4 at tol = 1e-5, decisions 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multiclass as JM
from repro.core import predict as JP
from repro.core.dcsvm import DCSVMConfig as JConfig
from repro.core.kernels import Kernel as JKernel
from repro.data import gaussian_mixture_multiclass as jmixture
from repro_torch import convert
from repro_torch.core import multiclass as M
from repro_torch.core import predict as P
from repro_torch.core.dcsvm import DCSVMConfig
from repro_torch.core.kernels import Kernel
from repro_torch.data import gaussian_mixture_multiclass, train_test_split

CFG = dict(C=4.0, k=3, levels=2, m=90, tol=1e-5, max_iters=20000, seed=5)


def jax_draws(seed: int, m: int):
    """The reference's per-level k-means draws (``dcsvm.py`` splits one key
    per level, ``kkmeans.py`` splits it into a sample and an init key)."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draws(level, n, m_sample):
        state["key"], sub = jax.random.split(state["key"])
        key_sample, key_init = jax.random.split(sub)
        sample = jax.random.choice(key_sample, n, shape=(min(m, n),),
                                   replace=False)
        return (np.asarray(sample),
                np.asarray(jax.random.permutation(key_init, m_sample)))

    return draws


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    X, y = gaussian_mixture_multiclass(rng, 360, n_classes=3, d=6,
                                       spread=0.12)
    return train_test_split(rng, X, y)


def _fit_pair(data, use_kernels, class_weight=None):
    Xtr, ytr, _, _ = data
    jcfg = JConfig(kernel=JKernel("rbf", gamma=8.0), use_pallas=False, **CFG)
    tcfg = DCSVMConfig(kernel=Kernel("rbf", gamma=8.0),
                       use_kernels=use_kernels, **CFG)
    jl, tl = {}, {}
    jm = JM.fit_ova(jcfg, Xtr, ytr, class_weight=class_weight,
                    callback=lambda l, a, st: jl.__setitem__(l, np.asarray(a)))
    tm = M.fit_ova(tcfg, Xtr, ytr, class_weight=class_weight, device="cpu",
                   callback=lambda l, a, st: tl.__setitem__(l, a.numpy().copy()),
                   draws=jax_draws(CFG["seed"], CFG["m"]))
    return jm, tm, jl, tl


@pytest.fixture(scope="module")
def reference_pair(data):
    return _fit_pair(data, False)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_fit_ova_matches_reference(data, reference_pair, use_kernels):
    jm, tm, jl, tl = (reference_pair if not use_kernels
                      else _fit_pair(data, True))
    np.testing.assert_array_equal(tm.classes, np.asarray(jm.classes))
    np.testing.assert_array_equal(tm.Y.numpy(), np.asarray(jm.Y))
    assert tm.alpha.shape == (3, data[0].shape[0])
    assert sorted(tl) == sorted(jl) == [0, 1, 2]
    for level in jl:
        np.testing.assert_allclose(tl[level], jl[level], rtol=0, atol=1e-4,
                                   err_msg=f"level {level}")
    np.testing.assert_array_equal(tm.partition.assign,
                                  np.asarray(jm.partition.assign))
    np.testing.assert_array_equal(tm.sv_union, jm.sv_union)
    assert [s["n_sv"] for s in tm.level_stats] == \
        [s["n_sv"] for s in jm.level_stats]


def test_fit_ova_class_weight_matches_reference(data):
    jm, tm, _, _ = _fit_pair(data, False, class_weight={0: 3.0})
    np.testing.assert_allclose(tm.alpha.numpy(), np.asarray(jm.alpha),
                               rtol=0, atol=1e-4)
    assert float(tm.alpha[0].max()) > CFG["C"]      # the upweighted box


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_ova_decisions_match_reference(data, reference_pair, use_kernels):
    """exact, early (eq. 11) and BCM decision matrices and their argmax
    classes on the same carried-over model."""
    _, _, Xte, yte = data
    jm = reference_pair[0]
    p = jm.partition
    arrays = {"X": jm.X, "classes": jm.classes, "Y": jm.Y, "alpha": jm.alpha,
              "assign": p.assign, "idx": p.idx, "mask": p.mask,
              "Xm": p.model.Xm, "W": p.model.W, "s": p.model.s}
    tm = convert.from_jax_multiclass(
        {k: np.asarray(v) for k, v in arrays.items()},
        DCSVMConfig(kernel=Kernel("rbf", gamma=8.0), use_kernels=use_kernels,
                    **CFG), device="cpu")
    for name, got, want in (
            ("exact", P.decision_exact_ova(tm, Xte),
             JP.decision_exact_ova(jm, Xte, use_pallas=False)),
            ("early", P.decision_early_ova(tm, Xte),
             JP.decision_early_ova(jm, Xte, use_pallas=False)),
            ("bcm", P.decision_bcm_ova(tm, Xte), JP.decision_bcm_ova(jm, Xte))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    for got, want in ((P.predict_exact_ova, JP.predict_exact_ova),
                      (P.predict_early_ova, JP.predict_early_ova),
                      (P.predict_bcm_ova, JP.predict_bcm_ova)):
        pt, pj = got(tm, Xte).numpy(), np.asarray(want(jm, Xte))
        np.testing.assert_array_equal(pt, pj)
        assert P.accuracy_multiclass(yte, pt) == \
            JP.accuracy_multiclass(yte, pj)
    assert P.accuracy_multiclass(yte, P.predict_exact_ova(tm, Xte)) >= 0.9


def test_binary_view_and_bcm_match_reference(data, reference_pair):
    """``MulticlassModel.binary(c)`` is class c's machine as a binary model;
    the binary ``decision_bcm`` matches the reference's on it."""
    _, _, Xte, _ = data
    jm, tm = reference_pair[:2]
    scores = P.decision_exact_ova(tm, Xte)
    for c in range(tm.n_classes):
        tb, jb = tm.binary(c), jm.binary(c)
        np.testing.assert_allclose(P.decision_exact(tb, Xte).numpy(),
                                   scores[:, c].numpy(), atol=1e-4)
        np.testing.assert_allclose(P.decision_bcm(tb, Xte).numpy(),
                                   np.asarray(JP.decision_bcm(jb, Xte)),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(P.predict_bcm(tb, Xte).numpy(),
                                      np.asarray(JP.predict_bcm(jb, Xte)))


@pytest.mark.parametrize("n_classes", [None, 4])
def test_labels_to_ova_matches_reference(n_classes):
    y = np.array([2, 0, 1, 1, 2, 0])
    jc, jY = JM.labels_to_ova(jnp.asarray(y), n_classes)
    tc, tY = M.labels_to_ova(y, n_classes)
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(tY.numpy(), np.asarray(jY))


def test_labels_to_ova_rejects_bad_labels():
    with pytest.raises(ValueError):
        M.labels_to_ova(np.asarray([0, 4]), n_classes=3)
    with pytest.raises(ValueError):
        M.labels_to_ova(np.asarray([0.5, 1.0]), n_classes=2)


@pytest.mark.parametrize("weights", [{0: 5.0}, [5.0, 1.0, 2.0]],
                         ids=["dict", "array"])
def test_ova_cost_vectors_match_reference(weights):
    y = np.array([0, 1, 2, 0])
    jc, jY = JM.labels_to_ova(jnp.asarray(y))
    tc, tY = M.labels_to_ova(y)
    np.testing.assert_array_equal(
        M.ova_cost_vectors(tY, 2.0, weights, tc).numpy(),
        np.asarray(JM.ova_cost_vectors(jY, 2.0, weights, jc)))
    with pytest.raises(ValueError):
        M.ova_cost_vectors(tY, 2.0, {7: 3.0}, tc)
    with pytest.raises(ValueError):
        M.ova_cost_vectors(tY, 2.0, [1.0, 2.0], tc)


def test_gaussian_mixture_multiclass_matches_reference_layout():
    """The numpy generator has the reference's structure: float32 points in
    [0, 1]^d and int32 labels 0..n_classes-1, mode // modes_per_class."""
    X, y = gaussian_mixture_multiclass(np.random.default_rng(0), 500,
                                       n_classes=4, d=7)
    jX, jy = jmixture(jax.random.PRNGKey(0), 500, n_classes=4, d=7)
    assert X.shape == np.asarray(jX).shape and X.dtype == np.asarray(jX).dtype
    assert y.dtype == np.asarray(jy).dtype
    assert set(np.unique(y)) == set(np.unique(np.asarray(jy))) == {0, 1, 2, 3}
    assert X.min() >= 0.0 and X.max() <= 1.0


def test_fit_ova_runs_on_the_default_device_only_with_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        M.fit_ova(DCSVMConfig(), np.zeros((8, 2)), np.arange(8) % 2)
