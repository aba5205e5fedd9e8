"""The slice end to end: port fit/predict vs the JAX reference.

Both sides get the same numpy data; the port gets the reference's own
k-means draws (its ``jax.random`` key chain, replayed here), so the two
run the same Algorithm 1.  Tolerances are the reference's: per-level alpha
1e-4 and early decisions 1e-4 (tests/test_conquer_pallas.py), the
objective 1e-5 relative.  The reference runs its plain path; the port runs
its plain versions and, through the kernel wrappers, the kernels' plain
versions.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import dcsvm as JD
from repro.core import predict as JP
from repro.core.kernels import Kernel as JKernel
from repro_torch import convert
from repro_torch.core import dcsvm as D
from repro_torch.core import predict as P
from repro_torch.core.kernels import Kernel
from repro_torch.data import gaussian_mixture, train_test_split

CFG = dict(C=4.0, k=4, levels=2, m=120, tol=1e-5, max_iters=20000, seed=3)
BRANCHES = {"dense": {}, "matvec": {"full_gram_threshold": 64}}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X, y = gaussian_mixture(rng, 500, d=8, modes_per_class=4, spread=0.15,
                            label_noise=0.02)
    return train_test_split(rng, X, y)


def jax_draws(seed: int, m: int):
    """The reference's per-level k-means draws: its key chain
    (``dcsvm.py`` splits one key per level, ``kkmeans.py`` splits that into
    a sample key and an init key)."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draws(level, n, m_sample):
        state["key"], sub = jax.random.split(state["key"])
        key_sample, key_init = jax.random.split(sub)
        sample = jax.random.choice(key_sample, n, shape=(min(m, n),),
                                   replace=False)
        return (np.asarray(sample),
                np.asarray(jax.random.permutation(key_init, m_sample)))

    return draws


def _fit_pair(data, extra, use_kernels):
    Xtr, ytr, _, _ = data
    jcfg = JD.DCSVMConfig(kernel=JKernel("rbf", gamma=8.0), use_pallas=False,
                          **CFG, **extra)
    tcfg = D.DCSVMConfig(kernel=Kernel("rbf", gamma=8.0),
                         use_kernels=use_kernels, **CFG, **extra)
    jl, tl = {}, {}
    jm = JD.fit(jcfg, Xtr, ytr,
                callback=lambda l, a, st: jl.__setitem__(l, np.asarray(a)))
    tm = D.fit(tcfg, Xtr, ytr, device="cpu",
               callback=lambda l, a, st: tl.__setitem__(l, a.numpy().copy()),
               draws=jax_draws(CFG["seed"], CFG["m"]))
    return jm, tm, jl, tl


@pytest.fixture(scope="module")
def reference_fits(data):
    """One reference fit per level-0 branch, shared by the tests."""
    return {b: _fit_pair(data, extra, False) for b, extra in BRANCHES.items()}


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_fit_matches_reference(data, reference_fits, branch, use_kernels):
    Xtr, ytr, Xte, yte = data
    if use_kernels:
        jm, tm, jl, tl = _fit_pair(data, BRANCHES[branch], True)
    else:
        jm, tm, jl, tl = reference_fits[branch]
    assert sorted(tl) == sorted(jl) == [0, 1, 2]
    for level in jl:
        np.testing.assert_allclose(tl[level], jl[level], rtol=0, atol=1e-4,
                                   err_msg=f"level {level}")
    assert [set(s) for s in tm.level_stats] == [set(s) for s in jm.level_stats]
    for ts, js in zip(tm.level_stats, jm.level_stats):
        assert ts["n_sv"] == js["n_sv"]
    f_ref = float(JD.objective_value(jm.config, jm.X, jm.y, jm.alpha))
    f_got = float(D.objective_value(tm.config, tm.X, tm.y, tm.alpha))
    assert abs(f_got - f_ref) <= 1e-5 * abs(f_ref)
    acc_ref = JP.accuracy(yte, JP.predict_exact(jm, Xte))
    acc_got = P.accuracy(yte, P.predict_exact(tm, Xte))
    assert acc_got == acc_ref


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_decision_early_matches_reference(data, use_kernels):
    Xtr, ytr, Xte, _ = data
    jcfg = JD.DCSVMConfig(kernel=JKernel("rbf", gamma=8.0), use_pallas=False,
                          early_stop_level=1, **CFG)
    tcfg = D.DCSVMConfig(kernel=Kernel("rbf", gamma=8.0),
                         use_kernels=use_kernels, early_stop_level=1, **CFG)
    jm = JD.fit(jcfg, Xtr, ytr)
    tm = D.fit(tcfg, Xtr, ytr, device="cpu",
               draws=jax_draws(CFG["seed"], CFG["m"]))
    assert tm.is_early and jm.is_early
    np.testing.assert_array_equal(tm.partition.assign,
                                  np.asarray(jm.partition.assign))
    want = np.asarray(JP.decision_early(jm, Xte, use_pallas=False))
    got = P.decision_early(tm, Xte).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # a query batch past the bucket capacity takes extra rounds
    Xq = np.repeat(Xte[:5], 40, axis=0)
    np.testing.assert_allclose(
        P.decision_early(tm, Xq).numpy(),
        np.asarray(JP.decision_early(jm, Xq, use_pallas=False)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_carried_weights_predict_the_same(data, reference_fits, use_kernels):
    """A JAX-fitted model carried over by ``convert.from_jax_arrays``."""
    _, _, Xte, _ = data
    jm = reference_fits["dense"][0]
    p = jm.partition
    arrays = {"X": jm.X, "y": jm.y, "alpha": jm.alpha, "beta": jm.beta,
              "assign": p.assign, "idx": p.idx, "mask": p.mask,
              "Xm": p.model.Xm, "W": p.model.W, "s": p.model.s}
    cfg = D.DCSVMConfig(kernel=Kernel("rbf", gamma=8.0),
                        use_kernels=use_kernels,
                        **CFG)
    tm = convert.from_jax_arrays({k: np.asarray(v) for k, v in arrays.items()},
                                 cfg, device="cpu")
    np.testing.assert_allclose(
        P.decision_exact(tm, Xte).numpy(),
        np.asarray(JP.decision_exact(jm, Xte, use_pallas=False)),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        P.decision_early(tm, Xte).numpy(),
        np.asarray(JP.decision_early(jm, Xte, use_pallas=False)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nq", [0, 1, 7, 8, 9, 100, 4096, 4097, 10000])
def test_bucket_size_matches_reference(nq):
    assert P.bucket_size(nq) == JP.bucket_size(nq)
    assert P.bucket_size(nq, lo=16, hi=64) == JP.bucket_size(nq, lo=16, hi=64)


def test_unported_features_raise():
    # the precision policy, the memory tiers and the trace are ported
    for field, value in (("compute_dtype", "bfloat16"), ("host_spill", True),
                         ("col_cache_cap", 8), ("trace", 16)):
        assert getattr(D.DCSVMConfig(**{field: value}), field) == value

    @dataclasses.dataclass(frozen=True)
    class OtherTask(D.Task):
        name = "other"

    with pytest.raises(NotImplementedError):
        D.fit(D.DCSVMConfig(), np.zeros((8, 2)), np.ones(8), device="cpu",
              task=OtherTask())


@pytest.mark.parametrize("argv,summary", [
    (["--task", "weighted-svc", "--dataset", "imbalanced"], "recall +1"),
    (["--task", "svr", "--dataset", "friedman1"], "test mse"),
    (["--task", "one-class", "--dataset", "outliers"], "outlier recall"),
    (["--task", "nu-svc", "--nu", "0.3"], "test acc"),
    (["--task", "nu-svc", "--nu", "0.3", "--nu-bias", "--eq-block", "4"],
     "test acc"),
    (["--task", "one-class", "--dataset", "outliers", "--early", "1"],
     "early prediction (level 1)")],
    ids=["weighted-svc", "svr", "one-class", "nu-svc", "nu-svc-bias-blocked",
         "one-class-early"])
def test_train_cli_runs_every_task_on_the_cpu(capsys, argv, summary):
    from repro_torch.launch import train_svm

    train_svm.main(argv + ["--n", "500", "--levels", "2", "--m", "200",
                           "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("done in") and summary in out[-1]
    assert any(line.startswith("level 0") or "early" in out[-1]
               for line in out)


def test_train_cli_rejects_mismatched_dataset():
    from repro_torch.launch import train_svm

    with pytest.raises(SystemExit):
        train_svm.main(["--task", "svr", "--dataset", "gaussian",
                        "--device", "cpu"])
