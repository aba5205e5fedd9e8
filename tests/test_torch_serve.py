"""The port's serving path vs the JAX reference's ``launch/serve_svm``.

Reference models (one-vs-all and binary) are trained by the JAX package,
carried over by ``repro_torch.convert`` and exported on both sides; every
strategy then serves the same queries, bucketed and not.  The predictions
must be the same and the scores agree to 2e-4 of 1 + |score| (the
reference's kernel_matvec tolerance; the BCM solves run in float32 on both
sides).  The port runs its plain versions and, through the kernel
wrappers, the kernels' plain versions.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import dcsvm as JD
from repro.core import multiclass as JM
from repro.core.kernels import Kernel as JKernel
from repro.data import gaussian_mixture as jmixture
from repro.data import gaussian_mixture_multiclass as jmixture_mc
from repro.data import train_test_split as jsplit
from repro.launch import serve_svm as JS
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro_torch import convert
from repro_torch.core.dcsvm import DCSVMConfig
from repro_torch.core.kernels import Kernel
from repro_torch.core.predict import (accuracy_multiclass, decision_early,
                                      decision_exact, decision_early_ova)
from repro_torch.launch import serve_svm as S
from repro_torch.obs.metrics import MetricsRegistry

GAMMA = 16.0
CFG = dict(C=4.0, k=4, levels=2, m=150, tol=1e-3, seed=0)
STRATEGIES = ["exact", "early", "bcm"]
REPORT_KEYS = {"strategy", "batch", "batches", "queries", "compiles_timed",
               "qps", "lat_ms_mean", "lat_ms_p50", "lat_ms_p95", "lat_ms_p99"}


def _partition_arrays(jm):
    p = jm.partition
    return {"assign": p.assign, "idx": p.idx, "mask": p.mask,
            "Xm": p.model.Xm, "W": p.model.W, "s": p.model.s}


def _cfg(use_kernels):
    return DCSVMConfig(kernel=Kernel("rbf", gamma=GAMMA),
                       use_kernels=use_kernels, **CFG)


@pytest.fixture(scope="module")
def reference_models():
    """A JAX one-vs-all model (3 classes) and a JAX binary model, with
    their test queries."""
    X, y = jmixture_mc(jax.random.PRNGKey(0), 450, n_classes=3, d=8,
                       spread=0.10)
    Xtr, ytr, Xte, yte = (np.asarray(a) for a in
                          jsplit(jax.random.PRNGKey(1), X, y))
    jcfg = JD.DCSVMConfig(kernel=JKernel("rbf", gamma=GAMMA),
                          use_pallas=False, **CFG)
    ova = JM.fit_ova(jcfg, Xtr, ytr)
    Xb, yb = jmixture(jax.random.PRNGKey(2), 400, d=6, modes_per_class=3)
    Xbtr, ybtr, Xbte, ybte = (np.asarray(a) for a in
                              jsplit(jax.random.PRNGKey(3), Xb, yb))
    binary = JD.fit(jcfg, Xbtr, ybtr)
    return {"ova": (ova, Xte, yte), "binary": (binary, Xbte, ybte)}


def _carry(kind, jm, use_kernels):
    arrays = dict(_partition_arrays(jm), X=jm.X, alpha=jm.alpha)
    if kind == "ova":
        arrays.update(classes=jm.classes, Y=jm.Y)
        return convert.from_jax_multiclass(
            {k: np.asarray(v) for k, v in arrays.items()},
            _cfg(use_kernels), device="cpu")
    arrays.update(y=jm.y, beta=jm.beta)
    return convert.from_jax_arrays({k: np.asarray(v) for k, v in arrays.items()},
                                   _cfg(use_kernels), device="cpu")


@pytest.fixture(scope="module")
def exports(reference_models):
    """(reference export, port export (plain), port export (kernels)) per
    model kind."""
    out = {}
    for kind, (jm, _, _) in reference_models.items():
        out[kind] = (JS.export_serving_model(jm),
                     S.export_serving_model(_carry(kind, jm, False)),
                     S.export_serving_model(_carry(kind, jm, True)))
    return out


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max() <= 2e-4, err.max()


@pytest.mark.parametrize("bucket", [None, 128], ids=["ragged", "bucketed"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("kind", ["ova", "binary"])
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_serve_batch_matches_reference(reference_models, exports, kind,
                                       strategy, bucket, use_kernels):
    jm, Xte, _ = reference_models[kind]
    jsm, psm, ksm = exports[kind]
    sm = ksm if use_kernels else psm
    Xq = Xte[:97]
    jp, js = JS.serve_batch(jsm, Xq, JS.Kernel("rbf", gamma=GAMMA), strategy,
                            bucket=bucket)
    tp, ts = S.serve_batch(sm, Xq, Kernel("rbf", gamma=GAMMA), strategy,
                           use_kernels=use_kernels, bucket=bucket)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _close(ts.numpy(), js)


@pytest.mark.parametrize("kind", ["ova", "binary"])
def test_export_matches_reference(exports, kind):
    """Same packed SV blocks, masks, SV union and BCM factors."""
    jsm, psm, _ = exports[kind]
    for field in ("Xm", "Wm", "sm", "Xsv", "Wsv", "svmask", "Xall", "Wall",
                  "classes"):
        np.testing.assert_allclose(getattr(psm, field).numpy(),
                                   np.asarray(getattr(jsm, field)),
                                   rtol=0, atol=1e-6, err_msg=field)
    np.testing.assert_allclose(psm.Lchol.numpy(), np.asarray(jsm.Lchol),
                               rtol=0, atol=2e-4)


def test_round_trip_matches_training_side(reference_models, exports):
    """Serving exact/early on a full export equals the training-side
    decisions of the same (carried-over) model."""
    jm, Xte, yte = reference_models["binary"]
    tm = _carry("binary", jm, False)
    _, psm, _ = exports["binary"]
    kern = Kernel("rbf", gamma=GAMMA)
    _, se = S.serve_batch(psm, Xte, kern, "exact")
    _, sl = S.serve_batch(psm, Xte, kern, "early", bucket=128)
    _close(se[:, 1].numpy(), decision_exact(tm, Xte).numpy())
    _close(sl[:, 1].numpy(), decision_early(tm, Xte).numpy())
    jo, Xo, yo = reference_models["ova"]
    to = _carry("ova", jo, False)
    pred, so = S.serve_batch(exports["ova"][1], Xo, kern, "early")
    _close(so.numpy(), decision_early_ova(to, Xo).numpy())
    assert accuracy_multiclass(yo, pred) >= 0.9


def test_export_thins_large_clusters_like_reference(reference_models):
    jm, Xte, _ = reference_models["ova"]
    with pytest.warns(UserWarning, match="max_sv_per_cluster"):
        jsm = JS.export_serving_model(jm, max_sv_per_cluster=8)
    with pytest.warns(UserWarning, match="max_sv_per_cluster"):
        psm = S.export_serving_model(_carry("ova", jm, False),
                                     max_sv_per_cluster=8)
    np.testing.assert_array_equal(psm.svmask.numpy(), np.asarray(jsm.svmask))
    for strategy in ("early", "bcm"):
        jp, js = JS.serve_batch(jsm, Xte, JS.Kernel("rbf", gamma=GAMMA),
                                strategy)
        tp, ts = S.serve_batch(psm, Xte, Kernel("rbf", gamma=GAMMA), strategy)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        _close(ts.numpy(), js)


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_request_loop_report(exports, reference_models, strategy, bucketed):
    _, Xte, _ = reference_models["ova"]
    sm = exports["ova"][1]
    kern = Kernel("rbf", gamma=GAMMA)
    if bucketed:
        batches = [Xte[:5], Xte[5:35], Xte[35:36], Xte[36:66]]
    else:
        idx = np.random.default_rng(0).integers(0, Xte.shape[0], (3, 32))
        batches = torch.from_numpy(Xte[idx])
    reg = MetricsRegistry()
    rep = S.run_request_loop(sm, kern, strategy, batches, warmup=1,
                             metrics=reg, bucketed=bucketed)
    assert set(rep) == REPORT_KEYS
    assert rep["compiles_timed"] == 0
    assert rep["qps"] > 0 and rep["lat_ms_p99"] >= rep["lat_ms_p50"] > 0
    nq = 66 if bucketed else 96
    assert rep["queries"] == nq
    assert (rep["batches"], rep["batch"]) == ((4, 0) if bucketed else (3, 32))
    counters = reg.to_json()["counters"]
    assert counters[f'serve_queries_total{{strategy="{strategy}"}}'] == nq
    if strategy == "early":
        routed = sum(v for k, v in counters.items()
                     if k.startswith("serve_route_total"))
        assert routed == nq
        assert "serve_early_overflow_rounds_total" in counters


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_serve_empty_batch(exports, reference_models, strategy):
    _, Xte, _ = reference_models["ova"]
    pred, scores = S.serve_batch(exports["ova"][1], Xte[:0],
                                 Kernel("rbf", gamma=GAMMA), strategy)
    assert pred.shape == (0,) and scores.shape == (0, 3)


def test_serve_rejects_bad_requests(exports, reference_models):
    _, Xte, _ = reference_models["ova"]
    kern = Kernel("rbf", gamma=GAMMA)
    with pytest.raises(ValueError, match="unknown strategy"):
        S.serve_batch(exports["ova"][1], Xte[:4], kern, "nope")
    with pytest.raises(ValueError, match="bucket"):
        S.serve_batch(exports["ova"][1], Xte[:9], kern, "exact", bucket=8)
    jm = reference_models["ova"][0]
    sm = S.export_serving_model(_carry("ova", jm, False), with_bcm=False)
    assert sm.Lchol.shape[1] == 0
    assert S.serve_batch(sm, Xte[:16], kern, "early")[0].shape == (16,)
    with pytest.raises(ValueError, match="with_bcm"):
        S.serve_batch(sm, Xte[:4], kern, "bcm")


def test_bcm_factor_failure_names_the_cluster():
    """torch's Cholesky of a matrix that is not positive definite fails
    loudly, naming the cluster, instead of carrying NaNs into the scores."""
    Xsv = torch.zeros((2, 3, 2))
    Xsv[1, :, 0] = torch.tensor([0.0, 1.0, 2.0])
    mask = torch.ones((2, 3), dtype=torch.bool)
    with pytest.raises(RuntimeError, match="cluster 0"):
        S._bcm_factor(Kernel("rbf", gamma=1.0), Xsv, mask, -1.0, False)


def test_unported_tasks_and_async_raise(capsys, tmp_path):
    """``--serve-async`` serves on the CPU: a Poisson trace of 30
    mixed-size requests through the engine, every one delivered, with the
    reference's summary fields and the registry's manifests saved."""
    reg = tmp_path / "registry.json"
    S.main(["--serve-async", "--device", "cpu", "--n", "600", "--batches",
            "30", "--registry", str(reg)])
    text = capsys.readouterr().out
    line = next(ln for ln in text.splitlines()
                if ln.startswith("async early v1: 30 requests ("))
    for field in ("queries) at 500 offered rps", "delivered 30 shed 0 "
                  "expired 0", "admitted lat ms p50 ", " p95 ", " p99 ",
                  "warmup compiles 0, after warmup 0"):
        assert field in line, (field, line)
    saved = json.loads(reg.read_text())
    assert saved["route"] == {"default": 1}
    assert saved["models"][0]["strategies"] == ["exact", "early"]


def test_cli_serves_on_the_cpu(capsys, tmp_path):
    out = tmp_path / "metrics.json"
    S.main(["--n", "600", "--device", "cpu", "--batches", "3", "--batch",
            "16", "--metrics-out", str(out)])
    text = capsys.readouterr().out
    acc = float(text.split("serving accuracy (early): ")[1].split()[0])
    assert acc >= 0.9
    assert "compiles_timed 0" in text
    assert out.exists() and out.with_suffix(".prom").exists()


def test_metrics_registry_matches_reference(tmp_path):
    """The port's copy of the metrics module exposes the same JSON and
    Prometheus text as the reference for the same observations."""
    regs = (MetricsRegistry(), JRegistry())
    for reg in regs:
        reg.describe("serve_latency_seconds", "request latency")
        for v in (3e-5, 2e-3, 2e-3, 0.4, 12.0):
            reg.histogram("serve_latency_seconds", strategy="early").observe(v)
        reg.counter("serve_requests_total", strategy="early").inc(5)
        reg.gauge("queue_rows").set(7)
    assert regs[0].to_json() == regs[1].to_json()
    assert regs[0].to_prometheus_text() == regs[1].to_prometheus_text()
    prom = regs[0].dump(str(tmp_path / "m.json"))
    assert open(prom).read() == regs[1].to_prometheus_text()


# ---------------------------------------------------------------------------
# the regression and one-class exports
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def task_models():
    """JAX-fitted epsilon-SVR (exact) and one-class SVM (early: per-cluster
    rho_c) models carried to the port, each exported on both sides with
    every SV, with their queries."""
    from repro.core import tasks as JT
    from repro.data import friedman1 as jfriedman
    from repro.data import gaussian_with_outliers as joutliers
    from repro_torch.core import tasks as T

    out = {}
    for kind, (gen, task, ptask, extra) in {
            "svr": (jfriedman, JT.EpsilonSVR(eps=0.1), T.EpsilonSVR(eps=0.1),
                    {}),
            "ocsvm": (joutliers, JT.OneClassSVM(nu=0.2),
                      T.OneClassSVM(nu=0.2), {"early_stop_level": 1})}.items():
        X, y = gen(jax.random.PRNGKey(5), 400)
        Xtr, ytr, Xte, _ = (np.asarray(a) for a in
                            jsplit(jax.random.PRNGKey(6), X, y))
        jcfg = JD.DCSVMConfig(kernel=JKernel("rbf", gamma=GAMMA),
                              use_pallas=False, **CFG, **extra)
        jm = JD.fit(jcfg, Xtr, None if kind == "ocsvm" else ytr, task=task)
        arrays = dict(_partition_arrays(jm), X=jm.X, y=jm.y, alpha=jm.alpha,
                      beta=jm.beta, rho=jm.rho, rho_clusters=jm.rho_clusters)
        tm = convert.from_jax_arrays(
            {k: (None if v is None else np.asarray(v))
             for k, v in arrays.items()},
            DCSVMConfig(kernel=Kernel("rbf", gamma=GAMMA), use_kernels=False,
                        early_stop_level=extra.get("early_stop_level", 0),
                        **CFG), device="cpu", is_early=jm.is_early,
            task=ptask)
        big = 10 ** 6
        out[kind] = (jm, tm, Xte,
                     JS.export_serving_model(jm, max_sv_per_cluster=big),
                     S.export_serving_model(tm, max_sv_per_cluster=big))
    return out


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("kind", ["svr", "ocsvm"])
def test_task_exports_serve_like_reference(task_models, kind, strategy):
    """The svr export (one beta column, no classes) and the ocsvm export
    (one column, rho and the per-cluster rho_c) served through serve_batch
    against the reference's serving of the same model, bucketed."""
    jm, tm, Xte, jsm, psm = task_models[kind]
    assert psm.task == jsm.task == kind
    assert psm.classes.shape == jsm.classes.shape
    np.testing.assert_allclose(psm.rho_c.numpy(), np.asarray(jsm.rho_c),
                               rtol=0, atol=1e-6)
    Xq = Xte[:70]
    jp, js = JS.serve_batch(jsm, Xq, JS.Kernel("rbf", gamma=GAMMA), strategy,
                            bucket=128)
    tp, ts = S.serve_batch(psm, Xq, Kernel("rbf", gamma=GAMMA), strategy,
                           bucket=128)
    _close(ts.numpy(), js)
    if kind == "svr":
        _close(tp.numpy(), jp)
    else:
        clear = np.abs(np.asarray(js)[:, 0]) > 1e-4
        np.testing.assert_array_equal(tp.numpy()[clear],
                                      np.asarray(jp)[clear])


@pytest.mark.parametrize("kind", ["svr", "ocsvm"])
def test_task_exports_round_trip_to_training_side(task_models, kind):
    """Exact and early serving of a full export equal the training-side
    decision_exact and decision_early (early with rho_c) of the model."""
    _, tm, Xte, _, psm = task_models[kind]
    kern = Kernel("rbf", gamma=GAMMA)
    _, se = S.serve_batch(psm, Xte, kern, "exact")
    _, sl = S.serve_batch(psm, Xte, kern, "early", bucket=128)
    _close(se[:, 0].numpy(), decision_exact(tm, Xte).numpy())
    _close(sl[:, 0].numpy(), decision_early(tm, Xte).numpy())
    if kind == "ocsvm":
        assert tm.rho_clusters is not None
        assert psm.rho_c.shape == (psm.k,)


@pytest.mark.parametrize("task", ["svr", "ocsvm"])
def test_cli_serves_regression_and_one_class(capsys, task):
    S.main(["--task", task, "--n", "500", "--device", "cpu", "--batches",
            "3", "--batch", "16"])
    text = capsys.readouterr().out
    if task == "svr":
        assert float(text.split("serving mse (early): ")[1].split()[0]) < 1.0
    else:
        rec = float(text.split("outlier recall (early): ")[1].split()[0])
        assert 0.0 <= rec <= 1.0 and "rho=" in text
    assert "compiles_timed 0" in text
