"""The port's async serving engine and versioned registry
(``repro_torch.launch.{engine,registry}``) against the JAX reference's.

The engine and registry tests of ``tests/test_serve_async.py`` run here on
the port: manifests, routing, continuous batching, deadlines, shed,
supervision and hot swap, with the same gates on ``serve_batch``.  Parity:
manifests equal the reference's field for field (but ``created_unix``), and
one burst through both engines gives the same predictions and scores
within 2e-4 of 1 + |score| (``test_torch_serve.py``'s tolerance).

The bit-equality contract is per merged bucket: each request's rows equal,
bit for bit, a direct ``serve_batch`` of the rows it was packed with
(``_pop_ready``'s rule).  Served alone at its own bucket a request gets
the same predictions (off a 1e-3 margin) and scores within 2e-5 of
1 + sum_j K |w_j|: the plain path's products (the X Y' of the squared
distances, K with the weights) are ``torch.matmul`` calls, and MKL picks
their blocking by row count.
"""
import asyncio
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import dcsvm as JD
from repro.core import multiclass as JM
from repro.core import tasks as JT
from repro.core.kernels import Kernel as JKernel
from repro.data import gaussian_mixture_multiclass as jmixture_mc
from repro.data import gaussian_with_outliers as joutliers
from repro.data import train_test_split as jsplit
from repro.launch import engine as JE
from repro.launch import registry as JR
from repro_torch import convert
from repro_torch.core import DCSVMConfig, Kernel, fit, fit_ova
from repro_torch.core.predict import bucket_size
from repro_torch.core.tasks import EpsilonSVR, OneClassSVM
from repro_torch.data import (friedman1, gaussian_mixture_multiclass,
                              gaussian_with_outliers)
from repro_torch.launch import engine as engine_mod
from repro_torch.launch.engine import (AsyncServingEngine, DeadlineExceeded,
                                       EngineConfig, EngineOverloaded)
from repro_torch.launch.registry import ModelManifest, ModelRegistry
from repro_torch.launch.serve_svm import serve_batch, serving_cache_size

GAMMA = 16.0
KERN = Kernel("rbf", gamma=GAMMA)
CFG = dict(k=4, levels=1, m=150, tol=1e-3, seed=0)
ALONE_TOL = 2e-5          # of 1 + sum_j K |w_j|: a request served alone
PARITY_TOL = 2e-4         # of 1 + |score|: the port against the reference
MARGIN = 1e-3             # predictions compared off this score margin


def _partition_arrays(jm):
    p = jm.partition
    return {"assign": p.assign, "idx": p.idx, "mask": p.mask,
            "Xm": p.model.Xm, "W": p.model.W, "s": p.model.s}


@pytest.fixture(scope="module")
def reference():
    """The module's reference fits: a JAX one-vs-all model (3 classes, 450
    rows) and an early-stopped JAX one-class model (per-cluster rho_c),
    each with its port twin (``repro_torch.convert``) and queries."""
    X, y = jmixture_mc(jax.random.PRNGKey(0), 450, n_classes=3, d=8,
                       spread=0.10)
    Xtr, ytr, Xte, _ = (np.asarray(a) for a in
                        jsplit(jax.random.PRNGKey(1), X, y))
    jcfg = JD.DCSVMConfig(kernel=JKernel("rbf", gamma=GAMMA), C=4.0,
                          use_pallas=False, **CFG)
    jova = JM.fit_ova(jcfg, Xtr, ytr)
    arrays = dict(_partition_arrays(jova), X=jova.X, alpha=jova.alpha,
                  classes=jova.classes, Y=jova.Y)
    tova = convert.from_jax_multiclass(
        {k: np.asarray(v) for k, v in arrays.items()},
        DCSVMConfig(kernel=KERN, C=4.0, use_kernels=False, **CFG),
        device="cpu")
    Xo, _ = joutliers(jax.random.PRNGKey(5), 300)
    Xotr, Xote = np.asarray(Xo[:240]), np.asarray(Xo[240:])
    ocfg = dict(C=1.0, early_stop_level=1, **CFG)
    joc = JD.fit(JD.DCSVMConfig(kernel=JKernel("rbf", gamma=GAMMA),
                                use_pallas=False, **ocfg),
                 Xotr, None, task=JT.OneClassSVM(nu=0.2))
    arrays = dict(_partition_arrays(joc), X=joc.X, y=joc.y, alpha=joc.alpha,
                  beta=joc.beta, rho=joc.rho, rho_clusters=joc.rho_clusters)
    toc = convert.from_jax_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in arrays.items()},
        DCSVMConfig(kernel=KERN, use_kernels=False, **ocfg), device="cpu",
        is_early=joc.is_early, task=OneClassSVM(nu=0.2))
    return {"ova": (jova, tova, Xte), "ocsvm": (joc, toc, Xote),
            "ova_train": (Xtr, ytr)}


@pytest.fixture(scope="module")
def ova_models(reference):
    """Two versions of a 3-class one-vs-all model (the carried reference
    fit at C 4, the port's own fit at C 2) and a query pool."""
    _, m1, Xte = reference["ova"]
    m2 = fit_ova(DCSVMConfig(kernel=KERN, C=2.0, **CFG),
                 *reference["ova_train"], device="cpu")
    return m1, m2, Xte


@pytest.fixture(scope="module")
def registry2(ova_models):
    m1, m2, _ = ova_models
    reg = ModelRegistry()
    reg.register("mix", m1)
    reg.register("mix", m2)
    return reg


def _mixed_batches(Xpool, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [Xpool[rng.integers(0, Xpool.shape[0], size=s)] for s in sizes]


def _packed(sizes, max_batch):
    """The batches ``_pop_ready`` forms from one group's queue when every
    request is queued before the loop pops: request indices, in order,
    each batch up to ``max_batch`` rows (a larger request alone)."""
    groups, cur, total = [], [], 0
    for i, n in enumerate(sizes):
        if cur and total + n > max_batch:
            groups.append(cur)
            cur, total = [], 0
        cur.append(i)
        total += n
    return groups + [cur] if cur else groups


def _abs_weights(sm):
    """The export with |w| and no offsets: its scores are sum_j K |w_j|."""
    return sm._replace(Wsv=sm.Wsv.abs(), Wall=sm.Wall.abs(),
                       rho=torch.zeros_like(sm.rho),
                       rho_c=torch.zeros_like(sm.rho_c))


def _merged_contract(entry, strategy, reqs, outs, config):
    """Hold each request's (pred, scores) to the engine's contract: bit for
    bit a direct serve_batch of its merged bucket; against the request
    served alone, the same predictions off MARGIN and scores within
    ALONE_TOL of 1 + sum_j K |w_j|."""
    sm, kern = entry.sm, entry.kern
    for group in _packed([len(r) for r in reqs], config.max_batch):
        rows = np.concatenate([reqs[i] for i in group])
        bucket = bucket_size(len(rows), lo=config.min_bucket,
                             hi=config.max_bucket)
        mp, ms = serve_batch(sm, rows, kern, strategy, bucket=bucket)
        off = 0
        for i in group:
            n = len(reqs[i])
            pred, scores = outs[i]
            np.testing.assert_array_equal(scores, ms[off:off + n].numpy())
            np.testing.assert_array_equal(pred, mp[off:off + n].numpy())
            off += n
            ap, alone = serve_batch(sm, reqs[i], kern, strategy,
                                    bucket=bucket_size(n))
            _, mag = serve_batch(_abs_weights(sm), reqs[i], kern, strategy,
                                 bucket=bucket_size(n))
            err = np.abs(scores - alone.numpy()) / (1.0 + mag.numpy())
            assert err.max() <= ALONE_TOL, err.max()
            top = np.sort(alone.numpy(), axis=1)
            clear = top[:, -1] - top[:, -2] > MARGIN
            np.testing.assert_array_equal(pred[clear], ap.numpy()[clear])


# ---------------------------------------------------------------------------
# manifests and the registry
# ---------------------------------------------------------------------------

def test_manifest_roundtrip_all_tasks():
    """svc / svr / ocsvm (with the per-cluster rho_c of an early-stopped
    one-class model) manifests all survive the JSON round trip."""
    reg = ModelRegistry()
    kern = Kernel("rbf", gamma=4.0)
    cfg = DCSVMConfig(kernel=kern, C=4.0, k=2, levels=1, m=100, tol=1e-2)
    X, y = gaussian_mixture_multiclass(np.random.default_rng(2), 300,
                                       n_classes=3, d=6, spread=0.1)
    reg.register("svc", fit_ova(cfg, X, y, device="cpu"))
    Xr, yr = friedman1(np.random.default_rng(3), 300)
    reg.register("svr", fit(cfg, Xr, yr, task=EpsilonSVR(eps=0.2),
                            device="cpu"), with_bcm=False)
    Xo, _ = gaussian_with_outliers(np.random.default_rng(4), 300)
    cfg_o = DCSVMConfig(kernel=kern, C=1.0, k=2, levels=1, m=100, tol=1e-2,
                        early_stop_level=1)
    reg.register("ocsvm", fit(cfg_o, Xo, task=OneClassSVM(nu=0.2),
                              device="cpu"))

    for name, task, n_classes in (("svc", "svc", 3), ("svr", "svr", 0),
                                  ("ocsvm", "ocsvm", 1)):
        man = reg.resolve(name).manifest
        assert man.task == task and man.n_classes == n_classes
        rt = ModelManifest.from_json(man.to_json())
        assert rt == man
        assert rt.make_kernel() == kern
    assert reg.resolve("svr").manifest.eps == pytest.approx(0.2)
    assert reg.resolve("svr").manifest.strategies == ("exact", "early")
    oc = reg.resolve("ocsvm").manifest
    assert oc.nu == pytest.approx(0.2)
    assert len(oc.rho_c) == 2            # k = 2 per-cluster offsets
    j = reg.to_json()
    assert {m["name"] for m in j["models"]} == {"svc", "svr", "ocsvm"}


@pytest.mark.parametrize("kind,with_bcm", [("ova", True), ("ocsvm", True),
                                           ("ova", False)])
def test_manifest_matches_reference(reference, tmp_path, kind, with_bcm):
    """The port's manifest of a carried reference model equals the
    reference registry's, field for field (``created_unix`` aside), and
    ``save`` writes the same JSON."""
    jm, tm, _ = reference[kind]
    jreg, treg = JR.ModelRegistry(), ModelRegistry()
    jreg.register(kind, jm, with_bcm=with_bcm)
    treg.register(kind, tm, with_bcm=with_bcm)
    want = jreg.resolve(kind).manifest.to_json()
    got = treg.resolve(kind).manifest.to_json()
    assert set(got) == set(want)
    for field in want:
        if field != "created_unix":
            assert got[field] == want[field], field
    if kind == "ocsvm":
        assert len(got["rho_c"]) == CFG["k"] and got["nu"] == 0.2
    treg.save(str(tmp_path / "port.json"))
    jreg.save(str(tmp_path / "reference.json"))
    saved = [json.loads((tmp_path / f).read_text())
             for f in ("port.json", "reference.json")]
    for s in saved:
        for m in s["models"]:
            m.pop("created_unix")
    assert saved[0] == saved[1]


def test_registry_versioning_and_routing(registry2):
    assert registry2.versions("mix") == [1, 2]
    assert registry2.default_version("mix") == 1        # first stays default
    assert registry2.resolve("mix").version == 1
    assert registry2.resolve("mix", 2).version == 2
    with pytest.raises(KeyError):
        registry2.resolve("mix", 9)
    with pytest.raises(KeyError):
        registry2.resolve("nope")
    with pytest.raises(ValueError, match="default"):
        registry2.drop("mix", 1)                        # routed default
    with pytest.raises(ValueError, match="registered"):
        registry2.register("mix", object(), version=2)  # duplicate version


def test_registry_version_coercion(ova_models):
    """``register(version="2")`` coerces once at entry: "2" and 2 are one
    version, for the duplicate check and the insert alike."""
    m1, _, _ = ova_models
    reg = ModelRegistry()
    man = reg.register("m", m1, version="2")
    assert man.version == 2
    assert reg.versions("m") == [2]
    assert reg.resolve("m").version == 2
    assert reg.resolve("m", "2").version == 2
    with pytest.raises(ValueError, match="registered"):
        reg.register("m", m1, version=2)
    with pytest.raises(ValueError, match="registered"):
        reg.register("m", m1, version="2")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["early", "exact", "bcm"])
def test_async_bit_equal_to_merged_bucket(registry2, strategy):
    """Whatever the batch manager merges, each request's rows come back
    bit for bit a direct ``serve_batch`` of its merged bucket, and within
    float32 rounding of the request served alone (module docstring)."""
    Xpool = registry2.resolve("mix").sm.Xall.numpy()
    sizes = [1, 7, 33, 12, 64, 50, 3, 28]
    reqs = _mixed_batches(Xpool, sizes, seed=5)
    config = EngineConfig(max_batch=64)

    async def main():
        engine = AsyncServingEngine(registry2, config)
        engine.warmup("mix", strategies=[strategy])
        async with engine:
            return await asyncio.gather(*[
                engine.submit(r, "mix", strategy=strategy) for r in reqs])

    outs = asyncio.run(main())
    for (pred, scores), r in zip(outs, reqs):
        assert isinstance(scores, np.ndarray) and scores.shape == (len(r), 3)
    _merged_contract(registry2.resolve("mix"), strategy, reqs, outs, config)


def test_engine_matches_reference_engine(reference):
    """One burst through the port's engine and the reference's, on the
    same carried models (one-vs-all early and exact, one-class early with
    rho_c): the same predictions and scores within 2e-4 of 1 + |score|."""
    sizes = [1, 7, 33, 12, 64, 50, 3, 28]
    runs = []
    for kind, strategies in (("ova", ("early", "exact")),
                             ("ocsvm", ("early",))):
        jm, tm, Xte = reference[kind]
        reqs = _mixed_batches(Xte, sizes, seed=9)
        jreg, treg = JR.ModelRegistry(), ModelRegistry()
        jreg.register(kind, jm)
        treg.register(kind, tm)
        for strategy in strategies:
            runs.append((kind, strategy, reqs, jreg, treg))

    async def burst(engine_cls, config_cls, reg, kind, strategy, reqs):
        async with engine_cls(reg, config_cls(max_batch=64)) as engine:
            return await asyncio.gather(*[
                engine.submit(r, kind, strategy=strategy) for r in reqs])

    for kind, strategy, reqs, jreg, treg in runs:
        want = asyncio.run(burst(JE.AsyncServingEngine, JE.EngineConfig,
                                 jreg, kind, strategy, reqs))
        got = asyncio.run(burst(AsyncServingEngine, EngineConfig, treg,
                                kind, strategy, reqs))
        for (tp, ts), (jp, js) in zip(got, want):
            js = np.asarray(js, np.float64)
            err = np.abs(ts - js) / (1.0 + np.abs(js))
            assert err.max() <= PARITY_TOL, (kind, strategy, err.max())
            if kind == "ocsvm":
                clear = np.abs(js[:, 0]) > 1e-4
                np.testing.assert_array_equal(tp[clear],
                                              np.asarray(jp)[clear])
            else:
                np.testing.assert_array_equal(tp, np.asarray(jp))


def test_engine_zero_compiles_after_warmup_poisson(registry2):
    """Poisson arrivals, mixed sizes, both registered versions: no kernel
    library loaded after warmup, by the counter and the raw library
    count."""
    Xpool = registry2.resolve("mix").sm.Xall.numpy()
    rng = np.random.default_rng(7)
    n_req = 40
    sizes = rng.choice([1, 4, 16, 64], size=n_req, p=[0.35, 0.3, 0.25, 0.1])
    gaps = rng.exponential(1.0 / 2000.0, size=n_req)

    engine = AsyncServingEngine(registry2, EngineConfig(max_batch=64))
    engine.warmup("mix", strategies=["early"])
    cache_after_warmup = serving_cache_size()

    async def main():
        async with engine:
            async def one(i):
                await asyncio.sleep(float(np.sum(gaps[: i + 1])))
                X = Xpool[rng.integers(0, Xpool.shape[0], size=int(sizes[i]))]
                return await engine.submit(X, "mix", version=1 + i % 2,
                                           strategy="early")
            await asyncio.gather(*[one(i) for i in range(n_req)])

    asyncio.run(main())
    assert serving_cache_size() == cache_after_warmup
    st = engine.stats()
    assert st["compiles_after_warmup"] == 0
    assert st["requests"] == n_req and st["queries"] == int(sizes.sum())
    j = engine.metrics.to_json()
    assert any('version="1"' in k for k in j["histograms"])
    assert any('version="2"' in k for k in j["histograms"])
    assert any(k.startswith("serve_batch_fill_ratio")
               for k in j["histograms"])
    assert j["gauges"]["serve_queue_depth"] == 0


def test_hot_swap_under_inflight_requests(ova_models):
    """Swap repoints new submits atomically; requests already queued on the
    old version drain on it, then the old version is dropped."""
    m1, m2, Xpool = ova_models
    reg = ModelRegistry()
    reg.register("m", m1)
    reg.register("m", m2)
    sm1 = reg.resolve("m", 1).sm
    results = {}
    config = EngineConfig(max_batch=32)

    async def main():
        engine = AsyncServingEngine(reg, config)
        engine.warmup("m", strategies=["early"])
        async with engine:
            pre = [asyncio.ensure_future(
                engine.submit(Xpool[i * 8:(i + 1) * 8], "m",
                              strategy="early")) for i in range(4)]
            # let the submits run to their enqueue point, so they resolve
            # v1 (the route table as of now) before the swap lands
            await asyncio.sleep(0)
            old = await engine.swap("m", 2)
            assert old == 1
            post = await engine.submit(Xpool[:8], "m", strategy="early")
            results["pre"] = [await f for f in pre]
            results["post"] = post
        assert reg.versions("m") == [2]       # drained, then dropped
        assert reg.default_version("m") == 2

    asyncio.run(main())
    # pre-swap requests were served by v1 (the four merged into one
    # 32-row bucket), post-swap by v2
    pre = [Xpool[i * 8:(i + 1) * 8] for i in range(4)]
    _, merged = serve_batch(sm1, np.concatenate(pre), KERN, "early",
                            bucket=32)
    for i, (pred, scores) in enumerate(results["pre"]):
        np.testing.assert_array_equal(scores, merged[i * 8:(i + 1) * 8])
    _, ref2 = serve_batch(reg.resolve("m", 2).sm, Xpool[:8], KERN, "early",
                          bucket=bucket_size(8))
    np.testing.assert_array_equal(results["post"][1], ref2.numpy())
    assert not np.array_equal(results["post"][1],
                              serve_batch(sm1, Xpool[:8], KERN, "early",
                                          bucket=8)[1].numpy())


def test_engine_rejects_unserveable_strategy(ova_models):
    """A with_bcm=False export's manifest caps the strategy set; the engine
    refuses at submit instead of failing inside the batch loop."""
    m1, _, Xpool = ova_models
    reg = ModelRegistry()
    reg.register("m", m1, with_bcm=False)

    async def main():
        async with AsyncServingEngine(reg) as engine:
            with pytest.raises(ValueError, match="does not serve"):
                await engine.submit(Xpool[:4], "m", strategy="bcm")

    asyncio.run(main())


def test_engine_submit_requires_running_loop(registry2):
    engine = AsyncServingEngine(registry2)
    with pytest.raises(RuntimeError, match="not running"):
        asyncio.run(engine.submit(np.zeros((2, 8), np.float32), "mix"))
    engine.close()


def test_device_work_runs_on_the_engines_thread(registry2, monkeypatch):
    """Warmup and every batch run on the engine's one device thread, never
    on the event loop's; ``stop`` shuts that thread down, and a stopped
    engine takes no more work."""
    threads = []

    def recording(*a, **kw):
        threads.append(threading.current_thread().name)
        return serve_batch(*a, **kw)

    monkeypatch.setattr(engine_mod, "serve_batch", recording)
    Xpool = registry2.resolve("mix").sm.Xall.numpy()
    engine = AsyncServingEngine(registry2, EngineConfig(max_batch=64))
    engine.warmup("mix", strategies=["early"], buckets=[8])
    n_warm = len(threads)

    async def main():
        async with engine:
            await asyncio.gather(*[engine.submit(Xpool[i:i + 3], "mix")
                                   for i in range(5)])
        return threading.current_thread().name

    loop_thread = asyncio.run(main())
    assert n_warm == 2 and len(threads) == 3    # 2 versions; 1 batch
    assert len(set(threads)) == 1 and threads[0] != loop_thread
    assert threads[0].startswith("serve-device")
    with pytest.raises(RuntimeError, match="closed"):
        engine.warmup("mix", strategies=["early"], buckets=[8])
    with pytest.raises(RuntimeError, match="closed"):
        asyncio.run(engine.start())


def test_serve_failure_reaches_its_callers_only(registry2, monkeypatch):
    """A failure inside a batch's device work (a kernel that does not
    launch) goes to that batch's callers, as raised, with no retry; the
    loop lives on and serves the next batch."""
    Xpool = registry2.resolve("mix").sm.Xall.numpy()
    calls = []

    def failing_once(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("CUDA kernel kermat failed to launch")
        return serve_batch(*a, **kw)

    engine = AsyncServingEngine(registry2, EngineConfig(max_batch=64))
    engine.warmup("mix", strategies=["early"], buckets=[8])
    monkeypatch.setattr(engine_mod, "serve_batch", failing_once)

    async def main():
        async with engine:
            with pytest.raises(RuntimeError, match="failed to launch"):
                await engine.submit(Xpool[:4], "mix")
            pred, _ = await engine.submit(Xpool[:4], "mix")
            assert pred.shape == (4,)

    asyncio.run(main())
    assert len(calls) == 2
    assert engine.stats()["requests"] == 1


# ---------------------------------------------------------------------------
# overload robustness: shed / deadlines / liveness / supervision
# ---------------------------------------------------------------------------

class _GatedServe:
    """Wraps ``serve_batch`` behind a threading gate: the engine's device
    thread blocks in ``__call__`` until ``release`` is set, giving tests a
    window in which the loop is mid-batch while the event loop stays
    live."""

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()

    def __call__(self, *a, **kw):
        self.entered.set()
        assert self.release.wait(30), "gate never released"
        return serve_batch(*a, **kw)


async def _until_inflight(gate: _GatedServe) -> None:
    while not gate.entered.is_set():
        await asyncio.sleep(0.001)


def _hist_count(engine, name):
    return sum(h["count"] for k, h in
               engine.metrics.to_json()["histograms"].items()
               if k.startswith(name))


def test_engine_death_surfaces_in_stop_submit_drain(ova_models):
    """A poisoned registry entry kills the batch loop at batch formation;
    the death is supervised: queued futures fail, ``submit`` re-raises,
    and ``drain``/``stop`` surface the error in bounded time."""
    m1, _, Xpool = ova_models
    reg = ModelRegistry()
    reg.register("m", m1)

    async def main():
        engine = AsyncServingEngine(reg, EngineConfig(max_batch=32))
        engine.warmup("m", strategies=["early"])
        await engine.start()
        fut = asyncio.ensure_future(
            engine.submit(Xpool[:8], "m", strategy="early"))
        await asyncio.sleep(0)           # submit enqueued; loop not yet run
        reg._entries[("m", 1)] = None    # poison: formation resolve raises
        await asyncio.sleep(0.02)        # let the loop die on the poison
        with pytest.raises(KeyError, match="version"):
            await fut
        with pytest.raises(KeyError, match="version"):
            await engine.submit(Xpool[:4], "m", strategy="early")
        with pytest.raises(KeyError, match="version"):
            await asyncio.wait_for(engine.drain(), timeout=10)
        with pytest.raises(KeyError, match="version"):
            await asyncio.wait_for(engine.stop(), timeout=10)

    asyncio.run(main())


def test_cancelled_request_not_served_not_observed(ova_models, monkeypatch):
    """A caller-cancelled request is reaped before batch formation: its
    rows never reach the device and it never lands in the latency
    histogram."""
    m1, _, Xpool = ova_models
    reg = ModelRegistry()
    reg.register("m", m1)
    engine = AsyncServingEngine(reg, EngineConfig(max_batch=64))
    engine.warmup("m", strategies=["early"])
    gate = _GatedServe()
    monkeypatch.setattr(engine_mod, "serve_batch", gate)

    async def main():
        async with engine:
            fA = asyncio.ensure_future(
                engine.submit(Xpool[:8], "m", strategy="early"))
            await _until_inflight(gate)            # A popped, mid-batch
            fB = asyncio.ensure_future(
                engine.submit(Xpool[:5], "m", strategy="early"))
            await asyncio.sleep(0)                 # B enqueued
            fB.cancel()                            # the caller gave up
            await asyncio.sleep(0)
            gate.release.set()
            predA, _ = await fA
            assert predA.shape[0] == 8
            with pytest.raises(asyncio.CancelledError):
                await fB
            await engine.drain()                   # the loop reaps B

    asyncio.run(main())
    st = engine.stats()
    assert st["queries"] == 8 and st["requests"] == 1
    assert _hist_count(engine, "serve_latency_seconds") == 1
    assert _hist_count(engine, "serve_queue_wait_seconds") == 1
    assert st["queue_depth"] == 0


def test_shed_at_max_queue_rows(ova_models, monkeypatch):
    """Admission control: with the loop mid-batch, submits past
    ``max_queue_rows`` fail fast with ``EngineOverloaded`` and count into
    ``serve_shed_total``; admitted requests all deliver."""
    m1, _, Xpool = ova_models
    reg = ModelRegistry()
    reg.register("m", m1)
    engine = AsyncServingEngine(
        reg, EngineConfig(max_batch=64, max_queue_rows=32))
    engine.warmup("m", strategies=["early"])
    gate = _GatedServe()
    monkeypatch.setattr(engine_mod, "serve_batch", gate)

    async def main():
        async with engine:
            fA = asyncio.ensure_future(
                engine.submit(Xpool[:8], "m", strategy="early"))
            await _until_inflight(gate)            # loop blocked mid-batch
            subs = [asyncio.ensure_future(
                engine.submit(Xpool[i * 8:(i + 1) * 8], "m",
                              strategy="early")) for i in range(10)]
            await asyncio.sleep(0)                 # all ten hit admission
            shed = [t for t in subs if t.done()]
            assert len(shed) == 6                  # 32 rows admit four
            for t in shed:
                with pytest.raises(EngineOverloaded, match="queue full"):
                    await t
            gate.release.set()
            await fA
            for t in subs:
                if t not in shed:
                    pred, _ = await t
                    assert pred.shape[0] == 8

    asyncio.run(main())
    st = engine.stats()
    assert st["shed"] == 6
    assert st["requests"] == 5 and st["queries"] == 40   # A + 4 admitted


def test_deadline_expiry_while_queued(ova_models, monkeypatch):
    """A queued request whose deadline expires mid-batch (the event loop
    stays live during device compute) resolves with ``DeadlineExceeded``
    and is reaped before the next batch forms."""
    m1, _, Xpool = ova_models
    reg = ModelRegistry()
    reg.register("m", m1)
    engine = AsyncServingEngine(reg, EngineConfig(max_batch=64))
    engine.warmup("m", strategies=["early"])
    gate = _GatedServe()
    monkeypatch.setattr(engine_mod, "serve_batch", gate)

    async def main():
        async with engine:
            fA = asyncio.ensure_future(
                engine.submit(Xpool[:8], "m", strategy="early"))
            await _until_inflight(gate)
            fB = asyncio.ensure_future(
                engine.submit(Xpool[:5], "m", strategy="early",
                              timeout_s=0.005))
            # the timer fires while the device thread is still blocked
            await asyncio.sleep(0.04)
            assert fB.done()
            with pytest.raises(DeadlineExceeded, match="expired"):
                await fB
            gate.release.set()
            await fA
            await engine.drain()

    asyncio.run(main())
    st = engine.stats()
    assert st["deadline_exceeded"] == 1
    assert st["queries"] == 8 and st["requests"] == 1    # B never served
    assert _hist_count(engine, "serve_latency_seconds") == 1


def test_pre_expired_deadline_never_enqueues(registry2):
    """``timeout_s <= 0`` is already expired at submit: it resolves with
    ``DeadlineExceeded`` at once, without enqueueing."""
    engine = AsyncServingEngine(registry2, EngineConfig(max_batch=64))
    engine.warmup("mix", strategies=["early"])
    Xpool = registry2.resolve("mix").sm.Xall.numpy()

    async def main():
        async with engine:
            with pytest.raises(DeadlineExceeded):
                await engine.submit(Xpool[:4], "mix", strategy="early",
                                    timeout_s=0.0)

    asyncio.run(main())
    st = engine.stats()
    assert st["deadline_exceeded"] == 1
    assert st["queries"] == 0 and st["queue_depth"] == 0


def test_deadline_vs_hot_swap_drain(ova_models, monkeypatch):
    """A queued old-version request that expires during the drain is
    reaped, not served: the drain completes, the old version drops, and
    the caller sees ``DeadlineExceeded``."""
    m1, m2, Xpool = ova_models
    reg = ModelRegistry()
    reg.register("m", m1)
    reg.register("m", m2)
    engine = AsyncServingEngine(reg, EngineConfig(max_batch=32))
    engine.warmup("m", strategies=["early"])
    gate = _GatedServe()
    monkeypatch.setattr(engine_mod, "serve_batch", gate)

    async def main():
        async with engine:
            fA = asyncio.ensure_future(
                engine.submit(Xpool[:8], "m", strategy="early"))
            await _until_inflight(gate)
            fB = asyncio.ensure_future(
                engine.submit(Xpool[:5], "m", strategy="early",
                              timeout_s=0.005))
            await asyncio.sleep(0)                 # B queued on v1
            swap = asyncio.ensure_future(engine.swap("m", 2))
            await asyncio.sleep(0.04)              # B expires mid-drain
            gate.release.set()
            await fA                               # v1's in-flight batch
            assert await asyncio.wait_for(swap, timeout=10) == 1
            with pytest.raises(DeadlineExceeded):
                await fB
            post, _ = await engine.submit(Xpool[:4], "m", strategy="early")
            assert post.shape == (4,)

    asyncio.run(main())
    assert reg.versions("m") == [2]
    assert engine.stats()["deadline_exceeded"] == 1


def test_drain_bounded_wakeups(registry2):
    """``drain`` is event-driven (one wakeup per queue progression), not a
    busy wait: draining a long queue costs O(batches) wakeups."""
    class _CountingEvent(asyncio.Event):
        def __init__(self):
            super().__init__()
            self.waits = 0

        async def wait(self):
            self.waits += 1
            return await super().wait()

    Xpool = registry2.resolve("mix").sm.Xall.numpy()
    engine = AsyncServingEngine(registry2, EngineConfig(max_batch=64))
    engine.warmup("mix", strategies=["early"])
    counted = {}

    async def main():
        async with engine:
            ev = _CountingEvent()
            engine._served = ev
            subs = [asyncio.ensure_future(
                engine.submit(Xpool[i * 16:(i + 1) * 16], "mix",
                              strategy="early")) for i in range(12)]
            await asyncio.sleep(0)                 # all twelve enqueue
            await engine.drain()
            counted["waits"] = ev.waits
            for t in subs:
                await t

    asyncio.run(main())
    # 12 x 16 rows in 64-row batches: 3 batches, and a few wakeups more
    assert counted["waits"] <= 8, counted


def test_zero_compiles_after_warmup_under_overload(registry2):
    """An overload burst against a bounded queue with default deadlines
    sheds and expires some requests and delivers the rest, and the library
    count stays at its warmup mark throughout."""
    Xpool = registry2.resolve("mix").sm.Xall.numpy()
    engine = AsyncServingEngine(
        registry2, EngineConfig(max_batch=64, max_queue_rows=64,
                                timeout_s=0.25))
    engine.warmup("mix", strategies=["early"])
    mark = serving_cache_size()
    rng = np.random.default_rng(11)
    sizes = rng.choice([1, 4, 16, 64], size=60, p=[0.35, 0.3, 0.25, 0.1])

    async def main():
        async with engine:
            async def one(i):
                X = Xpool[rng.integers(0, Xpool.shape[0],
                                       size=int(sizes[i]))]
                return await engine.submit(X, "mix", version=1 + i % 2,
                                           strategy="early")
            return await asyncio.gather(
                *[one(i) for i in range(60)], return_exceptions=True)

    outs = asyncio.run(main())
    ok = [o for o in outs if not isinstance(o, BaseException)]
    bad = [o for o in outs if isinstance(o, BaseException)]
    assert all(isinstance(o, (EngineOverloaded, DeadlineExceeded))
               for o in bad), bad
    assert ok, "burst delivered nothing"
    assert bad, "the bounded queue shed nothing"
    assert serving_cache_size() == mark
    st = engine.stats()
    assert st["compiles_after_warmup"] == 0
    assert st["requests"] == len(ok)
    assert st["queue_depth"] == 0
