"""The distributed DC-SVM (``core/distributed.py``, ``launch/mesh.py``), port
vs reference, on the CPU in float64.

One rank: the port in a world of one against the reference on a
one-device Auto mesh, in this process.  P = 2 and P = 3: one subprocess
runs the reference on Auto meshes of the first 2 and 3 of 4 forced host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
``JAX_ENABLE_X64=1``) and writes its results to an ``.npz``; the port runs
the same cases in ``gloo`` worlds of 2 and 3 ranks spawned with
``torch.multiprocessing`` (``file://`` init).  The reference's subprocess
starts with the module and runs while the one-rank tests do.

The check: equal ``rounds``, alpha within 1e-8, the trace ring (``gamma``
included) within 1e-8; the bf16 policy at ``tests/test_torch_policy.py``'s
1e-5.  Every reference call runs its ``shard_map`` with ``check_vma=False``
(the installed JAX's varying-axes check refuses the reference's cached
conquer, whose ``lax.cond`` branches differ in that annotation alone; the
check is a debugging aid and changes no value).  ``fit_distributed``
replays the reference's key chain (``core/distributed.py:593``) into
``draws`` and ``sv_draws``.
"""
import json
import os
import subprocess
import sys
import textwrap
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (DCSVMConfig, EpsilonSVR, Kernel, OneClassSVM,
                              WeightedCSVC)
from repro_torch.core import distributed as TD
from repro_torch.core.predict import decision_exact
from repro_torch.core.solver import _top_block, combination_step_size
from repro_torch.core.tasks import resolve_task
from repro_torch.data import gaussian_mixture
from repro_torch.launch.mesh import make_conquer_mesh
from repro_torch.obs.trace import trace_fetch

N, D = 301, 6          # 301 is no multiple of 2 or 3: the shards are padded
KERN = dict(kind="rbf", gamma=0.5)
C = 2.0
TOL = 1e-8
BF_TOL = 1e-5          # tests/test_torch_policy.py
CQ = dict(C=C, tol=1e-4, max_iters=3000, block=16)
# P = 2, 3 take 931 and 716 rounds to tol (one rank 197): their loops are
# compared over their first 200
CQ_MULTI = dict(CQ, max_iters=200)
TRACE = 64
# (name, mode, cache_cap): the conquer's three loops
LOOPS = (("parallel", "parallel", 0), ("cached", "parallel", 64),
         ("replicated", "replicated", 0))
FIT = dict(C=C, k=4, m=64, tol=1e-4, max_iters=2000, seed=0)
FIT_ROUNDS = 100       # the fits' conquer rounds at most
# the multi-rank fits: (name, P, task, levels)
FITS = (("svc", 2, "svc", 1), ("weighted", 3, "weighted", 1),
        ("svr", 2, "svr", 1))
ROOT = Path(__file__).resolve().parents[1]
DIVIDE_ARGS = ("Xc", "sc", "pc", "cc", "ac", "mask")


def _svc_data():
    X, y = gaussian_mixture(np.random.default_rng(0), N, d=D,
                            modes_per_class=3)
    return X.astype(np.float64), y.astype(np.float64)


def _svr_data():
    rng = np.random.default_rng(1)
    X = rng.uniform(size=(N, D))
    return X, np.sin(3.0 * X[:, 0]) + 0.5 * X[:, 1]


def _task(name):
    return {"svc": None, "weighted": WeightedCSVC(w_pos=2.0, w_neg=0.5),
            "svr": EpsilonSVR(eps=0.1)}[name]


def _dual(task):
    """(X_dual, s, p, c) of a task on its data, from the port's build (the
    same numbers as the reference's)."""
    X, y = _svr_data() if task == "svr" else _svc_data()
    td = resolve_task(_task(task)).build(torch.from_numpy(X),
                                         torch.from_numpy(y)[None, :], C)
    return tuple(a.numpy() for a in (td.Xd, td.S[0], td.P[0], td.Cvec[0]))


def _clusters(k=6, nc=48, warm=True):
    """Divide-step inputs: k clusters of up to nc points, ragged masks,
    a warm start inside the box (or zero)."""
    rng = np.random.default_rng(2)
    X, y = _svc_data()
    Xc = X[:k * nc].reshape(k, nc, D)
    counts = nc - rng.integers(0, 9, size=k)
    mask = np.arange(nc)[None, :] < counts[:, None]
    a0 = np.where(mask & warm, rng.uniform(0.0, C, (k, nc)), 0.0)
    return dict(Xc=Xc, sc=y[:k * nc].reshape(k, nc),
                pc=np.full((k, nc), -1.0), cc=np.full((k, nc), C),
                ac=a0, mask=mask)


def _draw_tables(n, levels, seed=0, m=64, k=4, P=1):
    """The reference's per-level draws (``fit_distributed``'s key chain:
    ``key, sub, ksamp = split(key, 3)`` a level that runs, the k-means
    sample and init keys split from ``sub``; ``_sv_sample``'s uniforms
    from ``ksamp``), in the order the levels run."""
    import jax

    with jax.enable_x64(True):
        key = jax.random.PRNGKey(seed)
        out = []
        for l in range(levels, 0, -1):
            kl = max(k ** l, P)
            kl = -(-kl // P) * P
            if kl >= n // 2:
                continue
            key, sub, ksamp = jax.random.split(key, 3)
            key_sample, key_init = jax.random.split(sub)
            ms = min(m, n)
            out.append(dict(
                sample=np.asarray(jax.random.choice(key_sample, n, (ms,),
                                                    replace=False)),
                perm=np.asarray(jax.random.permutation(key_init, ms)),
                u=np.asarray(jax.random.uniform(ksamp, (n,)))))
    return out


def _replay(tables):
    """``draws`` and ``sv_draws`` replaying the reference's tables."""
    calls = {"draws": 0}

    def draws(level, n, m):
        t = tables[calls["draws"]]
        calls["draws"] += 1
        return t["sample"], t["perm"]

    def sv_draws(level, sv_mask, m):
        u = torch.tensor(tables[calls["draws"] - 1]["u"],
                         device=sv_mask.device)
        return _top_block(torch.where(sv_mask, 1.0 + u, u), m)

    return draws, sv_draws


def _ring(tr) -> dict:
    return tr if isinstance(tr, dict) else trace_fetch(tr)


def _same(want, got, tol=TOL, name=""):
    """Reference outputs (alpha, rounds, pg[, ring]) against the port's."""
    assert int(want[1]) == int(got[1]), (name, int(want[1]), int(got[1]))
    a, b = np.asarray(want[0], np.float64), np.asarray(got[0], np.float64)
    np.testing.assert_allclose(b, a, rtol=0, atol=tol * (1 + np.abs(a).max()),
                               err_msg=name)
    pw, pg = float(np.asarray(want[2])), float(np.asarray(got[2]))
    assert abs(pw - pg) <= tol * (1 + abs(pw)), (name, pw, pg)
    if len(want) > 3:
        rw, rg = _ring(want[3]), _ring(got[3])
        assert (rw["samples"], rw["dropped"]) == (rg["samples"],
                                                   rg["dropped"]), name
        assert sorted(k for k in rw if isinstance(rw[k], list)) == \
            sorted(k for k in rg if isinstance(rg[k], list)), name
        for k, v in rw.items():
            if isinstance(v, list):
                np.testing.assert_allclose(rg[k], v, rtol=tol, atol=tol,
                                           err_msg=f"{name} {k}")


# --------------------------------------------------------------------------
# the reference, on Auto meshes
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while the module's subprocesses run beside it: the
    problems are a few hundred rows, and idle pool threads would spin on
    the cores the subprocesses need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _vma_off(monkeypatch):
    import jax
    import repro.core.distributed as RD

    monkeypatch.setattr(RD, "shard_map",
                        partial(jax.shard_map, check_vma=False))


def _jmesh(P):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:P]), ("i",))


def _jconquer(P, mode, cache, task="svc", bf16=False, trace=TRACE,
              **over):
    import jax
    import jax.numpy as jnp
    from repro.core.distributed import ConquerConfig, conquer_step
    from repro.core.kernels import Kernel as JKernel

    X, s, p, c = _dual(task)
    cfg = ConquerConfig(kernel=JKernel(**KERN), mode=mode, cache_cap=cache,
                        use_pallas=False, trace_cap=trace,
                        compute_dtype="bfloat16" if bf16 else None,
                        **{**CQ, **over})
    with jax.enable_x64(True):
        out = conquer_step(_jmesh(P), "i", cfg, jnp.asarray(X),
                           jnp.asarray(s), jnp.zeros(len(s)),
                           p=jnp.asarray(p), c=jnp.asarray(c))
        return tuple(np.asarray(o) if not hasattr(o, "buf") else
                     _jring(o) for o in out)


def _jring(tr):
    from repro.obs.trace import trace_fetch as jfetch

    return jfetch(tr)


def _tconquer(mesh, mode, cache, task="svc", bf16=False, trace=TRACE,
              use_kernels=False, **over):
    X, s, p, c = _dual(task)
    cfg = TD.ConquerConfig(kernel=Kernel(**KERN), mode=mode, cache_cap=cache,
                           use_kernels=use_kernels, trace_cap=trace,
                           compute_dtype="bfloat16" if bf16 else None,
                           **{**CQ, **over})
    out = TD.conquer_step(mesh, "i", cfg, torch.from_numpy(X),
                          torch.from_numpy(s),
                          torch.zeros(len(s), dtype=torch.float64),
                          p=torch.from_numpy(p), c=torch.from_numpy(c))
    return tuple(o.numpy() if isinstance(o, torch.Tensor) else
                 trace_fetch(o) for o in out)


# --------------------------------------------------------------------------
# one rank against a one-device Auto mesh
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh1():
    return make_conquer_mesh("i", device="cpu")


ONE_RANK = [(loop, "svc") for loop in LOOPS] + [
    (LOOPS[0], "weighted"), (LOOPS[1], "svr")]


@pytest.mark.parametrize("loop,task", ONE_RANK,
                         ids=[f"{lp[0]}-{t}" for lp, t in ONE_RANK])
def test_conquer_one_rank_matches_reference(mesh1, loop, task):
    """Every loop, traced (the ring against the reference's) and untraced
    (bit for bit the traced run), for C-SVC, weighted C-SVC (vector c) and
    the SVR dual (vector p, 2n coordinates; 400 rounds, its cap, as tol
    1e-4 takes more than 3,000).  The weighted case is held at
    tol 1e-9: at 1e-4 it parts from the reference at round 135 of 174,
    where fewer than B coordinates still violate and the top-B block
    takes coordinates whose scores are rounding noise (a near-tie)."""
    name, mode, cache = loop
    over = {"weighted": dict(tol=1e-9, max_iters=20_000),
            "svr": dict(max_iters=400)}.get(task, {})
    want = _jconquer(1, mode, cache, task, **over)
    got = _tconquer(mesh1, mode, cache, task, **over)
    _same(want, got, name=f"{name} {task}")
    bare = _tconquer(mesh1, mode, cache, task, trace=0, **over)
    assert int(bare[1]) == int(got[1])
    assert np.array_equal(bare[0], got[0]) and bare[2] == got[2]
    ring = got[3]
    assert ring["samples"] + ring["dropped"] == int(got[1])
    if mode == "parallel":
        assert all(0.0 <= v <= 1.0 for v in ring["gamma"])
    else:
        assert "gamma" not in ring
    assert ("cache_hits" in ring) == (cache > 0)


def _objective(task, alpha):
    X, s, p, c = _dual(task)
    Xt = torch.from_numpy(X)
    Q = (s[:, None] * s[None, :]) * Kernel(**KERN).pairwise(Xt, Xt).numpy()
    a = np.asarray(alpha, np.float64)
    return 0.5 * a @ Q @ a + p @ a


@pytest.mark.parametrize("name,mode,cache", LOOPS, ids=[c[0] for c in LOOPS])
def test_conquer_kernel_route_f32(mesh1, name, mode, cache):
    """Through the kernel wrappers (their plain versions, the kernels'
    f32 arithmetic, on the CPU): the objective of the plain f32 run's
    alpha to 1e-4 relative, and converged as far."""
    X, s, p, c = (torch.from_numpy(a).float() for a in _dual("svc"))
    runs = []
    for use_kernels in (False, True):
        cfg = TD.ConquerConfig(kernel=Kernel(**KERN), mode=mode,
                               cache_cap=cache, use_kernels=use_kernels,
                               **CQ)
        runs.append(TD.conquer_step(mesh1, "i", cfg, X, s, torch.zeros(N),
                                    p=p, c=c))
    plain, kern = (_objective("svc", r[0].numpy()) for r in runs)
    assert abs(kern - plain) <= 1e-4 * abs(plain), (plain, kern)
    assert float(runs[1][2]) <= 2 * CQ["tol"]
    assert runs[1][0].dtype == torch.float32


@pytest.mark.parametrize("cache", [64], ids=["cached"])
def test_conquer_one_rank_bf16(mesh1, cache):
    """The bf16 policy (the cached rows stored in bf16), plain and through
    the kernel wrappers' plain versions: the reference's objective at the
    policy tests' 1e-5 relative, both converged.  The f32 sums of rounded
    operands run in another order, so the paths part near the end (288
    rounds against 287) as the policy's fits do."""
    want = _jconquer(1, "parallel", cache, bf16=True)
    fw = _objective("svc", want[0])
    for use_kernels in (False, True):
        got = _tconquer(mesh1, "parallel", cache, bf16=True,
                        use_kernels=use_kernels)
        fg = _objective("svc", got[0])
        assert abs(fg - fw) <= BF_TOL * abs(fw), (use_kernels, fw, fg)
        assert abs(int(got[1]) - int(want[1])) <= 0.05 * int(want[1])
        assert float(got[2]) <= CQ["tol"]


def test_conquer_cache_counters(mesh1):
    """The cache counts rows: hits + misses = rounds x P x B; and the
    cached loop gives the uncached one's rounds."""
    X, s, p, c = _dual("svc")
    counters = {}
    cfg = TD.ConquerConfig(kernel=Kernel(**KERN), cache_cap=64, **CQ)
    _, rounds, _ = TD.conquer_step(mesh1, "i", cfg, torch.from_numpy(X),
                                   torch.from_numpy(s), torch.zeros(N),
                                   counters=counters)
    hits, misses = int(counters["cache_hits"]), int(counters["cache_misses"])
    assert hits > 0 and hits + misses == int(rounds) * CQ["block"]


def test_sub_solve_is_freed_when_its_conquer_returns():
    """A round's sub-solve (on CUDA, its captured graph) holds no reference
    cycle, so it is freed when its conquer returns: left to the cyclic
    collector, a graph could be freed while a later conquer captures its
    own, and that ends the capture (seen on an H100 with two conquers in
    one process)."""
    import gc
    import weakref

    gc.disable()
    try:
        sub = TD._SubSolve(4, 2, torch.float64, torch.float64,
                           torch.device("cpu"))
        out = sub(torch.eye(4, dtype=torch.float64),
                  -torch.ones(4, dtype=torch.float64),
                  torch.zeros(4, dtype=torch.float64),
                  torch.ones(4, dtype=torch.float64))
        assert torch.equal(out, torch.ones(4, dtype=torch.float64))
        ref = weakref.ref(sub)
        del sub
        assert ref() is None
    finally:
        gc.enable()


def test_combination_step_size_matches_reference():
    """gamma* on random pairs, dQd <= 0 and both clip ends included."""
    import jax
    import jax.numpy as jnp
    from repro.core.solver import combination_step_size as jgamma

    rng = np.random.default_rng(3)
    gTd = np.concatenate([rng.normal(size=200), [-1.0, -8.0, -1.0, 2.0,
                                                 -3.0, 0.0]])
    dQd = np.concatenate([rng.normal(size=200), [4.0, 4.0, 0.0, 4.0,
                                                 -2.0, 0.0]])
    with jax.enable_x64(True):
        want = np.asarray(jgamma(jnp.asarray(gTd), jnp.asarray(dQd)))
    got = combination_step_size(torch.from_numpy(gTd),
                                torch.from_numpy(dQd)).numpy()
    assert np.array_equal(got, want)
    assert list(got[-6:]) == [0.25, 1.0, 1.0, 0.0, 1.0, 1.0]
    assert ((got >= 0) & (got <= 1)).all()


def _jdivide(P, block=0, budget=None, tol=1e-4):
    import jax
    import jax.numpy as jnp
    from repro.core.dcsvm import DCSVMConfig as JConfig
    from repro.core.distributed import divide_step
    from repro.core.kernels import Kernel as JKernel

    cl = _clusters()
    kw = {} if budget is None else dict(gram_budget=budget)
    cfg = JConfig(kernel=JKernel(**KERN), C=C, tol=tol, max_iters=20_000,
                  block=block, use_pallas=False, **kw)
    with jax.enable_x64(True):
        return np.asarray(divide_step(_jmesh(P), "i", cfg, *(
            jnp.asarray(cl[k]) for k in ("Xc", "sc", "pc", "cc", "ac",
                                         "mask"))))


def _tdivide(mesh, block=0, budget=None, tol=1e-4, warm=True,
             dtype=torch.float64, use_kernels=False):
    cl = _clusters(warm=warm)
    kw = {} if budget is None else dict(gram_budget=budget)
    cfg = DCSVMConfig(kernel=Kernel(**KERN), C=C, tol=tol, max_iters=20_000,
                      block=block, use_kernels=use_kernels, **kw)
    return TD.divide_step(mesh, "i", cfg, *(
        torch.from_numpy(cl[k]).to(dtype) for k in DIVIDE_ARGS[:-1]),
        torch.from_numpy(cl["mask"])).numpy()


@pytest.mark.parametrize("block", [0, 8], ids=["greedy", "block"])
def test_divide_one_rank_matches_reference(mesh1, block):
    """Greedy CD and block CD on the clusters' Grams, warm-started: the
    reference's alphas.  Block CD (B = 8 on clusters of 40-48 points) is
    held at tol 1e-9: at 1e-4 two clusters part from the reference where
    fewer than B coordinates violate (a near-tie of noise-level scores),
    both within tol.  The sequential sweep (a budget of one byte) is the
    batched solve bit for bit from a zero warm start; from a warm start
    the batched product of the initial gradient sums in another order
    for a batch of one (within 1e-12).  The kernel route (f32, the
    kernels' plain versions) within 1e-4 of the plain f32 solve."""
    tol = 1e-9 if block else 1e-4
    want = _jdivide(1, block, tol=tol)
    got = _tdivide(mesh1, block, tol=tol)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(_tdivide(mesh1, block, budget=1, tol=tol),
                               got, rtol=0, atol=1e-12)
    cold = _tdivide(mesh1, block, warm=False)
    assert np.array_equal(_tdivide(mesh1, block, budget=1, warm=False), cold)
    f32 = _tdivide(mesh1, block, dtype=torch.float32)
    kern = _tdivide(mesh1, block, dtype=torch.float32, use_kernels=True)
    assert kern.dtype == np.float32
    np.testing.assert_allclose(kern, f32, rtol=0, atol=1e-4)


def _jfit_model(task_name, levels):
    import jax
    import jax.numpy as jnp
    from repro.core.dcsvm import DCSVMConfig as JConfig
    from repro.core.distributed import fit_distributed_model
    from repro.core.kernels import Kernel as JKernel
    from repro.core.predict import decision_exact as jdecision
    from repro.core.tasks import EpsilonSVR as JSVR

    X, y = _svr_data() if task_name == "svr" else _svc_data()
    task = JSVR(eps=0.1) if task_name == "svr" else None
    cfg = JConfig(kernel=JKernel(**KERN), levels=levels, use_pallas=False,
                  **FIT)
    with jax.enable_x64(True):
        model = fit_distributed_model(cfg, _jmesh(1), "i", jnp.asarray(X),
                                      jnp.asarray(y), task=task,
                                      conquer_block=16,
                                      conquer_iters=FIT_ROUNDS)
        Xq = jnp.asarray(np.random.default_rng(4).uniform(-1, 1, (64, D)))
        return (np.asarray(model.alpha), np.asarray(model.beta),
                model.level_stats, np.asarray(jdecision(model, Xq)),
                np.asarray(Xq))


def test_fit_distributed_model_one_rank_matches_reference(mesh1):
    """epsilon-SVR (the mirrored pair expands the partition) at levels 2:
    the reference's alpha, beta, stats and decisions on test points."""
    a, beta, stats, dec, Xq = _jfit_model("svr", 2)
    X, y = _svr_data()
    cfg = DCSVMConfig(kernel=Kernel(**KERN), levels=2, use_kernels=False,
                      **FIT)
    model = TD.fit_distributed_model(
        cfg, mesh1, "i", X, y, task=EpsilonSVR(eps=0.1), conquer_block=16,
        conquer_iters=FIT_ROUNDS, dtype=torch.float64,
        **dict(zip(("draws", "sv_draws"), _replay(_draw_tables(N, 2)))))
    np.testing.assert_allclose(model.alpha.numpy(), a, rtol=0, atol=TOL)
    np.testing.assert_allclose(model.beta.numpy(), beta, rtol=0, atol=TOL)
    assert [{k: v for k, v in st.items() if k != "pg_max"} for st in
            model.level_stats] == [{k: v for k, v in st.items()
                                    if k != "pg_max"} for st in stats]
    np.testing.assert_allclose(
        decision_exact(model, torch.from_numpy(Xq)).numpy(), dec, rtol=0,
        atol=TOL)
    assert model.beta.shape == (N,) and model.alpha.shape == (2 * N,)
    for st in model.level_stats:
        assert all(isinstance(v, (int, float)) for v in st.values())


def test_fit_distributed_default_draws_and_errors(mesh1):
    """Without injected draws a generator seeded with cfg.seed draws them
    (two fits agree); equality tasks, an unknown mode and k % P != 0
    raise."""
    X, y = _svc_data()
    cfg = DCSVMConfig(kernel=Kernel(**KERN), levels=1, use_kernels=False,
                      **FIT)
    a1, st1 = TD.fit_distributed(cfg, mesh1, "i", X, y, conquer_block=16,
                                 dtype=torch.float64)
    a2, st2 = TD.fit_distributed(cfg, mesh1, "i", X, y, conquer_block=16,
                                 dtype=torch.float64)
    assert torch.equal(a1, a2) and st1 == st2
    acc = float((torch.sign(decision_exact(TD.fit_distributed_model(
        cfg, mesh1, "i", X, y, conquer_block=16, dtype=torch.float64),
        torch.from_numpy(X))) == torch.from_numpy(y)).double().mean())
    assert acc >= 0.9
    with pytest.raises(NotImplementedError, match="equality"):
        TD.fit_distributed(cfg, mesh1, "i", X, task=OneClassSVM(nu=0.5))
    with pytest.raises(ValueError, match="mode"):
        TD.conquer_step(mesh1, "i", TD.ConquerConfig(
            kernel=Kernel(**KERN), mode="gossip"), X, y, np.zeros(N))

    class Two:
        shape, rank, device = {"i": 2}, 0, torch.device("cpu")
    cl = _clusters(k=3)
    with pytest.raises(ValueError, match="multiple"):
        TD.divide_step(Two(), "i", cfg, *(torch.from_numpy(cl[k]) for k in (
            "Xc", "sc", "pc", "cc", "ac", "mask")))
    with pytest.raises(ValueError, match="backend"):
        make_conquer_mesh("i", device="cpu", backend="mpi")


# --------------------------------------------------------------------------
# P = 2 and P = 3: gloo worlds against 2- and 3-device Auto meshes
# --------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import functools, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    import repro.core.distributed as RD
    from repro.core.dcsvm import DCSVMConfig
    from repro.core.kernels import Kernel
    from repro.core.tasks import EpsilonSVR, WeightedCSVC
    from repro.obs.trace import trace_fetch

    RD.shard_map = functools.partial(jax.shard_map, check_vma=False)
    assert jax.device_count() == 4 and jax.config.jax_enable_x64
    spec = json.loads(sys.argv[1])
    part = sys.argv[2]
    inp = dict(np.load(spec["inputs"], allow_pickle=False))
    out, rings = {}, {}
    kern = Kernel(**spec["kern"])
    for P in (2, 3) if part == "loops" else ():
        mesh = Mesh(np.array(jax.devices()[:P]), ("i",))
        for name, mode, cache in spec["loops"]:
            cfg = RD.ConquerConfig(kernel=kern, mode=mode, cache_cap=cache,
                                   use_pallas=False,
                                   trace_cap=spec["trace"], **spec["cq"])
            a, r, pg, tr = RD.conquer_step(
                mesh, "i", cfg, jnp.asarray(inp["X"]), jnp.asarray(inp["s"]),
                jnp.zeros(len(inp["s"])), p=jnp.asarray(inp["p"]),
                c=jnp.asarray(inp["c"]))
            key = f"{name}{P}"
            out[key + "_alpha"], out[key + "_rounds"] = np.asarray(a), int(r)
            out[key + "_pg"] = float(pg)
            rings[key] = trace_fetch(tr)
        dcfg = DCSVMConfig(kernel=kern, C=spec["C"], tol=1e-4,
                           max_iters=2000, use_pallas=False)
        out[f"divide{P}"] = np.asarray(RD.divide_step(mesh, "i", dcfg, *(
            jnp.asarray(inp["div_" + k]) for k in
            ("Xc", "sc", "pc", "cc", "ac", "mask"))))
    for name, P, task, levels in spec["fits"] if part == "fits" else ():
        mesh = Mesh(np.array(jax.devices()[:P]), ("i",))
        t = {"svc": None, "weighted": WeightedCSVC(w_pos=2.0, w_neg=0.5),
             "svr": EpsilonSVR(eps=0.1)}[task]
        X, y = (inp["Xr"], inp["yr"]) if task == "svr" else (inp["Xs"],
                                                            inp["ys"])
        cfg = DCSVMConfig(kernel=kern, levels=levels, use_pallas=False,
                          **spec["fit"])
        a, stats = RD.fit_distributed(cfg, mesh, "i", jnp.asarray(X),
                                      jnp.asarray(y), task=t,
                                      conquer_block=16,
                                      conquer_iters=spec["fit_rounds"])
        out["fit_" + name] = np.asarray(a)
        rings["fit_" + name] = stats
    np.savez(spec["out"] + part + ".npz", **out)
    with open(spec["rings"] + part + ".json", "w") as f:
        json.dump(rings, f)
""")


def _inputs():
    X, s, p, c = _dual("svc")
    Xs, ys = _svc_data()
    Xr, yr = _svr_data()
    out = dict(X=X, s=s, p=p, c=c, Xs=Xs, ys=ys, Xr=Xr, yr=yr)
    out.update({"div_" + k: v for k, v in _clusters().items()})
    return out


@pytest.fixture(scope="module", autouse=True)
def reference_multi(tmp_path_factory):
    """Starts the reference's P = 2, 3 runs with the module, in two
    subprocesses (the loops and divide steps; the fits) that run while the
    one-rank tests do; returns a function that waits for them."""
    tmp = tmp_path_factory.mktemp("ref_multi")
    np.savez(tmp / "inputs.npz", **_inputs())
    spec = dict(inputs=str(tmp / "inputs.npz"), out=str(tmp / "out_"),
                rings=str(tmp / "rings_"), kern=KERN, loops=LOOPS,
                cq=CQ_MULTI, trace=TRACE, C=C, fit=FIT, fits=FITS,
                fit_rounds=FIT_ROUNDS)
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    procs = {part: subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, json.dumps(spec), part], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ("loops", "fits")}

    def wait():
        out, rings = {}, {}
        for part, proc in procs.items():
            o, e = proc.communicate(timeout=600)
            assert proc.returncode == 0, o + e
            out.update(np.load(spec["out"] + part + ".npz"))
            with open(spec["rings"] + part + ".json") as f:
                rings.update(json.load(f))
        return out, rings

    yield wait
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _world(rank, P, init_file, inputs, tables, out_dir):
    """One rank of a spawned gloo world: every case of ``P`` ranks; rank 0
    writes the results (and a bit-for-bit check of the sequential divide
    sweep)."""
    torch.set_num_threads(1)
    mesh = make_conquer_mesh("i", device="cpu", backend="gloo",
                             init_method=f"file://{init_file}",
                             world_size=P, rank=rank)
    inp = dict(np.load(inputs))
    res, rings = {}, {}
    for name, mode, cache in LOOPS:
        cfg = TD.ConquerConfig(kernel=Kernel(**KERN), mode=mode,
                               cache_cap=cache, use_kernels=False,
                               trace_cap=TRACE, **CQ_MULTI)
        a, r, pg, tr = TD.conquer_step(
            mesh, "i", cfg, torch.from_numpy(inp["X"]),
            torch.from_numpy(inp["s"]), torch.zeros(len(inp["s"]),
                                                    dtype=torch.float64),
            p=torch.from_numpy(inp["p"]), c=torch.from_numpy(inp["c"]))
        res[f"{name}_alpha"], res[f"{name}_rounds"] = a.numpy(), int(r)
        res[f"{name}_pg"] = float(pg)
        rings[name] = trace_fetch(tr)
    div = [torch.from_numpy(inp["div_" + k]) for k in
           ("Xc", "sc", "pc", "cc", "ac", "mask")]
    dcfg = DCSVMConfig(kernel=Kernel(**KERN), C=C, tol=1e-4, max_iters=2000,
                       use_kernels=False)
    res["divide"] = TD.divide_step(mesh, "i", dcfg, *div).numpy()
    res["divide_seq"] = TD.divide_step(mesh, "i", DCSVMConfig(
        kernel=Kernel(**KERN), C=C, tol=1e-4, max_iters=2000,
        use_kernels=False, gram_budget=1), *div).numpy()
    for name, fP, task, levels in FITS:
        if fP != P:
            continue
        X, y = (inp["Xr"], inp["yr"]) if task == "svr" else (inp["Xs"],
                                                            inp["ys"])
        cfg = DCSVMConfig(kernel=Kernel(**KERN), levels=levels,
                          use_kernels=False, **FIT)
        draws, sv_draws = _replay(tables[name])
        a, stats = TD.fit_distributed(cfg, mesh, "i", X, y,
                                      task=_task(task), conquer_block=16,
                                      conquer_iters=FIT_ROUNDS, draws=draws,
                                      sv_draws=sv_draws, dtype=torch.float64)
        res["fit_" + name] = a.numpy()
        rings["fit_" + name] = stats
    if rank == 0:
        np.savez(os.path.join(out_dir, f"port{P}.npz"), **res)
        with open(os.path.join(out_dir, f"port{P}.json"), "w") as f:
            json.dump(rings, f)
    mesh.close()


@pytest.fixture(scope="module", autouse=True)
def port_multi(tmp_path_factory):
    """Starts the port's gloo worlds of 2 and 3 ranks with the module, both
    at once; returns a function that waits for them."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("port_multi")
    np.savez(tmp / "inputs.npz", **_inputs())
    ctxs = []
    for P in (2, 3):
        tables = {name: _draw_tables(N, levels, P=fP)
                  for name, fP, task, levels in FITS if fP == P}
        ctxs.append(mp.spawn(_world, args=(P, str(tmp / f"init{P}"),
                                           str(tmp / "inputs.npz"), tables,
                                           str(tmp)),
                             nprocs=P, join=False))

    def wait(P):
        for ctx in ctxs:
            while not ctx.join(timeout=600):
                pass
        with open(tmp / f"port{P}.json") as f:
            return dict(np.load(tmp / f"port{P}.npz")), json.load(f)

    yield wait
    for ctx in ctxs:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.mark.parametrize("P", [2, 3])
def test_multi_rank_matches_reference(reference_multi, port_multi, P):
    """gloo worlds of P ranks against the reference on P-device Auto
    meshes: every conquer loop (traced; n = 301 pads every shard), the
    divide step (six clusters, two or three a rank, warm-started; the
    sequential sweep within 1e-12 of the batched one), and fit_distributed (C-SVC at levels 2
    on two ranks, weighted C-SVC on three with k rounded up to 6, SVR on
    two) with the reference's draws replayed."""
    ref, ref_rings = reference_multi()
    got, got_rings = port_multi(P)
    for name, _, _ in LOOPS:
        key = f"{name}{P}"
        _same((ref[key + "_alpha"], ref[key + "_rounds"], ref[key + "_pg"],
               ref_rings[key]),
              (got[name + "_alpha"], got[name + "_rounds"],
               got[name + "_pg"], got_rings[name]), name=key)
    np.testing.assert_allclose(got["divide"], ref[f"divide{P}"], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got["divide_seq"], got["divide"], rtol=0,
                               atol=1e-12)
    for name, fP, _, _ in FITS:
        if fP != P:
            continue
        np.testing.assert_allclose(got["fit_" + name], ref["fit_" + name],
                                   rtol=0, atol=TOL, err_msg=name)
        want = [{k: v for k, v in st.items() if k != "pg_max"}
                for st in ref_rings["fit_" + name]]
        assert [{k: v for k, v in st.items() if k != "pg_max"}
                for st in got_rings["fit_" + name]] == want, name


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def test_train_cli_distributed_world_of_one(tmp_path):
    """``train_svm --distributed`` in a world of one on the CPU: it runs,
    prints its level stats and writes --stats-json; nu-svc exits."""
    stats = tmp_path / "stats.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_svm",
         "--distributed", "--device", "cpu", "--n", "600", "--levels", "1",
         "--m", "64", "--dataset", "covtype_like", "--dist-cache", "128",
         "--stats-json", str(stats)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "'rounds'" in out.stdout and "test acc" in out.stdout
    levels = json.loads(stats.read_text())["levels"]
    assert levels[-1]["level"] == 0 and levels[-1]["rounds"] >= 1
    from repro_torch.launch import train_svm

    with pytest.raises(SystemExit, match="distributed"):
        train_svm.main(["--distributed", "--device", "cpu", "--task",
                        "nu-svc", "--n", "200"])
