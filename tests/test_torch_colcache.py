"""The column cache (``core.colcache``) and the cached level-0 block CD,
port vs reference.

The LRU bookkeeping is integer arithmetic, so it is held exactly: the same
random sequence of blocks (duplicate keys within a block included; SVR's
mirrored coordinates share a base id, and on the reference's CPU path the
last write of a duplicate key wins) through both ``update``s leaves the
whole state equal after every step, and a block larger than the cache is
refused by both.  The cached solver runs in float64 on both sides: equal
``iters``, hits, misses and evictions, alpha to 1e-8, for the plain dual
and the dedup view of the SVR dual; and ``fit(col_cache_cap=...)``
reports the reference's level-0 counters.  The kernel path's plain versions
compute in f32, as the kernels do, so it runs in float32 on both sides,
where ulps part the paths: hits + misses = B x iters, and alpha to 2e-4
(the float32 tolerance of ``tests/test_torch_tasks.py``).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import colcache as JC
from repro.core import dcsvm as JD
from repro.core import solver as JS
from repro.core import tasks as JT
from repro.core.kernels import Kernel as JKernel
from repro_torch.core import colcache as C
from repro_torch.core import dcsvm as D
from repro_torch.core import solver as S
from repro_torch.core import tasks as T
from repro_torch.core.kernels import Kernel
from repro_torch.data import gaussian_mixture, sinc1d

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_fit import jax_draws  # noqa: E402

FIELDS = C.ColumnCache._fields


def _equal(tc, jc, step):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)),
                                      err_msg=f"{f} after step {step}")


@pytest.mark.parametrize("cap,B,pool", [(12, 5, 20), (6, 6, 9), (16, 4, 10)],
                         ids=["evicting", "full-block", "warm"])
def test_update_sequence_matches_reference(cap, B, pool):
    rng = np.random.default_rng(cap * 100 + B)
    n, width = 24, 7
    tc = C.init(cap, n, width=width)
    jc = JC.init(cap, n, width=width)
    jupdate = jax.jit(JC.update)
    _equal(tc, jc, -1)
    for step in range(30):
        keys = rng.integers(0, pool, B)            # duplicates happen
        if step % 7 == 3:
            keys[1] = keys[0]                      # and always, sometimes
        rows = rng.normal(size=(B, width)).astype(np.float32)
        ts, th = C.lookup(tc, torch.from_numpy(keys))
        js, jh = JC.lookup(jc, jnp.asarray(keys))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        served = bool(np.all(np.asarray(jh)))
        tc = C.update(tc, torch.from_numpy(keys), torch.from_numpy(rows),
                      torch.tensor(served), ts, th)
        jc = jupdate(jc, jnp.asarray(keys, jnp.int32), jnp.asarray(rows),
                     jnp.asarray(served), js, jh)
        _equal(tc, jc, step)


def test_update_inactive_changes_nothing():
    tc = C.init(8, 20, width=3)
    keys = torch.tensor([1, 4, 4, 9])
    s, h = C.lookup(tc, keys)
    before = [t.clone() for t in tc]
    after = C.update(tc, keys, torch.ones(4, 3), torch.tensor(False), s, h,
                     active=torch.tensor(False))
    for f, a, b in zip(FIELDS, after, before):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f)


def test_block_larger_than_cache_refused_by_both():
    keys = np.arange(5)
    tc, jc = C.init(3, 10), JC.init(3, 10)
    ts, th = C.lookup(tc, torch.from_numpy(keys))
    with pytest.raises(ValueError):
        C.update(tc, torch.from_numpy(keys), torch.ones(5, 10),
                 torch.tensor(False), ts, th)
    js, jh = JC.lookup(jc, jnp.asarray(keys, jnp.int32))
    with pytest.raises(ValueError):
        JC.update(jc, jnp.asarray(keys, jnp.int32), jnp.ones((5, 10)),
                  jnp.asarray(False), js, jh)


COUNTERS = ("cache_hits", "cache_misses", "cache_evictions")


def _check(jr, tr, x64, block=16):
    if x64:
        assert int(tr.iters) == int(jr.iters)
        for f in COUNTERS:
            assert int(getattr(tr, f)) == int(getattr(jr, f)), f
    assert (int(tr.cache_hits) + int(tr.cache_misses)
            == block * int(tr.iters))
    np.testing.assert_allclose(tr.alpha.numpy(), np.asarray(jr.alpha),
                               rtol=0, atol=1e-8 if x64 else 2e-4)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("cap", [40, 96])
def test_cached_solve_matches_reference(cap, use_kernels):
    rng = np.random.default_rng(5)
    n = 200
    x64 = not use_kernels
    dt = np.float64 if x64 else np.float32
    X = rng.normal(size=(n, 5)).astype(dt)
    y = np.sign(rng.normal(size=n)).astype(dt)
    kw = dict(max_iters=400, block=16, cache_cap=cap, tol=1e-5)
    with jax.enable_x64(x64):
        jr = JS.solve_box_qp_matvec(jnp.asarray(X), jnp.asarray(y),
                                    JKernel("rbf", gamma=0.5), 1.0, **kw)
        tr = S.solve_box_qp_matvec(torch.tensor(X), torch.tensor(y),
                                   Kernel("rbf", gamma=0.5), 1.0,
                                   use_kernels=use_kernels, **kw)
        assert int(jr.cache_hits) > 0 and int(jr.cache_evictions) > 0
        _check(jr, tr, x64)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_cached_solve_dedup_svr_matches_reference(use_kernels):
    """SVR's 2n dual over the n base rows: a block's mirrored coordinates
    share a cache key (duplicate keys in one insert)."""
    X, y = sinc1d(np.random.default_rng(16), 120, noise=0.05)
    kw = dict(max_iters=400, block=16, cache_cap=48, tol=1e-5)
    x64 = not use_kernels
    jt_ = jnp.float64 if x64 else jnp.float32
    tt_ = torch.float64 if x64 else torch.float32
    with jax.enable_x64(x64):
        jt = JT.EpsilonSVR(eps=0.05).build(jnp.asarray(X, jt_),
                                           jnp.asarray(y, jt_)[None], 2.0)
        Xb, bidx = jt.base_view()
        jr = JS.solve_box_qp_matvec(jt.Xd, jt.S[0], JKernel("rbf", gamma=2.0),
                                    jt.Cvec[0], p=jt.P[0], Xbase=Xb,
                                    base_index=bidx, **kw)
        tt = T.EpsilonSVR(eps=0.05).build(torch.tensor(X, dtype=tt_),
                                          torch.tensor(y, dtype=tt_)[None],
                                          2.0)
        tXb, tbidx = tt.base_view()
        tr = S.solve_box_qp_matvec(tt.Xd, tt.S[0], Kernel("rbf", gamma=2.0),
                                   tt.Cvec[0], p=tt.P[0], Xbase=tXb,
                                   base_index=tbidx, use_kernels=use_kernels,
                                   **kw)
        assert int(jr.cache_hits) > 0
        _check(jr, tr, x64)


def test_fit_cache_counters_match_reference_x64():
    rng = np.random.default_rng(2)
    X, y = gaussian_mixture(rng, 240, d=6, modes_per_class=3, spread=0.2,
                            label_noise=0.02)
    cfg = dict(C=4.0, k=4, levels=1, m=100, tol=1e-5, max_iters=20000,
               seed=3, full_gram_threshold=64, col_cache_cap=96, block=16)
    with jax.enable_x64(True):
        jm = JD.fit(JD.DCSVMConfig(kernel=JKernel("rbf", gamma=4.0),
                                   use_pallas=False, **cfg),
                    jnp.asarray(X, jnp.float64), jnp.asarray(y, jnp.float64))
    tm = D.fit(D.DCSVMConfig(kernel=Kernel("rbf", gamma=4.0), **cfg), X, y,
               device="cpu", dtype=torch.float64,
               draws=jax_draws(cfg["seed"], cfg["m"]))
    js, ts = jm.level_stats[-1], tm.level_stats[-1]
    assert js["cache_hits"] > 0
    for f in ("iters", "cache_hits", "cache_misses", "cache_evictions",
              "cache_hit_rate"):
        assert ts[f] == js[f], f
    np.testing.assert_allclose(tm.alpha.numpy(), np.asarray(jm.alpha),
                               rtol=0, atol=1e-8)
