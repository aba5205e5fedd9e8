"""Port two-step kernel k-means vs the JAX reference.

``jax.random`` draws cannot be reproduced in torch, so the reference's own
sample and init permutation are handed to the port: the assignment must
then be identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import kkmeans as JK
from repro.core.kernels import Kernel as JKernel
from repro_torch.core import kkmeans as K
from repro_torch.core.kernels import Kernel


def _points(seed, n=300, d=6):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(size=(6, d))
    X = centers[rng.integers(0, 6, n)] + 0.1 * rng.standard_normal((n, d))
    return X.astype(np.float32)


def _reference_draws(key, n, m):
    key_sample, key_init = jax.random.split(key)
    sample = np.asarray(jax.random.choice(key_sample, n, shape=(m,),
                                          replace=False))
    return sample, np.asarray(jax.random.permutation(key_init, m))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("k,balanced", [(4, True), (16, False)])
def test_two_step_kernel_kmeans_assign_identical(use_kernels, k, balanced):
    X = _points(k)
    key = jax.random.PRNGKey(k)
    ref = JK.two_step_kernel_kmeans(JKernel("rbf", gamma=4.0), X, k, key,
                                    m=80, iters=10, balanced=balanced,
                                    use_pallas=use_kernels)
    sample, perm = _reference_draws(key, X.shape[0], 80)
    got = K.two_step_kernel_kmeans(Kernel("rbf", gamma=4.0),
                                   torch.from_numpy(X), k, m=80, iters=10,
                                   sample_idx=sample, init_perm=perm,
                                   balanced=balanced, use_kernels=use_kernels)
    np.testing.assert_array_equal(got.assign, np.asarray(ref.assign))
    np.testing.assert_array_equal(got.idx, np.asarray(ref.idx))
    np.testing.assert_array_equal(got.mask, np.asarray(ref.mask))
    np.testing.assert_allclose(got.model.W.numpy(), np.asarray(ref.model.W),
                               atol=1e-6)
    np.testing.assert_allclose(got.model.s.numpy(), np.asarray(ref.model.s),
                               atol=1e-5)


def test_kernel_kmeans_reseeds_every_empty_cluster():
    """More clusters than the data supports: every empty cluster is
    reseeded at once, exactly as the reference does."""
    X = _points(1, n=40, d=3)
    Kmm = np.array(JKernel("rbf", gamma=1.0).pairwise(X, X))
    key = jax.random.PRNGKey(3)
    perm = np.array(jax.random.permutation(key, 40))
    want = [np.asarray(a) for a in JK.kernel_kmeans(Kmm, 12, key, iters=6)]
    got = [a.numpy() for a in K.kernel_kmeans(torch.from_numpy(Kmm), 12,
                                              torch.from_numpy(perm), iters=6)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)


def test_assign_points_masks_empty_centers():
    X = _points(2, n=50, d=3)
    W = np.zeros((10, 3), np.float32)
    W[:5, 0] = 0.2
    W[5:, 2] = 0.2                      # center 1 is empty
    Xm = X[:10]
    s = np.ones(3, np.float32) * 0.5
    ja, jd = JK.assign_points(JKernel("rbf", gamma=2.0),
                              JK.KKMeansModel(Xm, W, s), X)
    ta, td = K.assign_points(Kernel("rbf", gamma=2.0),
                             K.KKMeansModel(*map(torch.from_numpy, (Xm, W, s))),
                             torch.from_numpy(X))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert np.isinf(td.numpy()[:, 1]).all()
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)


@pytest.mark.parametrize("n,k", [(97, 4), (200, 16), (30, 1)])
def test_balanced_assign_identical(n, k):
    D = np.random.default_rng(n).uniform(size=(n, k))
    cap = -(-n // k)
    np.testing.assert_array_equal(K.balanced_assign(D, cap),
                                  JK.balanced_assign(D, cap))


def test_partition_gather_scatter_match_reference():
    assign = np.random.default_rng(0).integers(0, 5, 43).astype(np.int32)
    jp = JK.Partition.build(assign, 5, None)
    tp = K.Partition.build(assign, 5, None)
    np.testing.assert_array_equal(tp.idx, jp.idx)
    A = np.arange(43 * 2, dtype=np.float32).reshape(43, 2)
    g = tp.gather(torch.from_numpy(A))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jp.gather(A)))
    np.testing.assert_array_equal(tp.scatter(g, 43).numpy(), A)


def test_assign_points_masks_empty_centers_fused_route():
    """The fused ``kmeans_assign`` route (``use_kernels=True``, RBF) keeps
    the +inf of an empty centre inside the kernel's own argmin: the
    centre's finite self-term would otherwise score it s_c and capture
    points.  Same assignment and distances as the reference's gram route."""
    X = _points(2, n=50, d=3)
    W = np.zeros((10, 3), np.float32)
    W[:5, 0] = 0.2
    W[5:, 2] = 0.2                      # center 1 is empty
    Xm = X[:10]
    s = np.array([0.5, -5.0, 0.5], np.float32)   # the empty one scores lowest
    ja, jd = JK.assign_points(JKernel("rbf", gamma=2.0),
                              JK.KKMeansModel(Xm, W, s), X, use_pallas=True)
    ta, td = K.assign_points(Kernel("rbf", gamma=2.0),
                             K.KKMeansModel(*map(torch.from_numpy, (Xm, W, s))),
                             torch.from_numpy(X), use_kernels=True)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert not (ta.numpy() == 1).any()
    assert np.isinf(td.numpy()[:, 1]).all()
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_array_equal(
        K.route(Kernel("rbf", gamma=2.0),
                K.KKMeansModel(*map(torch.from_numpy, (Xm, W, s))),
                torch.from_numpy(X)).numpy(),
        np.asarray(JK.route(JKernel("rbf", gamma=2.0),
                            JK.KKMeansModel(Xm, W, s), X)))


def test_assign_points_fused_route_counts_one_launch(monkeypatch):
    """With ``use_kernels`` and RBF the assignment goes through
    ``ops.kmeans_assign`` (and not ``kermat``); other kernel kinds keep the
    gram route."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.kmeans_assign
    monkeypatch.setattr(ops, "kmeans_assign",
                        lambda *a: calls.append(1) or real(*a))
    X = torch.from_numpy(_points(4, n=40, d=3))
    model = K.KKMeansModel(X[:8], torch.full((8, 2), 0.125),
                           torch.zeros(2))
    K.assign_points(Kernel("rbf", gamma=1.0), model, X, use_kernels=True)
    K.assign_points(Kernel("poly", gamma=1.0), model, X, use_kernels=True)
    K.assign_points(Kernel("rbf", gamma=1.0), model, X, use_kernels=False)
    assert calls == [1]
