"""Port kernels vs the JAX reference on the same numpy inputs.

The reference runs its Pallas kernels in interpret mode (as
tests/test_kernels_pallas.py does); the port's wrappers run their plain
versions on the CPU.  Tolerances are the reference's own Pallas-vs-oracle
ones: kernel_matrix 2e-5, kernel_matvec 2e-4, cd_column_update 2e-4,
kmeans_assign 1e-4 on its scores.  The CUDA kernels themselves are compared with their plain versions by
tests/test_torch_cuda.py (and by chip_smoke.py) on a machine with a GPU.
"""
import numpy as np
import pytest
import torch

from repro.core import gramop as jgramop
from repro.core.kernels import Kernel as JKernel
from repro.core.kernels import gram as jgram
from repro.core.kernels import gram_matvec as jgram_matvec
from repro.kernels import ops as jops
from repro_torch.core import gramop
from repro_torch.core.kernels import Kernel, gram, gram_matvec
from repro_torch.kernels import ops, ref


KINDS = [dict(kind="rbf", gamma=4.0),
         dict(kind="poly", gamma=0.5, degree=3, coef0=1.0),
         dict(kind="linear")]
IDS = [k["kind"] for k in KINDS]


def _data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=s).astype(np.float32) for s in shapes]


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("kw", KINDS, ids=IDS)
@pytest.mark.parametrize("n,m,d", [(100, 300, 17), (130, 70, 54)])
def test_kernel_matrix_matches_reference(kw, n, m, d):
    X, Y = _data(n + m + d, (n, d), (m, d))
    want = np.asarray(jops.kernel_matrix(X, Y, JKernel(**kw), bm=64, bn=64))
    got = ops.kernel_matrix(*_t(X, Y), Kernel(**kw)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kw", KINDS, ids=IDS)
@pytest.mark.parametrize("n,m,d", [(100, 300, 17), (130, 70, 54)])
def test_kernel_matvec_matches_reference(kw, n, m, d):
    X, Z = _data(n + m, (n, d), (m, d))
    v = np.random.default_rng(d).standard_normal(m).astype(np.float32)
    want = np.asarray(jops.kernel_matvec(X, Z, v, JKernel(**kw), bm=64, bn=64))
    got = ops.kernel_matvec(*_t(X, Z, v), Kernel(**kw)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kw", KINDS, ids=IDS)
@pytest.mark.parametrize("n,B,d", [(100, 16, 7), (300, 64, 54)])
def test_cd_column_update_matches_reference(kw, n, B, d):
    rng = np.random.default_rng(n + B)
    (X,) = _data(n, (n, d))
    y = np.sign(rng.standard_normal(n)).astype(np.float32)
    Xb = X[:B].copy()
    w = rng.standard_normal(B).astype(np.float32)
    want = np.asarray(jops.cd_column_update(X, y, Xb, w, JKernel(**kw), bm=64))
    got = ops.cd_column_update(*_t(X, y, Xb, w), Kernel(**kw)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_batched_wrappers_match_per_item():
    X, Y = _data(3, (3, 40, 9), (3, 50, 9))
    v = np.random.default_rng(4).standard_normal((3, 50)).astype(np.float32)
    kern = Kernel("rbf", gamma=2.0)
    K = ops.kernel_matrix(*_t(X, Y), kern)
    kv = ops.kernel_matvec(*_t(X, Y, v), kern)
    for b in range(3):
        Xb, Yb, vb = _t(X[b], Y[b], v[b])
        torch.testing.assert_close(K[b], ops.kernel_matrix(Xb, Yb, kern),
                                   rtol=0, atol=0)
        torch.testing.assert_close(kv[b], ops.kernel_matvec(Xb, Yb, vb, kern),
                                   rtol=2e-6, atol=2e-6)


def test_core_gram_and_matvec_match_reference():
    X, Y = _data(5, (90, 12), (70, 12))
    v = np.random.default_rng(6).standard_normal(90).astype(np.float32)
    for kw in KINDS:
        jk, tk = JKernel(**kw), Kernel(**kw)
        np.testing.assert_allclose(gram(tk, *_t(X, Y)).numpy(),
                                   np.asarray(jgram(jk, X, Y)),
                                   rtol=2e-5, atol=2e-5)
        for use in (False, True):
            got = gram_matvec(tk, *_t(X, v), num_chunks=4, use_kernels=use)
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jgram_matvec(jk, X, v, num_chunks=4)),
                rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kw", KINDS, ids=IDS)
def test_q_rows_matches_reference(kw):
    rng = np.random.default_rng(11)
    X, Xb = _data(12, (150, 13), (20, 13))
    y = np.sign(rng.standard_normal(150)).astype(np.float32)
    yb = np.sign(rng.standard_normal(20)).astype(np.float32)
    want = np.asarray(jops.q_rows(X, y, Xb, yb, JKernel(**kw), bm=64, bn=64))
    got = ops.q_rows(*_t(X, y, Xb, yb), Kernel(**kw)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("kw", KINDS, ids=IDS)
def test_gram_operator_matches_reference(kw, use_kernels):
    rng = np.random.default_rng(13)
    (X,) = _data(14, (120, 9))
    s = np.sign(rng.standard_normal(120)).astype(np.float32)
    v = rng.standard_normal(120).astype(np.float32)
    idx = rng.choice(120, size=16, replace=False)
    delta = rng.standard_normal(16).astype(np.float32)
    jop = jgramop.GramOperator(Xd=X, s=s, kernel=JKernel(**kw),
                               use_pallas=use_kernels)
    top = gramop.GramOperator(Xd=torch.from_numpy(X), s=torch.from_numpy(s),
                              kernel=Kernel(**kw), use_kernels=use_kernels)
    tidx = torch.from_numpy(idx)
    for name, got, want, tol in (
            ("kernel_rows", top.kernel_rows(tidx), jop.kernel_rows(idx), 2e-5),
            ("q_block", top.q_block(tidx), jop.q_block(idx), 2e-5),
            ("qbb", top.qbb(tidx), jop.qbb(idx), 2e-5),
            ("matvec", top.matvec(torch.from_numpy(v), num_chunks=4),
             jop.matvec(v, num_chunks=4), 2e-4),
            ("col_update",
             top.col_update(torch.from_numpy(v), tidx, torch.from_numpy(delta)),
             jop.col_update(v, idx, delta), 2e-4)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("n_elems,budget,itemsize",
                         [(0, 0, 4), (256, 1024, 4), (257, 1024, 4),
                          (128, 1024, 8), (129, 1024, 8), (2 ** 31, 2 ** 33, 4)])
def test_fits_budget_matches_reference(n_elems, budget, itemsize):
    dtype = {4: np.float32, 8: np.float64}[itemsize]
    assert (gramop.fits_budget(n_elems, budget, itemsize=itemsize)
            == jgramop.fits_budget(n_elems, budget, dtype=dtype))


def test_wrappers_check_their_inputs():
    X, Y = _t(*_data(7, (8, 3), (5, 3)))
    kern = Kernel("rbf")
    with pytest.raises(ValueError):
        ops.kernel_matrix(X, Y[:, :2], kern)
    with pytest.raises(ValueError):
        ops.kernel_matvec(X, Y, torch.ones(4), kern)
    with pytest.raises(ValueError):
        ops.cd_column_update(X, torch.ones(8), Y, torch.ones(4), kern)
    with pytest.raises(ValueError):
        ops.kmeans_assign(X, Y, torch.ones(4, 2), torch.ones(2), 1.0)
    with pytest.raises(ValueError):
        ops.kernel_matrix(X, Y, kern, compute_dtype="no_such_dtype")
    with pytest.raises(ValueError):     # a packed operand means bf16
        ops.kernel_matrix(ops.pack_bf16(X), Y, kern)


def _assign_inputs(n, m, k, d, seed):
    """Points, a sample, one-hot-normalised centre weights and their
    self-terms (the shape of a k-means model), numpy float32."""
    X, = _data(seed, (n, d))
    rng = np.random.default_rng(seed + 1)
    Xm = X[rng.choice(n, m, replace=False)]
    H = np.eye(k, dtype=np.float32)[rng.integers(0, k, m)]
    W = (H / np.maximum(H.sum(0), 1.0)).astype(np.float32)
    Kmm = np.asarray(jops.kernel_matrix(Xm, Xm, JKernel("rbf", gamma=4.0)))
    s = np.einsum("mk,mn,nk->k", W, Kmm, W).astype(np.float32)
    return X, Xm, W, s


@pytest.mark.parametrize("n,m,k,d", [(256, 64, 4, 8), (300, 128, 16, 32),
                                     (64, 32, 3, 5), (130, 70, 20, 54)])
def test_kmeans_assign_matches_reference(n, m, k, d):
    """The port's wrapper (plain version on the CPU) and its ``ref`` against
    the reference's Pallas kernel in interpret mode: scores to the
    reference's 1e-4, the argmin equal."""
    X, Xm, W, s = _assign_inputs(n, m, k, d, n + k)
    ja, js = jops.kmeans_assign(X, Xm, W, s, gamma=4.0, bm=64)
    for a, sc in (ops.kmeans_assign(*_t(X, Xm, W, s), 4.0),
                  ref.kmeans_assign_ref(*_t(X, Xm, W, s), gamma=4.0)):
        assert a.dtype == torch.int64 and sc.shape == (n, k)
        np.testing.assert_allclose(sc.numpy(), np.asarray(js), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


@pytest.mark.parametrize("k,group,kp", [(1, 1, 8), (4, 1, 8), (16, 2, 16),
                                        (17, 4, 32), (100, 16, 128),
                                        (256, 16, 256), (300, 16, 384)])
def test_kmeans_assign_column_layout(k, group, kp):
    """k is padded to the kernel's column layout (8 x group columns a pass,
    group n8 blocks of mma.sync, at most 16), never to the TPU's 128
    lanes."""
    assert ops._assign_layout(k) == (group, kp)


def test_webspam_like_shape_sparsity_labels():
    """The port's webspam stand-in has the reference's structure: 254
    columns in [0, 1], about 70% of them zeroed, labels +-1 from 10 modes a
    class; and it matches the reference's generator in those statistics."""
    from repro.data.synthetic import webspam_like as jwebspam
    from repro_torch.data import webspam_like

    import jax

    X, y = webspam_like(np.random.default_rng(0), 4000)
    assert X.shape == (4000, 254) and X.dtype == np.float32
    assert y.shape == (4000,) and set(np.unique(y)) == {-1.0, 1.0}
    assert 0.0 <= X.min() and X.max() <= 1.0
    zero = float((X == 0).mean())
    jX, jy = jwebspam(jax.random.PRNGKey(0), 4000)
    jzero = float((np.asarray(jX) == 0).mean())
    assert 0.68 <= zero <= 0.74 and abs(zero - jzero) < 0.02
    assert 0.4 <= float((y > 0).mean()) <= 0.6


@pytest.mark.parametrize("B", [1, 2, 64, 256, 257, 512, 513, 1024])
def test_cd_column_update_chunks_cover_any_block(B):
    """C2: the wrapper launches the kernel on consecutive chunks of at most
    256 columns (the C entry's limit), near-equal, covering every column
    once; the chunks are a static function of B (a CUDA graph replays the
    same launches), and each chunk is a block the split plan takes."""
    chunks = ops.cd_chunks(B)
    assert chunks[0][0] == 0 and chunks[-1][1] == B
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(chunks, chunks[1:]))
    widths = [b - a for a, b in chunks]
    assert max(widths) <= ops.MAX_CD_BLOCK and max(widths) - min(widths) <= 1
    assert len(chunks) == -(-B // ops.MAX_CD_BLOCK)
    for w in widths:
        ops.split_tile_plan(54, w)
    with pytest.raises(ValueError, match="B <= 256"):
        ops.split_tile_plan(54, 257)


def test_cd_column_update_wide_block_matches_reference():
    """A 512-column block through the wrapper (its plain version on the
    CPU) against the reference's Pallas cd_column_update in interpret mode,
    which takes any column count, to its 2e-4."""
    rng = np.random.default_rng(11)
    X = rng.uniform(size=(300, 6)).astype(np.float32)
    y = np.where(rng.uniform(size=300) < 0.5, 1.0, -1.0).astype(np.float32)
    Xb = X[rng.choice(300, 512, replace=True)]
    w = rng.standard_normal(512).astype(np.float32)
    kern = Kernel("rbf", gamma=2.0)
    got = ops.cd_column_update(torch.from_numpy(X), torch.from_numpy(y),
                               torch.from_numpy(Xb), torch.from_numpy(w),
                               kern).numpy()
    want = np.asarray(jops.cd_column_update(X, y, Xb, w,
                                            JKernel("rbf", gamma=2.0)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
