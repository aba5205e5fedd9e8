"""The split-TF32 arithmetic of the SVM CUDA kernels (cd_column_update,
kernel_matvec, kermat, kmeans_assign), emulated on the CPU and held to the
JAX reference.

The kernels form x.z on the tensor cores as lo_x.hi_z + hi_x.lo_z +
hi_x.hi_z with x = hi + lo both rounded to TF32 (cvt.rna.tf32.f32), after
shifting both operands by the mean of the kept operand's rows (rbf).
``kernels.ref`` emulates that arithmetic (``*_tf32_emul``); here it is held
to the reference's kernels (interpret mode, as tests/test_kernels_pallas.py
runs them) and plain versions at the reference's 2e-4 in the form
|err| <= 2e-4 (1 + |ref|), at the kinds x widths of the CUDA tests and on
covtype-like rows (d = 54, gamma = 1).  1xTF32 (hi_x.hi_z alone) is the
control that must miss that tolerance on the covtype rows.  kermat is held
to its reference's 2e-5 and kmeans_assign to 1e-4 on its scores (both of
its products split: 1xTF32 on either misses), and the emulations that sum
over depth slices as the streamed forms do at webspam's d = 254 to 2e-4.
``ops.split_tile_plan``, which picks a kernel's form, is checked over
every d up to the reference's 3072.  The level-0 block CD's CUDA-graph
switch and the launch bookkeeping around a capture are checked where they
run on the CPU.
"""
import numpy as np
import pytest
import torch

from repro.core.kernels import Kernel as JKernel
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import gramop
from repro_torch.core import solver as S
from repro_torch.core.kernels import Kernel
from repro_torch.core.kkmeans import kernel_kmeans
from repro_torch.data import covtype_like, webspam_like
from repro_torch.kernels import ops, ref

TOL = 2e-4
KINDS = [dict(kind="rbf", gamma=4.0),
         dict(kind="poly", gamma=0.5, degree=3, coef0=1.0),
         dict(kind="linear")]
# the (kernel, d) cases of tests/test_torch_cuda.py (poly at d <= 17)
CASES = [(KINDS[0], 17), (KINDS[0], 54), (KINDS[1], 17), (KINDS[2], 17),
         (KINDS[2], 54)]
CASE_IDS = [f"{kw['kind']}-d{d}" for kw, d in CASES]


def _share(got, want) -> float:
    """Worst |got - want| / (TOL (1 + |want|)): at most 1 within tolerance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (TOL * (1.0 + np.abs(want)))).max())


def _uniform(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=s).astype(np.float32) for s in shapes]


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def test_tf32_rna_rounds_to_nearest_ties_away():
    """tf32_rna keeps 10 mantissa bits, rounds to nearest with ties away
    from zero, and hi + lo carries x to about 2^-22 of |x|."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(10_000).astype(np.float32) * 10.0 ** rng.integers(
        -3, 4, 10_000)
    t = torch.from_numpy(x)
    hi = ref.tf32_rna(t)
    bits = hi.view(torch.int32)
    assert int((bits & 0x1FFF).abs().sum()) == 0
    # within half a TF32 ulp (2^-11 of the binade)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(x))) - 10)
    assert (np.abs(hi.numpy().astype(np.float64) - x) <= ulp / 2).all()
    # exact ties go away from zero
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 3 * 2.0 ** -11], dtype=torch.float32)
    assert ref.tf32_rna(tie).tolist() == [1.0 + 2.0 ** -10,
                                          -(1.0 + 2.0 ** -10),
                                          1.0 + 2.0 ** -9]
    h, lo = ref.split_tf32(t)
    err = np.abs((h.double() + lo.double()).numpy() - x)
    assert (err <= 2.0 ** -21 * np.abs(x)).all()


@pytest.mark.parametrize("kw,d", CASES, ids=CASE_IDS)
def test_split_cd_column_update_matches_reference(kw, d):
    """The emulated kernel arithmetic of cd_column_update against the
    reference's Pallas kernel (interpret mode) at a ragged shape."""
    rng = np.random.default_rng(d)
    X, Xb = _uniform(d, (300, d), (65, d))
    y = np.sign(rng.standard_normal(300)).astype(np.float32)
    w = rng.standard_normal(65).astype(np.float32)
    want = np.asarray(jops.cd_column_update(X, y, Xb, w, JKernel(**kw), bm=64))
    got = ref.cd_column_update_tf32_emul(*_t(X, y, Xb, w), **kw).numpy()
    assert _share(got, want) <= 1.0


@pytest.mark.parametrize("kw,d", CASES, ids=CASE_IDS)
def test_split_kernel_matvec_matches_reference(kw, d):
    """The emulated kernel arithmetic of kernel_matvec against the
    reference's Pallas kernel (interpret mode) at a ragged shape."""
    X, Z = _uniform(d + 1, (130, d), (301, d))
    v = np.random.default_rng(d).standard_normal(301).astype(np.float32)
    want = np.asarray(jops.kernel_matvec(X, Z, v, JKernel(**kw), bm=64,
                                         bn=64))
    got = ref.kernel_matvec_tf32_emul(*_t(X, Z, v), **kw).numpy()
    assert _share(got, want) <= 1.0


@pytest.fixture(scope="module")
def covtype_rows():
    X, _ = covtype_like(np.random.default_rng(0), 4064)
    return X


def _covtype_cases(X):
    """(name, emulation(passes), reference) on covtype rows, gamma = 1:
    cd_column_update (2000 x 64) and kernel_matvec (500 x 2000)."""
    rng = np.random.default_rng(1)
    rkw = dict(kind="rbf", gamma=1.0)
    Xc, Xb = X[:2000], X[2000:2064]
    y = np.sign(rng.standard_normal(2000)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    Xq, Z = X[2064:2564], X[2064:4064]
    v = rng.standard_normal(2000).astype(np.float32)
    return [
        ("cd_column_update",
         lambda p: ref.cd_column_update_tf32_emul(*_t(Xc, y, Xb, w),
                                                  passes=p, **rkw),
         jref.cd_column_update_ref(Xc, y, Xb, w, **rkw)),
        ("kernel_matvec",
         lambda p: ref.kernel_matvec_tf32_emul(*_t(Xq, Z, v), passes=p, **rkw),
         jref.kernel_matvec_ref(Xq, Z, v, **rkw)),
    ]


@pytest.mark.parametrize("which", [0, 1], ids=["cd_column_update",
                                               "kernel_matvec"])
def test_split_tf32_on_covtype_rows_within_tolerance(covtype_rows, which):
    """Split-TF32 on covtype rows (d = 54, norms 11-26, gamma = 1) is within
    the reference's 2e-4 of its plain f32 version; so is the port's shifted
    plain version that the CUDA tests hold the kernels to."""
    name, emul, want = _covtype_cases(covtype_rows)[which]
    assert _share(emul(3).numpy(), want) <= 1.0, name


@pytest.mark.parametrize("which", [0, 1], ids=["cd_column_update",
                                               "kernel_matvec"])
def test_one_pass_tf32_control_misses_tolerance(covtype_rows, which):
    """The control: 1xTF32 (hi.hi alone, what a plain TF32 product gives) on
    the same covtype rows misses 2e-4, so the split is what the tolerance
    needs."""
    name, emul, want = _covtype_cases(covtype_rows)[which]
    assert _share(emul(1).numpy(), want) > 1.0, name


def _share_of(got, want, tol) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (tol * (1.0 + np.abs(want)))).max())


@pytest.mark.parametrize("passes", [3, 1], ids=["split", "control-1xTF32"])
def test_split_kermat_on_covtype_rows(covtype_rows, passes):
    """kermat in split-TF32 (both operands shifted by the mean of Y's rows)
    on 1,024 covtype rows against the reference's plain version, within its
    2e-5 (``test_kernels_pallas.py``'s rtol = atol = 2e-5); 1xTF32 is the
    control that misses it."""
    X = covtype_rows[:1024]
    want = jref.kermat_ref(X, X, kind="rbf", gamma=1.0)
    got = ref.kermat_tf32_emul(*_t(X, X), kind="rbf", gamma=1.0,
                               passes=passes)
    share = _share_of(got.numpy(), want, 2e-5)
    assert (share <= 1.0) if passes == 3 else (share > 1.0)


def _assign_case(X, k):
    """A k-means model on 1,000 covtype samples (kernel k-means, gamma = 1,
    empty centres at s = +inf) and 2,000 points to assign."""
    Xm, Xa = X[:1000], X[1000:3000]
    Kmm = ref.kermat_ref(*_t(Xm, Xm), gamma=1.0)
    _, W, s = kernel_kmeans(Kmm, k, torch.from_numpy(
        np.random.default_rng(k).permutation(1000)))
    s = torch.where(W.sum(0) <= 0, torch.inf, s)
    return Xa, Xm, W.numpy(), s.numpy()


@pytest.mark.parametrize("k", [256, 4])
def test_split_kmeans_assign_on_covtype_rows(covtype_rows, k):
    """kmeans_assign with both products in split-TF32 on covtype rows at the
    level shape's k = 256 and the routing k = 4, against the reference's
    plain version: scores within its 1e-4, argmins equal wherever the two
    best scores are 2e-4 apart or more."""
    Xa, Xm, W, s = _assign_case(covtype_rows, k)
    want_a, want_s = jref.kmeans_assign_ref(Xa, Xm, W, s[None, :], gamma=1.0)
    want_a, want_s = np.asarray(want_a), np.asarray(want_s)
    got_a, got_s = ref.kmeans_assign_tf32_emul(*_t(Xa, Xm, W, s), gamma=1.0)
    finite = np.isfinite(want_s)
    assert (np.isfinite(got_s.numpy()) == finite).all()
    assert np.abs(got_s.numpy()[finite] - want_s[finite]).max() <= 1e-4
    top2 = np.sort(np.where(finite, want_s, np.inf), axis=1)[:, :2]
    clear = top2[:, 1] - top2[:, 0] >= 2e-4
    assert (got_a.numpy()[clear] == want_a[clear]).all()


@pytest.mark.parametrize("k,which", [(256, "passes"), (4, "gram_passes")],
                         ids=["k256-KW-1xTF32", "k4-gram-1xTF32"])
def test_kmeans_assign_one_pass_control_misses(covtype_rows, k, which):
    """The controls: 1xTF32 on K W misses 1e-4 at k = 256 (K near 1 is
    summed over a cluster's samples), and 1xTF32 on the Gram misses it at
    k = 4, so the kernel splits both products."""
    Xa, Xm, W, s = _assign_case(covtype_rows, k)
    want_s = np.asarray(jref.kmeans_assign_ref(Xa, Xm, W, s[None, :],
                                               gamma=1.0)[1])
    got_s = ref.kmeans_assign_tf32_emul(*_t(Xa, Xm, W, s), gamma=1.0,
                                        **{which: 1})[1].numpy()
    finite = np.isfinite(want_s)
    assert np.abs(got_s[finite] - want_s[finite]).max() > 1e-4


@pytest.fixture(scope="module")
def webspam_rows():
    X, _ = webspam_like(np.random.default_rng(2), 2600)
    return X


@pytest.mark.parametrize("which", ["cd_column_update", "kernel_matvec"])
def test_split_slices_at_webspam_width_within_tolerance(webspam_rows, which):
    """The streamed forms' arithmetic at webspam's d = 254 (summed over
    depth slices of 64 columns in order, gamma 0.5 as the reference's
    benchmarks use) against the reference's plain version within 2e-4.
    The kept rows are among the others, as in a fit (at gamma 0.5 the
    kernel between two webspam rows is mostly below 1e-6)."""
    rng = np.random.default_rng(3)
    rkw = dict(kind="rbf", gamma=0.5)
    X = webspam_rows
    if which == "cd_column_update":
        Xc, Xb = X[:2000], X[:256]
        y = np.sign(rng.standard_normal(2000)).astype(np.float32)
        w = rng.standard_normal(256).astype(np.float32)
        want = jref.cd_column_update_ref(Xc, y, Xb, w, **rkw)
        got = ref.cd_column_update_tf32_emul(*_t(Xc, y, Xb, w),
                                             slab=ops.SPLIT_SLICE, **rkw)
    else:
        Xq, Z = X[:500], X[:2000]
        v = rng.standard_normal(2000).astype(np.float32)
        want = jref.kernel_matvec_ref(Xq, Z, v, **rkw)
        got = ref.kernel_matvec_tf32_emul(*_t(Xq, Z, v),
                                          slab=ops.SPLIT_SLICE, **rkw)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    assert _share(got.numpy(), want) <= 1.0


@pytest.mark.parametrize("B", [None, 1, 2, 63, 64, 65, 128, 129, 200, 255,
                               256], ids=lambda b: f"B{b}")
def test_split_tile_plan_takes_every_width(B):
    """``split_tile_plan`` gives a form for every d from 1 to 3072: the
    resident one (the whole padded row, a ring of 1-3 stages whose shared
    memory fits) where it fits, else the streamed one (64-column slices).
    The resident form keeps its widths: kernel_matvec d <= 128,
    cd_column_update d <= 149 at B <= 64 and d <= 72 at B = 256."""
    widest = 0
    for d in range(1, 3073):
        plan = ops.split_tile_plan(d, B)
        if plan.stages:
            if B is None:
                assert plan.stages == 1 and ops._mv_smem(d) <= ops._SMEM_BLOCK
            else:
                assert plan.stages in (2, 3)
                assert ops._cd_smem(-(-B // 64), d, plan.stages) <= \
                    ops._SMEM_BLOCK
            widest = d
        else:
            assert plan == ops.SplitPlan(0)
    if B is None or B <= 64 or B == 256:
        assert widest == (128 if B is None else 149 if B <= 64 else 72)


@pytest.mark.parametrize("d,B", [(0, None), (0, 64), (54, 0), (54, 257),
                                 (-1, 1)])
def test_split_tile_plan_refuses(d, B):
    with pytest.raises(ValueError):
        ops.split_tile_plan(d, B)


@pytest.mark.parametrize("kw", KINDS, ids=[k["kind"] for k in KINDS])
def test_shifted_plain_versions_match_reference(kw):
    """The plain versions shift both operands by the mean of the kept
    operand's rows for rbf (K depends on x - z alone; ``split_shift``)
    and take no shift otherwise; either way they compute the reference's function."""
    X, Z = _uniform(7, (90, 54), (120, 54))
    v = np.random.default_rng(8).standard_normal(120).astype(np.float32)
    shift = ops.split_shift(torch.from_numpy(Z), Kernel(**kw))
    if kw["kind"] == "rbf":
        np.testing.assert_allclose(shift.numpy(), Z.mean(0), rtol=1e-6,
                                   atol=1e-7)
    else:
        assert shift is None
    got = ref.kernel_matvec_ref(*_t(X, Z, v), **kw).numpy()
    want = np.asarray(jref.kernel_matvec_ref(X, Z, v, **kw))
    assert _share(got, want) <= 1.0


def test_recording_moves_captured_launches_to_replays():
    """``ops.recording`` takes the launches made inside it out of
    ``LAUNCHES`` and reports them; ``add_launches`` counts replays."""
    before = dict(ops.LAUNCHES)
    with ops.recording() as captured:
        ops.LAUNCHES["cd_column_update"] += 1
        ops.LAUNCHES["kernel_matvec"] += 2
    assert ops.LAUNCHES == before
    assert captured["cd_column_update"] == 1
    assert captured["kernel_matvec"] == 2
    assert captured["kermat"] == 0
    ops.add_launches(captured, 3)
    assert ops.LAUNCHES["cd_column_update"] == before["cd_column_update"] + 3
    assert ops.LAUNCHES["kernel_matvec"] == before["kernel_matvec"] + 6
    ops.LAUNCHES.update(before)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_level0_graph_keyword_on_the_cpu(use_kernels):
    """On the CPU the level-0 block CD runs eager by default (the same bits
    as ``graph=False``), and ``graph=True`` raises: a CUDA graph needs a
    CUDA device."""
    X, = _uniform(9, (200, 7))
    y = np.sign(np.random.default_rng(10).standard_normal(200)).astype(
        np.float32)
    op = gramop.GramOperator(Xd=torch.from_numpy(X), s=torch.from_numpy(y),
                             kernel=Kernel("rbf", gamma=2.0),
                             use_kernels=use_kernels)
    default = S.solve_box_qp_op(op, 1.0, tol=1e-4, max_iters=40, block=16)
    eager = S.solve_box_qp_op(op, 1.0, tol=1e-4, max_iters=40, block=16,
                              graph=False)
    for field in S.SolveResult._fields:
        a, b = getattr(default, field), getattr(eager, field)
        assert (a is None and b is None) or torch.equal(a, b), field
    with pytest.raises(ValueError, match="CUDA"):
        S.solve_box_qp_op(op, 1.0, max_iters=5, block=16, graph=True)
