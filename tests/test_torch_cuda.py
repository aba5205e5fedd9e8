"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
elsewhere.  The file imports neither JAX nor the reference package, so it
also runs on a GPU machine without them:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are the reference's Pallas-vs-oracle ones: kernel_matrix 2e-5,
kernel_matvec and cd_column_update 2e-4, kmeans_assign 1e-4 on its scores
(the SVM kernels run split-TF32 on the tensor cores, the plain versions
f32 with TF32 off), flash_attention
2e-5 in float32 and 3e-2 for bfloat16 inputs; the bf16 operand forms of
the SVM kernels at the f32 forms' tolerances.  The bf16 flash
kernel (tensor cores, p rounded to bf16) is also held to the bound derived
from bf16's unit roundoff, |o - o_plain| <= 2^-7 |o_plain| + 2^-8
softmax(s).|v| + 1e-4 elementwise (``ref.flash_bf16_share``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import gramop
from repro_torch.core import solver as S
from repro_torch.core import tasks as T
from repro_torch.core.kernels import Kernel
from repro_torch.kernels import build, ops, ref, ring_stress

KINDS = [dict(kind="rbf", gamma=4.0),
         dict(kind="poly", gamma=0.5, degree=3, coef0=1.0),
         dict(kind="linear")]


@pytest.fixture
def cuda_device():
    """The first GPU, with TF32 off for the plain versions; the test skips
    where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rkw(kern):
    return dict(kind=kern.kind, gamma=kern.gamma, degree=kern.degree,
                coef0=kern.coef0)


# (kernel, d): the reference's kernel sweeps run poly at d <= 17; at d = 54
# poly values reach (0.5 * 13.5 + 1)^3 ~ 465, and a matvec over them that
# cancels to near 0 is outside what a 2e-4 tolerance can hold in f32.
CASES = [(KINDS[0], 17), (KINDS[0], 54), (KINDS[1], 17), (KINDS[2], 17),
         (KINDS[2], 54)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw,d", CASES,
                         ids=[f"{kw['kind']}-d{d}" for kw, d in CASES])
def test_cuda_kernels_match_plain_versions(cuda_device, kw, d):
    """Each kernel against its plain version at non-tile-aligned shapes."""
    rng = np.random.default_rng(0)
    kern = Kernel(**kw)
    X = torch.tensor(rng.uniform(size=(300, d)), dtype=torch.float32,
                     device=cuda_device)
    Z = X[:130].contiguous()
    v = torch.tensor(rng.standard_normal(130), dtype=torch.float32,
                     device=cuda_device)
    y = torch.sign(torch.tensor(rng.standard_normal(300),
                                dtype=torch.float32, device=cuda_device))
    torch.testing.assert_close(ops.kernel_matrix(X, Z, kern),
                               ref.kermat_ref(X, Z, **_rkw(kern)),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(ops.kernel_matvec(X, Z, v, kern),
                               ref.kernel_matvec_ref(X, Z, v, **_rkw(kern)),
                               rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(
        ops.cd_column_update(X, y, Z[:64], v[:64], kern),
        ref.cd_column_update_ref(X, y, Z[:64], v[:64], **_rkw(kern)),
        rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_cuda_batched_kernels_match_plain_versions(cuda_device):
    """The batch dimension (grid y / z): every item against its plain
    version, and the block widths of cd_column_update up to B = 256."""
    rng = np.random.default_rng(1)
    kern = Kernel("rbf", gamma=1.0)
    X = torch.tensor(rng.uniform(size=(3, 257, 54)), dtype=torch.float32,
                     device=cuda_device)
    Z = torch.tensor(rng.uniform(size=(3, 1000, 54)), dtype=torch.float32,
                     device=cuda_device)
    v = torch.tensor(rng.standard_normal((3, 1000)), dtype=torch.float32,
                     device=cuda_device)
    torch.testing.assert_close(ops.kernel_matrix(X, Z, kern),
                               ref.kermat_ref(X, Z, **_rkw(kern)),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(ops.kernel_matvec(X, Z, v, kern),
                               ref.kernel_matvec_ref(X, Z, v, **_rkw(kern)),
                               rtol=2e-4, atol=2e-4)
    y = torch.sign(v[0])
    for B in (1, 64, 65, 200, 256):
        torch.testing.assert_close(
            ops.cd_column_update(Z[0], y, X[0, :B], v[1, :B], kern),
            ref.cd_column_update_ref(Z[0], y, X[0, :B], v[1, :B],
                                     **_rkw(kern)),
            rtol=2e-4, atol=2e-4)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_kmeans_assign_matches_plain_version(cuda_device):
    """The fused assignment at a non-aligned shape (n = 1000, m = 333,
    d = 54, k = 7) with one empty centre (zero W column, s = +inf): scores
    to the reference's 1e-4, assignments equal outside near-ties, and the
    empty centre never chosen.  Also k = 300 (two column passes)."""
    rng = np.random.default_rng(2)
    X = torch.tensor(rng.uniform(size=(1000, 54)), dtype=torch.float32,
                     device=cuda_device)
    Xm = X[rng.choice(1000, 333, replace=False)].contiguous()
    for k, empty in ((7, 3), (300, 299)):
        lab = torch.tensor(rng.integers(0, k - 1, 333), device=cuda_device)
        lab[lab >= empty] += 1                   # centre ``empty`` gets none
        H = torch.nn.functional.one_hot(lab, k).float()
        W = (H / H.sum(0).clamp(min=1.0)).contiguous()
        Kmm = ref.kermat_ref(Xm, Xm, kind="rbf", gamma=0.05)
        s = torch.einsum("mk,mn,nk->k", W, Kmm, W)
        s[empty] = torch.inf
        got_a, got_s = ops.kmeans_assign(X, Xm, W, s.contiguous(), 0.05)
        want_a, want_s = ref.kmeans_assign_ref(X, Xm, W, s, gamma=0.05)
        torch.cuda.synchronize()
        assert got_a.dtype == torch.int64 and got_s.shape == (1000, k)
        torch.testing.assert_close(got_s, want_s, rtol=0, atol=1e-4)
        top2 = torch.topk(want_s, 2, dim=1, largest=False).values
        clear = (top2[:, 1] - top2[:, 0]) >= 2e-4
        assert torch.equal(got_a[clear], want_a[clear])
        assert not bool((got_a == empty).any())


# (B, S, Hq, Hkv, hd, dtype, q_offset): every head dim of the dense configs,
# MHA / GQA / MQA, a length that is not a tile multiple and a query offset.
FLASH_CASES = [(2, 200, 4, 4, 64, torch.float32, 0),
               (2, 200, 4, 4, 64, torch.bfloat16, 0),
               (1, 131, 8, 2, 128, torch.float32, 0),
               (1, 131, 8, 2, 128, torch.bfloat16, 0),
               (2, 77, 4, 1, 256, torch.float32, 0),
               (2, 77, 4, 1, 256, torch.bfloat16, 0),
               (1, 96, 4, 2, 128, torch.float32, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "B,S,Hq,Hkv,hd,dtype,q_offset", FLASH_CASES,
    ids=[f"{c[4]}-{c[2]}x{c[3]}-S{c[1]}-{str(c[5])[6:]}-off{c[6]}"
         for c in FLASH_CASES])
def test_cuda_flash_attention_matches_plain_version(cuda_device, causal, B, S,
                                                    Hq, Hkv, hd, dtype,
                                                    q_offset):
    """The flash kernel against ``flash_attention_ref`` (f32 math) on the
    model's (B, S, H, hd) layout: the reference's kernel-vs-oracle
    tolerances, 2e-5 for float32 and 3e-2 for bfloat16 inputs
    (tests/test_flash_attention.py).  The queries are the last S - q_offset
    positions of an S-long key sequence."""
    rng = np.random.default_rng(hd + S)
    q = torch.tensor(rng.standard_normal((B, S - q_offset, Hq, hd)),
                     dtype=dtype, device=cuda_device)
    k, v = (torch.tensor(rng.standard_normal((B, S, Hkv, hd)), dtype=dtype,
                         device=cuda_device) for _ in range(2))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    want = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_flash_attention_strided_and_folded(cuda_device):
    """Inputs that are views with strides of their own (q, k, v sliced out
    of one fused projection), and the reference's folded (BH, S, hd)
    layout given a head axis of 1."""
    rng = np.random.default_rng(5)
    B, S, H, hd = 2, 150, 4, 64
    qkv = torch.tensor(rng.standard_normal((B, S, 3, H, hd)),
                       dtype=torch.float32, device=cuda_device)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               ref.flash_attention_ref(q, k, v),
                               rtol=2e-5, atol=2e-5)
    qf, kf, vf = (t.permute(0, 2, 1, 3).reshape(B * H, S, 1, hd)
                  for t in (q, k, v))
    torch.testing.assert_close(ops.flash_attention(qf, kf, vf, causal=False),
                               ref.flash_attention_ref(qf, kf, vf,
                                                       causal=False),
                               rtol=2e-5, atol=2e-5)
    torch.cuda.synchronize()


# bf16 at every head dim (MHA 4/4 at 64, GQA 8/2 at 128, MQA 4/1 at 256),
# at lengths that are no tile multiple, with and without a query offset
BF16_HEADS = {64: (2, 4, 4), 128: (1, 8, 2), 256: (2, 4, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset", [0, 37])
@pytest.mark.parametrize("S", [77, 131, 200])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_cuda_flash_bf16_within_derived_bound(cuda_device, hd, S, q_offset,
                                              causal):
    """The bf16 tensor-core kernel against ``flash_attention_ref`` at the
    reference's 3e-2 and within the derived bound, and against its plain
    emulation (``flash_attention_bf16_emul``) within the same bound; one
    launch counted."""
    B, Hq, Hkv = BF16_HEADS[hd]
    rng = np.random.default_rng(hd + S + q_offset)
    q = torch.tensor(rng.standard_normal((B, S - q_offset, Hq, hd)),
                     dtype=torch.bfloat16, device=cuda_device)
    k, v = (torch.tensor(rng.standard_normal((B, S, Hkv, hd)),
                         dtype=torch.bfloat16, device=cuda_device)
            for _ in range(2))
    kw = dict(causal=causal, q_offset=q_offset)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               ref.flash_attention_ref(q, k, v, **kw).float(),
                               rtol=3e-2, atol=3e-2)
    o, sv = ref.flash_bf16_bound(q, k, v, **kw)
    assert ref.flash_bf16_share(got, o, sv) <= 1.0
    emul = ref.flash_attention_bf16_emul(q, k, v, **kw)
    assert ref.flash_bf16_share(got, emul, sv) <= 1.0


@pytest.mark.cuda
def test_cuda_flash_bf16_fused_qkv_view(cuda_device):
    """bf16 q, k, v sliced out of one fused projection (strides of their
    own, bases 256 bytes apart) go through the TMA kernel."""
    rng = np.random.default_rng(6)
    B, S, H, hd = 2, 150, 4, 64
    qkv = torch.tensor(rng.standard_normal((B, S, 3, H, hd)),
                       dtype=torch.bfloat16, device=cuda_device)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    o, sv = ref.flash_bf16_bound(q, k, v)
    assert ref.flash_bf16_share(got, o, sv) <= 1.0


@pytest.mark.cuda
def test_cuda_flash_bf16_refuses_what_tma_cannot_read(cuda_device):
    """A bf16 input whose sequence stride is no multiple of 16 bytes, or
    whose base is not 16-byte aligned, raises before any launch."""
    bf = torch.bfloat16
    wide = torch.zeros(1, 64, 1, 68, dtype=bf, device=cuda_device)[..., :64]
    flat = torch.zeros(64 * 2 * 64 + 1, dtype=bf, device=cuda_device)
    unaligned = flat[1:].view(1, 64, 2, 64)
    before = ops.LAUNCHES["flash_attention"]
    for bad in (wide, unaligned):
        with pytest.raises(ValueError):
            ops.flash_attention(bad, bad, bad)
    assert ops.LAUNCHES["flash_attention"] == before


@pytest.mark.cuda
def test_cuda_flash_bf16_kernel_uses_tensor_cores(cuda_device):
    """The built library's bf16 kernels (one a head dim) hold wgmma
    (HGMMA) and TMA loads (UTMALDG) in their SASS."""
    counts = build.sass_counts("flash_attention")
    bf16 = {fn: c for fn, c in counts.items()
            if "flash_attention_bf16_kernel" in fn}
    assert len(bf16) == 3, counts
    assert all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in bf16.values()), bf16


# (kernel, d) of the split-TF32 kernels' sweeps: poly at d = 17 (see CASES);
# rbf at gamma = 0.1, where K between uniform rows at d = 54 is about 0.4
# (at gamma = 4 it is about e^-36 off the diagonal, too small to check)
SPLIT_KINDS = [(dict(kind="rbf", gamma=0.1), 54), (KINDS[1], 17),
               (KINDS[2], 54)]
SPLIT_IDS = [f"{kw['kind']}-d{d}" for kw, d in SPLIT_KINDS]


def _rows(rng, shape, device):
    return torch.tensor(rng.uniform(size=shape), dtype=torch.float32,
                        device=device)


def _assert_split_close(got, want):
    """got within the reference's 2e-4 of want, where want is far above
    that tolerance (so a kernel that returns zeros fails)."""
    assert float(want.abs().max()) > 100 * 2e-4
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 63, 64, 65, 256])
@pytest.mark.parametrize("kw,d", SPLIT_KINDS, ids=SPLIT_IDS)
def test_cuda_cd_column_update_split_tf32(cuda_device, kw, d, B):
    """The split-TF32 cd_column_update against its plain version at a
    ragged n (no multiple of the 128-row tile) and every block width class,
    to the reference's 2e-4; two launches give identical bits.  Xb is
    taken from X's rows, as the solver's working set is."""
    rng = np.random.default_rng(B + d)
    kern = Kernel(**kw)
    X = _rows(rng, (1337, d), cuda_device)
    Xb = X[torch.from_numpy(rng.choice(1337, B, replace=False))].contiguous()
    y = torch.sign(torch.tensor(rng.standard_normal(1337), dtype=torch.float32,
                                device=cuda_device))
    w = torch.tensor(rng.standard_normal(B), dtype=torch.float32,
                     device=cuda_device)
    before = ops.LAUNCHES["cd_column_update"]
    got = ops.cd_column_update(X, y, Xb, w, kern)
    again = ops.cd_column_update(X, y, Xb, w, kern)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cd_column_update"] == before + 2
    _assert_split_close(got, ref.cd_column_update_ref(X, y, Xb, w,
                                                      **_rkw(kern)))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,d", SPLIT_KINDS, ids=SPLIT_IDS)
def test_cuda_kernel_matvec_split_tf32_batched(cuda_device, kw, d):
    """The split-TF32 kernel_matvec, batched (3 items), at ragged n and m
    (no multiples of the 128-row and 64-row tiles), to the reference's
    2e-4; two launches give identical bits.  Z holds X's rows among
    others, as the n x n gradient's does."""
    rng = np.random.default_rng(d)
    kern = Kernel(**kw)
    X = _rows(rng, (3, 301, d), cuda_device)
    Z = torch.cat([_rows(rng, (3, 810, d), cuda_device), X], dim=1)
    v = torch.tensor(rng.standard_normal((3, 1111)), dtype=torch.float32,
                     device=cuda_device)
    before = ops.LAUNCHES["kernel_matvec"]
    got = ops.kernel_matvec(X, Z, v, kern)
    again = ops.kernel_matvec(X, Z, v, kern)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["kernel_matvec"] == before + 2
    _assert_split_close(got, ref.kernel_matvec_ref(X, Z, v, **_rkw(kern)))
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_split_kernels_refuse_what_does_not_fit(cuda_device):
    """Shapes the split-TF32 kernels do not take (d = 0) raise ValueError
    and launch nothing; the cd_column_update C entry itself still refuses
    B = 257 (20000, nothing launched): the wrapper chunks wider blocks."""
    kern = Kernel("rbf", gamma=1.0)
    ones = lambda *shape: torch.ones(*shape, device=cuda_device)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="d >= 1"):
        ops.kernel_matvec(ones(10, 0), ones(20, 0), ones(20), kern)
    with pytest.raises(ValueError, match="d >= 1"):
        ops.cd_column_update(ones(10, 0), ones(10), ones(64, 0), ones(64),
                             kern)
    with pytest.raises(ValueError, match="d >= 1"):
        ops.kernel_matrix(ones(10, 0), ones(20, 0), kern)
    X, y, Xb, w = ones(10, 80), ones(10), ones(257, 80), ones(257)
    out = torch.full((10,), 7.0, device=cuda_device)
    shift = ops.split_shift(Xb, kern)
    err = build.kernel_fn("cd_update")(
        X.data_ptr(), y.data_ptr(), Xb.data_ptr(), w.data_ptr(),
        shift.data_ptr(), out.data_ptr(), 10, 257, 80, 2, *ops._params(kern),
        torch.cuda.current_stream(cuda_device).cuda_stream)
    torch.cuda.synchronize()
    assert err == ops._REFUSED
    assert bool((out == 7.0).all())
    assert ops.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", [54, 254], ids=["resident", "streamed"])
@pytest.mark.parametrize("B", [2, 257, 512, 1024])
def test_cuda_cd_column_update_any_column_count(cuda_device, B, d):
    """C2: cd_column_update at B = 2 (the rank-2 pair step) and past the
    kernel's 256 columns (launched once a chunk of ``ops.cd_chunks``, the
    updates summed in f32), in the resident and streamed forms, against its
    plain version at a ragged n, to the reference's 2e-4; two calls give
    identical bits, one launch a chunk each."""
    rng = np.random.default_rng(B + d)
    kern = _wide_rbf(d) if d > 54 else Kernel("rbf", gamma=1.0)
    X = _rows(rng, (1337, d), cuda_device)
    Xb = X[torch.from_numpy(rng.choice(1337, B, replace=B > 1337))].contiguous()
    y = torch.sign(torch.tensor(rng.standard_normal(1337), dtype=torch.float32,
                                device=cuda_device))
    w = torch.tensor(rng.standard_normal(B), dtype=torch.float32,
                     device=cuda_device)
    before = ops.LAUNCHES["cd_column_update"]
    got = ops.cd_column_update(X, y, Xb, w, kern)
    again = ops.cd_column_update(X, y, Xb, w, kern)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cd_column_update"] == before + 2 * len(
        ops.cd_chunks(B))
    _assert_split_close(got, ref.cd_column_update_ref(X, y, Xb, w,
                                                      **_rkw(kern)))
    assert torch.equal(got, again)


def _wide_rbf(d):
    """rbf at a gamma where K between uniform rows of width d is about 0.4."""
    return Kernel("rbf", gamma=5.4 / d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [129, 254, 3072])
def test_cuda_kernel_matvec_any_width(cuda_device, d):
    """kernel_matvec past the resident form's d <= 128 (the streamed form,
    ``split_tile_plan``) against its plain version, batched, at ragged n
    and m, to the reference's 2e-4; two launches give identical bits."""
    rng = np.random.default_rng(d)
    kern = _wide_rbf(d)
    assert ops.split_tile_plan(d).stages == 0
    X = _rows(rng, (2, 301, d), cuda_device)
    Z = torch.cat([_rows(rng, (2, 500, d), cuda_device), X], dim=1)
    v = torch.tensor(rng.standard_normal((2, 801)), dtype=torch.float32,
                     device=cuda_device)
    got = ops.kernel_matvec(X, Z, v, kern)
    again = ops.kernel_matvec(X, Z, v, kern)
    torch.cuda.synchronize()
    _assert_split_close(got, ref.kernel_matvec_ref(X, Z, v, **_rkw(kern)))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("B,d", [(64, 254), (256, 80), (256, 254), (64, 3072),
                                 (256, 3072)])
def test_cuda_cd_column_update_any_width(cuda_device, B, d):
    """cd_column_update past the resident form (d > 149 at B = 64, d > 72 at
    B = 256: the streamed form) against its plain version at a ragged n,
    to the reference's 2e-4; two launches give identical bits."""
    rng = np.random.default_rng(B + d)
    kern = _wide_rbf(d)
    assert ops.split_tile_plan(d, B).stages == 0
    X = _rows(rng, (1337, d), cuda_device)
    Xb = X[torch.from_numpy(rng.choice(1337, B, replace=False))].contiguous()
    y = torch.sign(torch.tensor(rng.standard_normal(1337), dtype=torch.float32,
                                device=cuda_device))
    w = torch.tensor(rng.standard_normal(B), dtype=torch.float32,
                     device=cuda_device)
    got = ops.cd_column_update(X, y, Xb, w, kern)
    again = ops.cd_column_update(X, y, Xb, w, kern)
    torch.cuda.synchronize()
    _assert_split_close(got, ref.cd_column_update_ref(X, y, Xb, w,
                                                      **_rkw(kern)))
    assert torch.equal(got, again)


# (kernel, d) of the kermat sweep: every kind at the main path's d = 54 and
# at webspam's d = 254, gammas scaled so that the values stay moderate
KERMAT_CASES = [(dict(kind=kind, gamma=g * 54 / d, degree=3, coef0=1.0), d)
                for d in (54, 254)
                for kind, g in (("rbf", 0.1), ("poly", 0.16), ("linear", 1.0))]


@pytest.mark.cuda
@pytest.mark.parametrize("kw,d", KERMAT_CASES,
                         ids=[f"{kw['kind']}-d{d}" for kw, d in KERMAT_CASES])
def test_cuda_kermat_split_tf32(cuda_device, kw, d):
    """The split-TF32 kermat against its plain version, batched (3 items)
    at ragged n and m (no multiples of the 64-row tile, m no multiple of
    4), to the reference's 2e-5; K(X, X) through the kernel is symmetric
    bit for bit and matches too."""
    rng = np.random.default_rng(d)
    kern = Kernel(**kw)
    X = _rows(rng, (3, 150, d), cuda_device)
    Y = _rows(rng, (3, 203, d), cuda_device)
    before = ops.LAUNCHES["kermat"]
    got = ops.kernel_matrix(X, Y, kern)
    sym = ops.kernel_matrix(Y, Y, kern)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["kermat"] == before + 2
    for out, A, B in ((got, X, Y), (sym, Y, Y)):
        torch.testing.assert_close(out, ref.kermat_ref(A, B, **_rkw(kern)),
                                   rtol=2e-5, atol=2e-5)
    assert torch.equal(sym, sym.transpose(1, 2))


@pytest.mark.cuda
def test_cuda_kmeans_assign_wide(cuda_device):
    """The fused assignment at webspam's d = 254 (four depth slices) with
    k = 256 (two column passes): scores to the reference's 1e-4,
    assignments equal outside near-ties."""
    rng = np.random.default_rng(3)
    d, k = 254, 256
    X = _rows(rng, (900, d), cuda_device)
    Xm = X[torch.from_numpy(rng.choice(900, 400, replace=False))].contiguous()
    lab = torch.tensor(rng.integers(0, k, 400), device=cuda_device)
    H = torch.nn.functional.one_hot(lab, k).float()
    W = (H / H.sum(0).clamp(min=1.0)).contiguous()
    gamma = 5.4 / d
    Kmm = ref.kermat_ref(Xm, Xm, kind="rbf", gamma=gamma)
    s = torch.einsum("mk,mn,nk->k", W, Kmm, W)
    s = torch.where(W.sum(0) <= 0, torch.inf, s).contiguous()
    got_a, got_s = ops.kmeans_assign(X, Xm, W, s, gamma)
    want_a, want_s = ref.kmeans_assign_ref(X, Xm, W, s, gamma=gamma)
    torch.cuda.synchronize()
    finite = torch.isfinite(want_s)
    assert torch.equal(finite, torch.isfinite(got_s))
    torch.testing.assert_close(got_s[finite], want_s[finite], rtol=0,
                               atol=1e-4)
    top2 = torch.topk(want_s, 2, dim=1, largest=False).values
    clear = (top2[:, 1] - top2[:, 0]) >= 2e-4
    assert torch.equal(got_a[clear], want_a[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,k", [(400, 254, 256), (1000, 54, 4)])
def test_cuda_kmeans_assign_refuses_short_scratch(cuda_device, m, d, k):
    """The C entry refuses (and launches nothing for) a scratch buffer one
    float4 shorter than the layout its module defines, and the wrapper
    sizes the buffer from that same module."""
    group, kp = ops._assign_layout(k)
    floats = ops._assign_scratch(m, d, kp, group)
    assert floats >= 2 * m * (d + kp)   # hi and lo of Xm and of W at least
    dev = cuda_device
    X, Xm = torch.rand(64, d, device=dev), torch.rand(m, d, device=dev)
    W, s = torch.rand(m, k, device=dev), torch.rand(k, device=dev)
    shift = Xm.mean(0)
    scratch = torch.zeros(floats, device=dev)
    scores = torch.full((64, k), -1.0, device=dev)
    assign = torch.full((64,), -1, device=dev, dtype=torch.int64)
    err = build.kernel_fn("kmeans_assign")(
        X.data_ptr(), Xm.data_ptr(), W.data_ptr(), s.data_ptr(),
        shift.data_ptr(), scratch.data_ptr(), floats - 4, scores.data_ptr(),
        assign.data_ptr(), 64, m, d, k, kp, group, 0.1,
        torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 20000
    assert bool((scratch == 0).all() and (scores == -1).all()
                and (assign == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cd_update", "kermatvec", "kermat",
                                  "kmeans_assign"])
def test_cuda_split_kernels_use_tensor_cores(cuda_device, name):
    """The built library's product kernels hold tensor-core MMA
    instructions in their SASS: HGMMA (wgmma) in kernel_matvec's and
    kermat's, HMMA (mma.sync) in cd_column_update's and in kmeans_assign's
    (with HGMMA too for k > 32); kmeans_assign_prep, which only splits Xm
    and W into fragment order, runs no product."""
    counts = build.sass_counts(name, ("HGMMA", "HMMA"))
    products = {fn: c for fn, c in counts.items() if "_prep" not in fn}
    assert products, name
    assert all(c["HGMMA"] + c["HMMA"] > 0 for c in products.values()), counts


@pytest.mark.cuda
@pytest.mark.parametrize("tol,max_iters", [(1e-3, 150), (0.3, 400)],
                         ids=["to-cap", "converges"])
def test_cuda_graphed_level0_matches_eager(cuda_device, tol, max_iters):
    """The level-0 block CD replayed as a CUDA graph against the eager loop
    on the card, n = 8192: bit-identical alpha, grad, iters and pg_max, and
    the same kernel launches (one cd_column_update a step run)."""
    rng = np.random.default_rng(7)
    X = _rows(rng, (8192, 54), cuda_device)
    y = torch.sign(torch.tensor(rng.standard_normal(8192), dtype=torch.float32,
                                device=cuda_device))
    op = gramop.GramOperator(Xd=X, s=y, kernel=Kernel("rbf", gamma=1.0),
                             use_kernels=True)
    out, launches = {}, {}
    for graph in (False, True):
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        out[graph] = S.solve_box_qp_op(op, 8.0, tol=tol, max_iters=max_iters,
                                       graph=graph)
        torch.cuda.synchronize()
        launches[graph] = {k: ops.LAUNCHES[k] - before[k] for k in before}
    for field in S.SolveResult._fields:
        a, b = getattr(out[False], field), getattr(out[True], field)
        assert (a is None and b is None) or torch.equal(a, b), field
    assert launches[False] == launches[True]
    iters = int(out[True].iters)
    steps = launches[True]["cd_column_update"]
    assert launches[True]["kernel_matvec"] == 1
    if iters == max_iters:
        assert steps == iters
    else:
        assert iters <= steps < iters + S.SYNC_EVERY


@pytest.mark.cuda
@pytest.mark.parametrize("tol,max_iters", [(1e-3, 150), (0.3, 400)],
                         ids=["to-cap", "converges"])
def test_cuda_graphed_level0_under_dedup_matches_eager(cuda_device, tol,
                                                       max_iters):
    """The graphed level-0 block CD on epsilon-SVR's dual (8192 coordinates
    over 4096 base rows) with the dedup view, whose rank-B update runs
    cd_column_update over the base rows with y = 1 and gathers: bit-identical
    to its eager loop, with the same launches."""
    rng = np.random.default_rng(9)
    X = _rows(rng, (4096, 10), cuda_device)
    yv = torch.tensor(rng.standard_normal(4096), dtype=torch.float32,
                      device=cuda_device)
    td = T.EpsilonSVR(eps=0.1).build(X, yv[None], 4.0)
    Xb, bidx = td.base_view()
    op = gramop.GramOperator(Xd=td.Xd.contiguous(), s=td.S[0], Xb=Xb,
                             bidx=bidx, kernel=Kernel("rbf", gamma=1.0),
                             use_kernels=True)
    out, launches = {}, {}
    for graph in (False, True):
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        out[graph] = S.solve_box_qp_op(op, td.Cvec[0], tol=tol,
                                       max_iters=max_iters, p=td.P[0],
                                       graph=graph)
        torch.cuda.synchronize()
        launches[graph] = {k: ops.LAUNCHES[k] - before[k] for k in before}
    for field in S.SolveResult._fields:
        a, b = getattr(out[False], field), getattr(out[True], field)
        assert (a is None and b is None) or torch.equal(a, b), field
    assert launches[False] == launches[True]
    assert launches[True]["cd_column_update"] >= int(out[True].iters) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("block,G", [(1, 1), (1, 2), (32, 2)],
                         ids=["pairwise", "pairwise-2-groups",
                              "blocked-2-groups"])
def test_cuda_eq_matvec_kernels_match_plain(cuda_device, block, G):
    """solve_eq_qp_matvec through the kernels (cd_column_update at B = 2 a
    pair step, or 2 * 2 * 32 = 128 columns a blocked step; kernel_matvec a
    refresh) against the plain versions on the card, n = 8192: the same
    objective to 1e-4 relative, both at the stopping gap or the cap, and one
    cd_column_update a step."""
    rng = np.random.default_rng(3 + block + G)
    n = 8192
    X = _rows(rng, (n, 54), cuda_device)
    y = torch.sign(torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                                device=cuda_device))
    gid = (y < 0).long() if G == 2 else None
    d = torch.full((G,), 0.1 * n / G, device=cuda_device)
    out, launches = {}, {}
    for use in (True, False):
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        out[use] = S.solve_eq_qp_matvec(
            X, y, Kernel("rbf", gamma=1.0), 1.0, 1.0, d, tol=1e-3,
            max_iters=40 if block > 1 else 3000, use_kernels=use,
            block=block, gid=gid, n_groups=G)
        torch.cuda.synchronize()
        launches[use] = {k: ops.LAUNCHES[k] - before[k] for k in before}

    def objective(res):
        Kv = ref.kernel_matvec_ref(X, X, y * res.alpha, kind="rbf", gamma=1.0)
        return 0.5 * float(torch.dot(res.alpha, y * Kv))

    fk, fp = objective(out[True]), objective(out[False])
    assert abs(fk - fp) <= 1e-4 * abs(fp)
    for res in out.values():
        assert float(res.pg_max) <= 1e-3 or int(res.iters) == (
            40 if block > 1 else 3000)
    steps = launches[True]["cd_column_update"]
    it = int(out[True].iters)
    assert it <= steps and launches[True]["kernel_matvec"] >= 1
    assert launches[False]["cd_column_update"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["pairwise", "blocked", "matvec-pairwise",
                                    "matvec-blocked"])
def test_cuda_graphed_equality_engines_match_eager(cuda_device, engine):
    """The equality engines with each step replayed as a CUDA graph against
    their eager loops on the card: bit-identical alpha, grad, iters and
    pg_max, and the same kernel launches.  Dense: a batch of three masked
    problems of 512 with two groups; matvec: n = 8192 through the
    kernels."""
    rng = np.random.default_rng(21)
    kern = Kernel("rbf", gamma=1.0)
    out, launches = {}, {}
    if engine.startswith("matvec"):
        n = 8192
        X = _rows(rng, (n, 54), cuda_device)
        y = torch.sign(torch.tensor(rng.standard_normal(n),
                                    dtype=torch.float32, device=cuda_device))

        def run(graph):
            return S.solve_eq_qp_matvec(
                X, y, kern, 1.0, 1.0, torch.full((2,), 0.05 * n,
                                                 device=cuda_device),
                tol=1e-3, max_iters=30 if engine.endswith("blocked") else 600,
                use_kernels=True, block=16 if engine.endswith("blocked") else 1,
                gid=(y < 0).long(), n_groups=2, graph=graph)
    else:
        b, n = 3, 512
        X = _rows(rng, (b, n, 20), cuda_device)
        y = torch.sign(torch.tensor(rng.standard_normal((b, n)),
                                    dtype=torch.float32, device=cuda_device))
        Q = ops.kernel_matrix(X, X, kern) * y[:, :, None] * y[:, None, :]
        mask = torch.ones((b, n), dtype=torch.bool, device=cuda_device)
        mask[1, 400:] = False
        fn = S.solve_eq_qp_block if engine == "blocked" else S.solve_eq_qp
        extra = dict(block=8, sweeps=2) if engine == "blocked" else {}

        def run(graph):
            return fn(Q, mask.float(), mask.float(),
                      torch.full((b, 2), 0.05 * n, device=cuda_device),
                      tol=1e-3, max_iters=200 if extra else 2000,
                      active_mask=mask, gid=(y < 0).long(), n_groups=2,
                      graph=graph, **extra)
    for graph in (False, True):
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        out[graph] = run(graph)
        torch.cuda.synchronize()
        launches[graph] = {k: ops.LAUNCHES[k] - before[k] for k in before}
    for field in S.SolveResult._fields:
        a, b = getattr(out[False], field), getattr(out[True], field)
        assert (a is None and b is None) or torch.equal(a, b), field
    assert launches[False] == launches[True]
    assert int(out[True].iters.max()) > 0


def _same_ring(a, b):
    """Two rings equal bit for bit (NaN where nothing was recorded)."""
    return (torch.equal(a.buf.view(torch.int32), b.buf.view(torch.int32))
            and torch.equal(a.count, b.count))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["op", "op-cached-bf16", "eq-pairwise",
                                    "eq-blocked", "eq-dense", "spill"])
def test_cuda_graphed_traced_matches_eager(cuda_device, engine):
    """The traced level-0 engines, their recording inside the CUDA graphs:
    the graphed traced loop gives the eager traced loop's alpha, grad,
    iters, pg_max, counters and ring bit for bit, with the same launches;
    the graphed untraced loop gives the traced one's results with the same
    kernel launches (the ring adds none).  Level 0's block CD (n = 8192),
    its cached bf16 branch (512 rows), the Gram-free pairwise and blocked
    equality steps, the dense equality step on a masked batch, and the
    spill tier's panel step."""
    from repro_torch.obs.trace import trace_fetch, trace_init

    rng = np.random.default_rng(31)
    kern = Kernel("rbf", gamma=1.0)
    n = 8192
    X = _rows(rng, (n, 54), cuda_device)
    y = torch.sign(torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                                device=cuda_device))
    if engine == "eq-dense":
        Xb = _rows(rng, (3, 512, 20), cuda_device)
        yb = torch.sign(torch.tensor(rng.standard_normal((3, 512)),
                                     dtype=torch.float32, device=cuda_device))
        Q = ops.kernel_matrix(Xb, Xb, kern) * yb[:, :, None] * yb[:, None, :]
        mask = torch.ones((3, 512), dtype=torch.bool, device=cuda_device)
        mask[1, 400:] = False

    def run(graph, trace):
        if engine.startswith("op"):
            cd = BF if engine.endswith("bf16") else None
            op = gramop.GramOperator(Xd=X, s=y, kernel=kern, use_kernels=True,
                                     compute_dtype=cd)
            return S.solve_box_qp_op(op, 8.0, tol=1e-3, max_iters=150,
                                     cache_cap=512 if cd else 0, graph=graph,
                                     trace=trace)
        if engine == "eq-dense":
            return S.solve_eq_qp(Q, mask.float(), mask.float(),
                                 torch.full((3, 2), 25.6, device=cuda_device),
                                 tol=1e-3, max_iters=2000, active_mask=mask,
                                 gid=(yb < 0).long(), n_groups=2, graph=graph,
                                 trace=trace)
        if engine.startswith("eq"):
            blocked = engine == "eq-blocked"
            return S.solve_eq_qp_matvec(
                X, y, kern, 1.0, 1.0, torch.full((2,), 0.05 * n,
                                                 device=cuda_device),
                tol=1e-3, max_iters=30 if blocked else 600, use_kernels=True,
                block=16 if blocked else 1, gid=(y < 0).long(), n_groups=2,
                graph=graph, trace=trace)
        op = gramop.GramOperator(Xd=X[:4096], s=y[:4096], kernel=kern,
                                 use_kernels=True)
        return gramop.solve_box_qp_spill(
            op, 1.0, tol=1e-3, max_iters=3000, block=64,
            device_budget_bytes=1024 * 4096 * 4, graph=graph, trace=trace)

    out, launches = {}, {}
    for key in ((False, True), (True, True), (True, False)):
        graph, traced = key
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        out[key] = run(graph, trace_init(256, device=cuda_device)
                       if traced else None)
        torch.cuda.synchronize()
        launches[key] = {k: ops.LAUNCHES[k] - before[k] for k in before}
    eager, graphed, plain = out[False, True], out[True, True], out[True, False]
    for field in S.SolveResult._fields:
        a, b = getattr(eager, field), getattr(graphed, field)
        if field == "trace":
            assert _same_ring(a, b)
        else:
            assert (a is None and b is None) or torch.equal(a, b), field
    for field in ("alpha", "grad", "iters", "pg_max"):
        assert torch.equal(getattr(plain, field), getattr(graphed, field))
    assert plain.trace is None
    assert launches[False, True] == launches[True, True] == launches[
        True, False]
    fetched = trace_fetch(graphed.trace)
    rings = fetched if isinstance(fetched, list) else [fetched]
    assert all(f["samples"] > 0 for f in rings if "pg_max" in f)
    if engine != "spill":
        iters = graphed.iters.reshape(-1).tolist()
        assert [f["samples"] + f["dropped"] for f in rings] == iters


# --- the bf16 operand forms (compute_dtype="bfloat16") ---------------------
#
# Held to their plain versions on the same inputs at the f32 forms'
# tolerances (kermat 2e-5, the others 2e-4 of 1 + |plain|): both round the
# operands to bf16 and sum exact f32 products, in another order.

BF = "bfloat16"


def _bf_close(got, want, tol):
    err = ((got.double() - want.double()).abs()
           / (1 + want.double().abs())).max()
    assert float(err) <= tol, float(err)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", KINDS, ids=[k["kind"] for k in KINDS])
@pytest.mark.parametrize("d", [1, 54, 254, 256, 300, 600])
def test_cuda_bf16_forms_match_plain_versions(cuda_device, kw, d):
    """Every d: one shared-memory slice up to 256 columns, further slices
    past it (300, 600)."""
    rng = np.random.default_rng(d)
    kern = Kernel(**dict(kw, gamma=kw.get("gamma", 1.0) * min(1.0, 17 / d)))
    X = _rows(rng, (333, d), cuda_device)
    Y = _rows(rng, (517, d), cuda_device)
    v = torch.tensor(rng.standard_normal(517), dtype=torch.float32,
                     device=cuda_device)
    rk = _rkw(kern)
    _bf_close(ops.kernel_matrix(X, Y, kern, compute_dtype=BF).cpu(),
              ref.kermat_bf16_ref(X.cpu(), Y.cpu(), **rk), 2e-5)
    Kxx = ops.kernel_matrix(X, X, kern, compute_dtype=BF)
    assert torch.equal(Kxx, Kxx.T)                     # bit-symmetric
    _bf_close(ops.kernel_matvec(X, Y, v, kern, compute_dtype=BF).cpu(),
              ref.kernel_matvec_bf16_ref(X.cpu(), Y.cpu(), v.cpu(), **rk),
              2e-4)
    P = ops.pack_bf16(X)
    _bf_close(ops.kernel_matvec(P, ops.pack_bf16(Y), v, kern,
                                compute_dtype=BF).cpu(),
              ref.kernel_matvec_bf16_ref(X.cpu(), Y.cpu(), v.cpu(), **rk),
              2e-4)
    s = torch.sign(torch.tensor(rng.standard_normal(333), dtype=torch.float32,
                                device=cuda_device))
    for B in (2, 64, 257):
        Xb = _rows(rng, (B, d), cuda_device)
        w = torch.tensor(rng.standard_normal(B), dtype=torch.float32,
                         device=cuda_device)
        want = ref.cd_column_update_bf16_ref(X.cpu(), s.cpu(), Xb.cpu(),
                                             w.cpu(), **rk)
        _bf_close(ops.cd_column_update(X, s, Xb, w, kern,
                                       compute_dtype=BF).cpu(), want, 2e-4)
        _bf_close(ops.cd_column_update(P, s, ops.pack_bf16(Xb), w, kern,
                                       compute_dtype=BF).cpu(), want, 2e-4)


@pytest.mark.cuda
def test_cuda_bf16_forms_batched_and_refusals(cuda_device):
    rng = np.random.default_rng(3)
    kern = Kernel("rbf", gamma=0.05)
    X = _rows(rng, (5, 70, 54), cuda_device)
    Y = _rows(rng, (5, 90, 54), cuda_device)
    v = torch.tensor(rng.standard_normal((5, 90)), dtype=torch.float32,
                     device=cuda_device)
    _bf_close(ops.kernel_matrix(X, Y, kern, compute_dtype=BF).cpu(),
              ref.kermat_bf16_ref(X.cpu(), Y.cpu(), **_rkw(kern)), 2e-5)
    _bf_close(ops.kernel_matvec(X, Y, v, kern, compute_dtype=BF).cpu(),
              ref.kernel_matvec_bf16_ref(X.cpu(), Y.cpu(), v.cpu(),
                                         **_rkw(kern)), 2e-4)
    wide = _rows(rng, (2, 70, 300), cuda_device)     # two slices a row
    assert ops.pack_bf16(wide).data.shape == (2, 70, 304)
    _bf_close(ops.kernel_matrix(wide, wide, kern, compute_dtype=BF).cpu(),
              ref.kermat_bf16_ref(wide.cpu(), wide.cpu(), **_rkw(kern)),
              2e-5)
    _bf_close(ops.kernel_matvec(wide, wide, v[:2, :70].contiguous(), kern,
                                compute_dtype=BF).cpu(),
              ref.kernel_matvec_bf16_ref(wide.cpu(), wide.cpu(),
                                         v[:2, :70].cpu(), **_rkw(kern)),
              2e-4)
    with pytest.raises(ValueError):                    # only bf16 on the card
        ops.kernel_matrix(X[0], Y[0], kern, compute_dtype="float16")


# The persistent forms of kermat_bf16 and cd_column_update_bf16 at their
# edges: n % 64 in {1, 63}, n below one tile, and more tiles than the
# persistent grid has blocks (at most a few per SM of the 132).

def _mv_close(got, want, mag, tol=2e-5):
    """The bf16 matvec forms' measure: |got - want| within tol of 1 +
    sum_j |K_ij w_j| (``mag``), where want is far from zero."""
    err = ((got.double() - want.double()).abs()
           / (1 + mag.double().abs())).max()
    assert float(err) <= tol, float(err)
    assert float(want.abs().max()) > 100 * tol


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 40, 64 * 3 + 1, 64 * 5 + 63, 64 * 700 + 1])
def test_cuda_bf16_kermat_row_form_ragged(cuda_device, m):
    """The row form (64 block rows against m rows, packed) and a ragged
    (65, m) block, against the plain version."""
    rng = np.random.default_rng(m)
    kern = Kernel("rbf", gamma=0.3)
    Y = _rows(rng, (m, 54), cuda_device)
    X = _rows(rng, (65, 54), cuda_device)
    P = ops.pack_bf16(Y)
    A = ops.pack_bf16(X[:64].contiguous())
    for got, Xr in ((ops.kernel_matrix(A, P, kern, compute_dtype=BF), X[:64]),
                    (ops.kernel_matrix(X, Y, kern, compute_dtype=BF), X)):
        want = ref.kermat_bf16_ref(Xr.cpu(), Y.cpu(), **_rkw(kern))
        _bf_close(got.cpu(), want, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", KINDS, ids=[k["kind"] for k in KINDS])
@pytest.mark.parametrize("shape", [(1, 1921), (3, 127), (2, 65)],
                         ids=["n1921", "batch3-n127", "batch2-n65"])
def test_cuda_bf16_kermat_symmetric_persistent(cuda_device, kw, shape):
    """K(X, X) bit-symmetric and equal to the plain version where a
    block's run of tiles crosses rows of tiles and batch items (1921 rows:
    496 tiles on and above the diagonal)."""
    b, n = shape
    rng = np.random.default_rng(n)
    kern = Kernel(**dict(kw, gamma=kw.get("gamma", 1.0) * 0.1))
    X = _rows(rng, (b, n, 17), cuda_device)
    K = ops.kernel_matrix(X, X, kern, compute_dtype=BF)
    assert torch.equal(K, K.transpose(1, 2))
    _bf_close(K.cpu(), ref.kermat_bf16_ref(X.cpu(), X.cpu(), **_rkw(kern)),
              2e-5)


# (batch, n, m): n % 256 (a unit's rows) in {1, 255}, n below one unit,
# m % 64 (a ring entry; 32 in the wide form) in {0, 1, 63}, m below one
# entry, and 305 units of a batch of 5, more than the persistent grid's
# blocks (two an SM of the 132, one in the wide form)
MV_EDGES = [(1, 1, 64 * 3), (1, 100, 20), (1, 257, 64 * 3 + 1),
            (1, 511, 64 * 3 + 63), (5, 256 * 60 + 1, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", KINDS, ids=[k["kind"] for k in KINDS])
@pytest.mark.parametrize("d", [54, 300, 600],
                         ids=["one-slice", "wide", "wide-x-streamed"])
def test_cuda_bf16_matvec_ragged_persistent(cuda_device, kw, d):
    """kernel_matvec_bf16's persistent grid and Z ring at their edges
    (``MV_EDGES``), one-slice, wide with a unit's X rows staged whole
    (300) and wide with X streamed under the ring (600), held to the
    plain version at 2e-5 of 1 + sum_j |K_ij w_j|."""
    rng = np.random.default_rng(d)
    kern = Kernel(**dict(kw, gamma=1.0 / d if kw["kind"] == "rbf"
                         else kw.get("gamma", 1.0) * 17 / d))
    for b, n, m in MV_EDGES:
        X = _rows(rng, (b, n, d), cuda_device)
        Z = _rows(rng, (b, m, d), cuda_device)
        v = torch.tensor(rng.standard_normal((b, m)), dtype=torch.float32,
                         device=cuda_device)
        got = ops.kernel_matvec(ops.pack_bf16(X), ops.pack_bf16(Z), v, kern,
                                compute_dtype=BF)
        Xc, Zc, vc = X.cpu(), Z.cpu(), v.cpu()
        want = ref.kernel_matvec_bf16_ref(Xc, Zc, vc, **_rkw(kern))
        mag = ref.kernel_matvec_bf16_ref(Xc, Zc, vc.abs(), **_rkw(kern))
        _mv_close(got.cpu(), want, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 54, 300, 600])
def test_cuda_bf16_forms_repeat_bit_identical(cuda_device, d):
    """Each bf16 form, launched 100 times more on the same inputs, equal
    bit for bit to its first launch: the matvec at the ring's edges
    (``MV_EDGES``), kermat_bf16 and cd_column_update_bf16 (B 2, 64, 257)
    at the shapes of ``test_cuda_bf16_forms_match_plain_versions``, every
    kind.  Their sums run in a fixed order, so a launch that differs has
    raced on shared memory."""
    rng = np.random.default_rng(d + 1)

    def rows(shape):
        return ops.pack_bf16(_rows(rng, shape, cuda_device))

    def gauss(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=cuda_device)

    for kw in KINDS:
        gamma = kw.get("gamma", 1.0) * min(1.0, 17 / d)
        kern = Kernel(**dict(kw, gamma=gamma))
        calls = []
        for b, n, m in MV_EDGES:
            calls.append((ops.kernel_matvec, rows((b, n, d)),
                          rows((b, m, d)), gauss((b, m))))
        X, s = rows((333, d)), torch.sign(gauss(333))
        calls.append((ops.kernel_matrix, X, rows((517, d))))
        for B in (2, 64, 257):
            calls.append((ops.cd_column_update, X, s, rows((B, d)),
                          gauss(B)))
        for fn, *args in calls:
            first = fn(*args, kern, compute_dtype=BF)
            for _ in range(100):
                assert torch.equal(fn(*args, kern, compute_dtype=BF), first)


@pytest.mark.cuda
def test_cuda_bf16_ring_stress(cuda_device):
    """ROADMAP C4: every bf16 form at its ring's edges (``ring_stress.
    FORMS``: the matvec with two blocks an SM and one, 12 to 4 ring
    entries, wide, X streamed, batched; kermat's and cd_update's rings;
    d = 1), 4,000 launches each held bit for bit to the first, then each
    matvec form 300 times under the ring check build (``build.ring_check``:
    the Z ring's entry tags checked when full and at release, its slot
    counts at exit; also with the ring forced to 2 entries): no mismatch,
    no fault, every exit check run."""
    res = ring_stress.stress(4000, 300, device=cuda_device)
    assert not ring_stress.failures(res), ring_stress.failures(res)
    geo = {name: (r["check"]["grid"], r["check"]["stages"],
                  r["check"]["xring"], r["check"]["blocks_per_sm"])
           for name, r in res.items() if r["kernel"] == "kernel_matvec_bf16"}
    # the edges the forms are named for: blocks an SM, entries, X streamed
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    want = {1: (2, 12, 0), 54: (2, 5, 0), 200: (1, 4, 0), 300: (1, 5, 0),
            600: (1, 4, 1)}
    for name, (grid, stages, xring, occ) in geo.items():
        d = res[name]["d"]
        assert (occ, stages, xring) == want[d], (name, geo[name])
        assert grid <= occ * sms


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 63, 64, 65, 257, 1000])
def test_cuda_bf16_cd_column_update_ragged(cuda_device, B):
    """cd_column_update_bf16 at every chunk edge of B (1000 at d = 54
    takes two passes of resident chunks) and n at tile edges and past
    the persistent grid, held to 2e-5 of 1 + sum_j |K_ij w_j|."""
    rng = np.random.default_rng(B)
    kern = Kernel("rbf", gamma=0.2)
    Xb = _rows(rng, (B, 54), cuda_device)
    w = torch.tensor(rng.standard_normal(B), dtype=torch.float32,
                     device=cuda_device)
    for n in (1, 127, 129, 64 * 782 + 1):
        X = _rows(rng, (n, 54), cuda_device)
        y = torch.sign(torch.tensor(rng.standard_normal(n),
                                    dtype=torch.float32, device=cuda_device))
        got = ops.cd_column_update(ops.pack_bf16(X), y, ops.pack_bf16(Xb), w,
                                   kern, compute_dtype=BF)
        Xc, yc, Bc, wc = X.cpu(), y.cpu(), Xb.cpu(), w.cpu()
        want = ref.cd_column_update_bf16_ref(Xc, yc, Bc, wc, **_rkw(kern))
        mag = ref.cd_column_update_bf16_ref(Xc, yc.abs(), Bc, wc.abs(),
                                            **_rkw(kern))
        if n > 1:
            _mv_close(got.cpu(), want, mag)
        else:
            _bf_close(got.cpu(), want, 2e-5)


@pytest.mark.cuda
def test_cuda_bf16_cd_column_update_dedup_route(cuda_device):
    """The dedup route of SVR's level 0: base rows at d = 10 (16 packed
    columns), y = 1, B = 64."""
    rng = np.random.default_rng(10)
    kern = Kernel("rbf", gamma=1.0)
    X = _rows(rng, (65536, 10), cuda_device)
    ones = torch.ones(65536, device=cuda_device)
    w = torch.tensor(rng.standard_normal(64), dtype=torch.float32,
                     device=cuda_device)
    P = ops.pack_bf16(X)
    got = ops.cd_column_update(P, ones, P.index(torch.arange(
        64, device=cuda_device)), w, kern, compute_dtype=BF)
    Xc = X.cpu()
    want = ref.cd_column_update_bf16_ref(Xc, ones.cpu(), Xc[:64], w.cpu(),
                                         **_rkw(kern))
    mag = ref.cd_column_update_bf16_ref(Xc, ones.cpu(), Xc[:64],
                                        w.cpu().abs(), **_rkw(kern))
    _mv_close(got.cpu(), want, mag)


@pytest.mark.cuda
def test_cuda_bf16_row_form_served_in_graph(cuda_device):
    """The predicated row form inside a CUDA graph, as the cached level 0
    replays it: not served, the replay matches the plain version; served,
    a NaN-filled output is left untouched; then not served again."""
    rng = np.random.default_rng(12)
    kern = Kernel("rbf", gamma=0.3)
    Y = _rows(rng, (64 * 300 + 63, 54), cuda_device)
    P = ops.pack_bf16(Y)
    A = P.index(torch.arange(64, device=cuda_device))
    flag = torch.tensor(False, device=cuda_device)

    def row_form():
        return ops.kernel_matrix(A, P, kern, compute_dtype=BF, skip=flag)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        row_form()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = row_form()
    want = ref.kermat_bf16_ref(Y[:64].cpu(), Y.cpu(), **_rkw(kern))
    for served in (False, True, False):
        out.fill_(float("nan"))
        flag.fill_(served)
        graph.replay()
        torch.cuda.synchronize()
        if served:
            assert bool(torch.isnan(out).all())
        else:
            _bf_close(out.cpu(), want, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [54, 30001], ids=["staged", "read-back"])
def test_cuda_bf16_pack_matches_plain(cuda_device, d):
    """bf16_pack: the same bits as the plain rounding, and norms summed in
    column order (rows past 48 KB of staging read back from the output)."""
    rng = np.random.default_rng(d)
    X = _rows(rng, (300 if d < 1000 else 5, d), cuda_device)
    P = ops.pack_bf16(X)
    q = X.cpu().to(torch.bfloat16)
    assert torch.equal(P.data.cpu()[:, :d], q)
    assert not bool(P.data.cpu()[:, d:].float().any())
    qf = q.float()
    want = torch.zeros(X.shape[0])
    for k in range(d):          # one fma chain in column order
        want = torch.addcmul(want, qf[:, k], qf[:, k])
    err = ((P.norms.cpu().double() - want.double()).abs()
           / (1 + want.double())).max()
    assert float(err) <= 1e-6, float(err)


@pytest.mark.cuda
def test_cuda_bf16_redesigned_kernels_sass(cuda_device):
    """The persistent kermat_bf16, kernel_matvec_bf16 and
    cd_column_update_bf16 kernels (every kind, one-slice and wide) hold
    tensor-core products (HMMA) and asynchronous copies (LDGSTS; the
    matvec's Z ring also TMA, UTMALDG), and no local memory (LDL/STL:
    spills); bf16_pack holds no local memory either."""
    counts = build.sass_counts("bf16_gram",
                               ("HMMA", "LDGSTS", "UTMALDG", "LDL", "STL"))
    for key in ("bg_kermat_kernel", "bg_matvec_kernel", "bg_cd_kernel"):
        fns = {fn: c for fn, c in counts.items() if key in fn}
        assert len(fns) == 6, (key, counts)
        for fn, c in fns.items():
            assert c["HMMA"] > 0 and c["LDGSTS"] > 0, (fn, c)
            assert c["LDL"] == 0 and c["STL"] == 0, (fn, c)
            if key == "bg_matvec_kernel":
                assert c["UTMALDG"] > 0, (fn, c)
    pack = {fn: c for fn, c in counts.items() if "bg_pack_kernel" in fn}
    assert len(pack) == 1
    assert all(c["LDL"] == 0 and c["STL"] == 0 for c in pack.values()), pack


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, BF], ids=["f32", "bf16"])
def test_cuda_kermat_skip_predicate(cuda_device, cd):
    """The predicated row form: with the flag clear it is kermat; with it
    set the launch writes nothing (the output keeps what was there)."""
    rng = np.random.default_rng(4)
    kern = Kernel("rbf", gamma=0.1)
    A = _rows(rng, (64, 54), cuda_device)
    Bm = _rows(rng, (3000, 54), cuda_device)
    want = ops.kernel_matrix(A, Bm, kern, compute_dtype=cd)
    got = ops.kernel_matrix(A, Bm, kern, compute_dtype=cd,
                            skip=torch.tensor(False, device=cuda_device))
    assert torch.equal(got, want)
    # a freed block of NaNs is what the allocator hands back next
    torch.full((64, 3000), float("nan"), device=cuda_device)
    torch.cuda.synchronize()
    before = ops.LAUNCHES["kermat_bf16" if cd else "kermat"]
    skipped = ops.kernel_matrix(A, Bm, kern, compute_dtype=cd,
                                skip=torch.tensor(True, device=cuda_device))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["kermat_bf16" if cd else "kermat"] == before + 1
    assert not torch.equal(skipped, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("tol,max_iters", [(1e-3, 150), (0.3, 400)],
                         ids=["to-cap", "converges"])
def test_cuda_graphed_cached_level0_matches_eager(cuda_device, tol,
                                                  max_iters, cd):
    """The cached level-0 block CD (column cache inside the CUDA graph,
    kermat's row form behind the device predicate) against its eager loop:
    bit-identical alpha, grad, iters, pg_max and cache counters, and the
    same launches."""
    rng = np.random.default_rng(7)
    X = _rows(rng, (8192, 54), cuda_device)
    y = torch.sign(torch.tensor(rng.standard_normal(8192), dtype=torch.float32,
                                device=cuda_device))
    out, launches = {}, {}
    for graph in (False, True):
        op = gramop.GramOperator(Xd=X, s=y, kernel=Kernel("rbf", gamma=1.0),
                                 use_kernels=True, compute_dtype=cd)
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        out[graph] = S.solve_box_qp_op(op, 8.0, tol=tol, max_iters=max_iters,
                                       cache_cap=512, graph=graph)
        torch.cuda.synchronize()
        launches[graph] = {k: ops.LAUNCHES[k] - before[k] for k in before}
    for field in S.SolveResult._fields:
        a, b = getattr(out[False], field), getattr(out[True], field)
        assert (a is None and b is None) or torch.equal(a, b), field
    assert launches[False] == launches[True]
    r = out[True]
    assert int(r.cache_hits) + int(r.cache_misses) == 64 * int(r.iters)


@pytest.mark.cuda
def test_cuda_spill_matches_cpu_counters(cuda_device):
    """The spill tier on the card (pinned host panels, side-stream
    prefetch, graphed panel sub-solve) keeps the CPU port's panel schedule
    over three rounds of full sub-solves (tol -1: the schedule alone
    decides the counters, not where the f32 and split-TF32 paths part):
    the same counters and iterations; then both converge (tol 1e-3) to
    the same objective."""
    rng = np.random.default_rng(11)
    X = rng.uniform(-0.7, 0.7, (2048, 10)).astype(np.float32)
    y = np.where(rng.random(2048) < 0.5, 1.0, -1.0).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda_device):
        op = gramop.GramOperator(Xd=torch.tensor(X, device=dev),
                                 s=torch.tensor(y, device=dev),
                                 kernel=Kernel("rbf", gamma=0.5),
                                 use_kernels=dev != "cpu")
        res[str(dev)] = [gramop.solve_box_qp_spill(
            op, 1.0, tol=tol, max_iters=20_000, block=64, max_rounds=rounds,
            device_budget_bytes=512 * 2048 * 4)
            for tol, rounds in ((-1.0, 3), (1e-3, 512))]
    (cpu, cpu_opt), (gpu, gpu_opt) = res["cpu"], res[str(cuda_device)]
    for f in ("iters", "cache_hits", "cache_misses", "cache_evictions",
              "spills", "spill_hits"):
        assert int(getattr(gpu, f)) == int(getattr(cpu, f)), f
    assert int(gpu.spills) == 4 and int(gpu.spill_hits) > 0
    assert float(gpu_opt.pg_max) <= 1e-3
    f_cpu = float(S.objective(cpu_opt.alpha, cpu_opt.grad))
    f_gpu = float(S.objective(gpu_opt.alpha.cpu(), gpu_opt.grad.cpu()))
    assert abs(f_gpu - f_cpu) <= 1e-4 * abs(f_cpu)


def _packed(sizes, max_batch):
    """The batches the engine forms from one group's queue when every
    request is queued before its loop pops (``engine._pop_ready``)."""
    groups, cur, total = [], [], 0
    for i, n in enumerate(sizes):
        if cur and total + n > max_batch:
            groups.append(cur)
            cur, total = [], 0
        cur.append(i)
        total += n
    return groups + [cur] if cur else groups


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["early", "exact"])
def test_cuda_engine_on_an_explicit_device(cuda_device, monkeypatch,
                                           strategy):
    """The async engine over a model fitted on an explicit cuda:0: every
    serve_batch on the engine's one device thread with cuda:0 current; a
    burst's requests bit for bit a direct serve_batch of their merged
    bucket and, served alone, within 2e-5 of 1 + sum_j K |w_j| with the
    same predictions off a 1e-3 margin; kermat's rows the same bits alone
    and merged (only the product with the weights follows the bucket);
    kermat and kmeans_assign launched; no library loaded after warmup."""
    import asyncio
    import threading

    from repro_torch.core import DCSVMConfig, fit_ova
    from repro_torch.core.predict import bucket_size
    from repro_torch.data import gaussian_mixture_multiclass
    from repro_torch.launch import engine as E
    from repro_torch.launch.registry import ModelRegistry
    from repro_torch.launch.serve_svm import serve_batch, serving_cache_size

    X, y = gaussian_mixture_multiclass(np.random.default_rng(0), 3000,
                                       n_classes=3, d=10)
    kern = Kernel("rbf", gamma=8.0)
    model = fit_ova(DCSVMConfig(kernel=kern, C=4.0, k=4, levels=2, m=500),
                    X, y, device=cuda_device)
    reg = ModelRegistry()
    reg.register("m", model)
    sm = reg.resolve("m").sm
    assert sm.device == cuda_device
    seen = []

    def recording(*a, **kw):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_device()))
        return serve_batch(*a, **kw)

    config = E.EngineConfig(max_batch=64)
    engine = E.AsyncServingEngine(reg, config)
    engine.warmup(strategies=[strategy])
    libs = serving_cache_size()
    monkeypatch.setattr(E, "serve_batch", recording)
    rng = np.random.default_rng(1)
    sizes = [1, 7, 33, 12, 64, 50, 3, 28, 16, 4]
    reqs = [X[rng.integers(0, len(X), size=n)] for n in sizes]

    async def burst():
        async with engine:
            return await asyncio.gather(*[
                engine.submit(r, "m", strategy=strategy) for r in reqs])

    ops.reset_launches()
    outs = asyncio.run(burst())
    launches = dict(ops.LAUNCHES)
    assert launches["kermat"] and launches["kmeans_assign"] == (
        len(_packed(sizes, 64)) if strategy == "early" else 0)
    assert len(seen) == len(_packed(sizes, 64))
    assert {t for t, _ in seen} == {seen[0][0]} != {"MainThread"}
    assert {d for _, d in seen} == {0}
    assert engine.stats()["compiles_after_warmup"] == 0
    assert serving_cache_size() == libs
    absm = sm._replace(Wsv=sm.Wsv.abs(), Wall=sm.Wall.abs())
    for group in _packed(sizes, 64):
        rows = np.concatenate([reqs[i] for i in group])
        bucket = bucket_size(len(rows), hi=64)
        mp, ms = serve_batch(sm, rows, kern, strategy, bucket=bucket)
        k_merged = ops.kernel_matrix(torch.as_tensor(rows, device=cuda_device),
                                     sm.Xall, kern)
        off = 0
        for i in group:
            n = len(reqs[i])
            pred, scores = outs[i]
            np.testing.assert_array_equal(scores, ms[off:off + n].cpu())
            np.testing.assert_array_equal(pred, mp[off:off + n].cpu())
            k_alone = ops.kernel_matrix(
                torch.as_tensor(reqs[i], device=cuda_device), sm.Xall, kern)
            assert torch.equal(k_alone, k_merged[off:off + n])
            off += n
            ap, alone = serve_batch(sm, reqs[i], kern, strategy,
                                    bucket=bucket_size(n))
            _, mag = serve_batch(absm, reqs[i], kern, strategy,
                                 bucket=bucket_size(n))
            alone, mag = alone.cpu().numpy(), mag.cpu().numpy()
            assert (np.abs(scores - alone) / (1 + mag)).max() <= 2e-5
            top = np.sort(alone, axis=1)
            clear = top[:, -1] - top[:, -2] > 1e-3
            np.testing.assert_array_equal(pred[clear], ap.cpu()[clear])


@pytest.mark.cuda
def test_cuda_every_kernel_from_a_fresh_thread_on_an_explicit_device(
        cuda_device, monkeypatch):
    """Every kernel launched on explicit cuda:0 tensors from a fresh thread
    whose current device was never set: each C entry runs with the
    tensors' device current (the wrappers' device guard), and every
    output is bit for bit the main thread's.  One card cannot show a
    second device; the per-device caches of the C libraries are keyed by
    the current device's ordinal."""
    import threading

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.uniform(-0.7, 0.7, shape).astype(
            np.float32)).to(dev, dtype)

    kern = Kernel("rbf", gamma=0.5)
    X, Z, Xc = t(300, 54), t(200, 54), t(4, 96, 54)
    v, y, w = t(200), torch.sign(t(300)), t(64)
    W, s = t(200, 7).abs(), t(7).abs()
    q, k, vv = t(1, 96, 2, 64), t(1, 96, 2, 64), t(1, 96, 2, 64)
    qb, kb, vb = (a.to(torch.bfloat16) for a in (q, k, vv))
    bf = dict(compute_dtype="bfloat16")
    calls = {
        "kermat": lambda: ops.kernel_matrix(X, Z, kern),
        "kermat symmetric batched": lambda: ops.kernel_matrix(Xc, Xc, kern),
        "kernel_matvec": lambda: ops.kernel_matvec(X, Z, v, kern),
        "cd_column_update": lambda: ops.cd_column_update(X, y, Z[:64], w,
                                                         kern),
        "kmeans_assign": lambda: ops.kmeans_assign(X, Z, W, s, 0.5),
        "bf16_pack": lambda: ops.pack_bf16(X).data,
        "kermat_bf16": lambda: ops.kernel_matrix(X, Z, kern, **bf),
        "kernel_matvec_bf16": lambda: ops.kernel_matvec(X, Z, v, kern, **bf),
        "cd_column_update_bf16": lambda: ops.cd_column_update(
            X, y, Z[:64], w, kern, **bf),
        "flash_attention bf16": lambda: ops.flash_attention(qb, kb, vb),
        "flash_attention f32": lambda: ops.flash_attention(q, k, vv),
    }
    main = {name: fn() for name, fn in calls.items()}
    torch.cuda.synchronize(dev)
    seen, got, errors = [], {}, []
    real = build.kernel_fn

    def kernel_fn(name):
        fn = real(name)

        def call(*args):
            seen.append((name, torch.cuda.current_device()))
            return fn(*args)
        return call

    def run():
        try:
            for name, fn in calls.items():
                got[name] = fn()
            torch.cuda.synchronize(dev)
        except Exception as exc:      # re-raised in the test's thread
            errors.append(exc)

    monkeypatch.setattr(build, "kernel_fn", kernel_fn)
    worker = threading.Thread(target=run, name="fresh")
    worker.start()
    worker.join()
    if errors:
        raise errors[0]
    assert {name for name, _ in seen} >= {
        "kermat", "kermatvec", "cd_update", "kmeans_assign", "bf16_pack",
        "kermat_bf16", "kernel_matvec_bf16", "cd_update_bf16",
        "flash_attention"}
    assert {d for _, d in seen} == {dev.index}
    for name, want in main.items():
        want = want if isinstance(want, tuple) else (want,)
        out = got[name] if isinstance(got[name], tuple) else (got[name],)
        for a, b in zip(want, out):
            assert a.device == dev and torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode,cache", [("parallel", 0), ("parallel", 512),
                                        ("replicated", 0)])
def test_cuda_conquer_kernels_against_plain(cuda_device, mode, cache):
    """The distributed conquer at one rank (a world of one) on 2,048
    covtype_like rows through the kernels against the same conquer through
    the plain versions on the card, over its first 100 rounds (of about
    180 to tol 1e-3: converged runs part at f32 near-ties of the top-B
    scores and stop 1-3 rounds apart): equal rounds, the objective to 1e-4
    relative; one kernel_matvec (the initial gradient) and, uncached, one
    cd_column_update a round."""
    from repro_torch.core import distributed as DI
    from repro_torch.data import covtype_like
    from repro_torch.launch.mesh import make_conquer_mesh

    X, y = covtype_like(np.random.default_rng(0), 2048)
    X = torch.from_numpy(X).to(cuda_device)
    y = torch.from_numpy(y).to(cuda_device)
    mesh = make_conquer_mesh("i", device=cuda_device)
    kern = Kernel("rbf", gamma=1.0)
    runs = {}
    for use_kernels in (True, False):
        cfg = DI.ConquerConfig(kernel=kern, C=8.0, tol=1e-3, max_iters=100,
                               block=64, mode=mode, cache_cap=cache,
                               use_kernels=use_kernels)
        ops.reset_launches()
        runs[use_kernels] = DI.conquer_step(mesh, "i", cfg, X, y,
                                            torch.zeros_like(y))
        torch.cuda.synchronize()
        if use_kernels:
            launches = dict(ops.LAUNCHES)
    Xd = X.double()
    Q = (y.double()[:, None] * y.double()[None, :]) * torch.exp(
        -((Xd[:, None, :] - Xd[None, :, :]) ** 2).sum(-1))

    def f(a):
        a = a.double()
        return float(0.5 * a @ Q @ a - a.sum())

    (ak, rk, pk), (ap, rp, pp) = runs[True], runs[False]
    assert int(rk) == int(rp), (int(rk), int(rp))
    assert abs(f(ak) - f(ap)) <= 1e-4 * abs(f(ap)), (f(ak), f(ap))
    assert launches["kernel_matvec"] == 1
    steps, rounds = launches["cd_column_update"], int(rk)
    if cache:
        assert launches["kermat"] == rounds and steps == 0
    else:
        assert steps == rounds == 100


# ---- the comparison solvers (repro_torch.baselines) ----------------------

# each baseline's kernels on the card (its row of the kernel table); RFF
# launches none
BASELINE_KERNELS = {"exact": {"kermat"},
                    "exact-gram-free": {"kermat", "kernel_matvec",
                                        "cd_column_update"},
                    "cascade": {"kermat"}, "llsvm": {"kermat"},
                    "rff": set(), "ltpu": {"kermat"}}


def _baseline(name, X, y, device, use_kernels):
    from repro_torch import baselines as TB

    kern = Kernel("rbf", gamma=8.0)
    kw = dict(device=device, use_kernels=use_kernels)
    if name.startswith("exact"):
        return TB.train_exact(X, y, kern, 4.0, full_gram_threshold=512
                              if name == "exact-gram-free" else 16384, **kw)
    if name == "cascade":
        return TB.train_cascade(X, y, kern, 4.0, levels=2, **kw)
    if name == "llsvm":
        return TB.train_llsvm(X, y, kern, 4.0, num_landmarks=64,
                              max_iters=300, **kw)
    if name == "rff":
        return TB.train_rff(X, y, kern, 4.0, num_features=256,
                            max_iters=300, **kw)
    return TB.train_ltpu(X, y, kern, num_units=64, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BASELINE_KERNELS))
def test_cuda_baseline_launches_its_kernels(cuda_device, name):
    """Each comparison solver on CUDA tensors launches the kernels of its
    row (RFF none) and meets its plain run on the card: objective to 1e-4
    relative where it solves a kernel dual, decisions within 1e-3 of 1 +
    |f| elsewhere, and accuracy within 0.01 either way."""
    from repro_torch.data import gaussian_mixture, train_test_split

    rng = np.random.default_rng(0)
    X, y = gaussian_mixture(rng, 1500, d=8, modes_per_class=4, spread=0.15)
    Xtr, ytr, Xte, yte = (torch.from_numpy(a).to(cuda_device)
                          for a in train_test_split(rng, X, y))
    ops.reset_launches()
    got = _baseline(name, Xtr, ytr, cuda_device, None)
    dec = got.decision(Xte)
    launched = {k for k, v in ops.LAUNCHES.items() if v}
    assert launched == BASELINE_KERNELS[name]
    assert dec.device == Xte.device and dec.dtype == torch.float32
    plain = _baseline(name, Xtr, ytr, cuda_device, False)
    want = plain.decision(Xte)
    acc = [float((torch.sign(d) == yte).float().mean()) for d in (dec, want)]
    assert abs(acc[0] - acc[1]) <= 0.01 and acc[0] > 0.85
    if name.startswith("exact"):
        K = ref.kermat_ref(Xtr, Xtr, kind="rbf", gamma=8.0).double()
        Q = (ytr[:, None] * ytr[None, :]).double() * K

        def f(a):
            a = a.double()
            return float(0.5 * a @ Q @ a - a.sum())

        assert abs(f(got.alpha) - f(plain.alpha)) <= 1e-4 * abs(
            f(plain.alpha))
    elif name in ("llsvm", "rff", "ltpu"):
        assert float(((dec - want).abs() / (1 + want.abs())).max()) <= 1e-3


@pytest.mark.cuda
def test_cuda_gram_blocks_and_checkpoint_round_trip(cuda_device, tmp_path):
    """gram_blocks is one batched kermat launch at kermat's 2e-5; a
    checkpoint of CUDA tensors restores on the card bit for bit."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core.kernels import gram_blocks

    Xc = torch.rand(4, 300, 54, device=cuda_device)
    kern = Kernel("rbf", gamma=1.0)
    ops.reset_launches()
    K = gram_blocks(kern, Xc, use_kernels=True)
    assert ops.LAUNCHES["kermat"] == 1 and K.shape == (4, 300, 300)
    torch.testing.assert_close(K, gram_blocks(kern, Xc), rtol=2e-5,
                               atol=2e-5)
    mgr = CheckpointManager(str(tmp_path))
    tree = {"K": K, "level": torch.tensor(3, dtype=torch.int32,
                                          device=cuda_device)}
    mgr.save(1, tree)
    K.zero_()                    # after the host copy: not in the file
    mgr.wait()
    back = mgr.restore({"K": torch.zeros(0), "level": torch.zeros(
        (), dtype=torch.int32)}, device=cuda_device)
    assert back["K"].device == K.device and int(back["level"]) == 3
    torch.testing.assert_close(back["K"], gram_blocks(kern, Xc,
                                                      use_kernels=True),
                               rtol=0, atol=0)
