"""The port's flash attention against the reference on the same numpy
inputs.

On the CPU ``ops.flash_attention`` runs its plain version
(``ref.flash_attention_ref``); the reference runs its Pallas kernel in
interpret mode and its naive oracle.  Cases and tolerances are those of
tests/test_flash_attention.py: 2e-5 in float32, 3e-2 for bfloat16 inputs,
1e-4 for the x30 stability case, 2e-4 against the model's chunked
attention.  The CUDA kernel itself is held to the same plain version by
tests/test_torch_cuda.py and chip_smoke.py on a machine with a GPU.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention import flash_attention_ref as jflash_ref
from repro.models.layers import chunked_attention as jchunked
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import chunked_attention


def _qkv(seed, q_shape, kv_shape, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (scale * rng.standard_normal(q_shape)).astype(np.float32)
    k = rng.standard_normal(kv_shape).astype(np.float32)
    v = rng.standard_normal(kv_shape).astype(np.float32)
    return q, k, v


def _t(*arrs):
    """Torch tensors in the port's (B, S, H, hd) layout: the reference's
    folded (BH, S, hd) arrays gain a head axis of 1."""
    return [torch.from_numpy(a)[:, :, None] for a in arrs]


@pytest.mark.parametrize("BH,Sq,Sk,hd,bq,bk", [
    (2, 128, 128, 32, 64, 64),
    (1, 256, 256, 64, 64, 128),
    (3, 64, 192, 16, 32, 64),     # rectangular (cross-attention shape)
    (2, 128, 128, 128, 128, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference(BH, Sq, Sk, hd, bq, bk, causal):
    """The reference's folded (BH, S, hd) inputs, one head each, against the Pallas kernel and its
    oracle; the causal rectangular case (which the reference skips) against
    the oracle alone, whose mask is row >= column."""
    q, k, v = _qkv(BH + Sq, (BH, Sq, hd), (BH, Sk, hd))
    got = ops.flash_attention(*_t(q, k, v), causal=causal)[:, :, 0].numpy()
    want = np.asarray(jflash_ref(q, k, v, causal=causal))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        ref.flash_attention_ref(*_t(q, k, v), causal=causal)[:, :, 0].numpy(),
        want, rtol=2e-5, atol=2e-5)
    if not (causal and Sq != Sk):
        kern = np.asarray(jflash(q, k, v, causal=causal, bq=bq, bk=bk,
                                 interpret=True))
        np.testing.assert_allclose(got, kern, rtol=2e-5, atol=2e-5)


def test_flash_bf16_inputs():
    q, k, v = _qkv(7, (2, 128, 64), (2, 128, 64))
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jflash(qb, kb, vb, causal=True, bq=64, bk=64, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32))[:, :, None]
                  .bfloat16() for a in (qb, kb, vb))
    got = ops.flash_attention(tq, tk, tv, causal=True)[:, :, 0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jflash_ref(qb, kb, vb, causal=True), np.float32),
        rtol=3e-2, atol=3e-2)


def test_flash_online_softmax_stability():
    """Large score magnitudes (q x 30) stay finite and match."""
    q, k, v = _qkv(9, (1, 128, 32), (1, 128, 32), scale=30.0)
    got = ops.flash_attention(*_t(q, k, v), causal=True)[:, :, 0].numpy()
    want = np.asarray(jflash(q, k, v, causal=True, bq=64, bk=64,
                             interpret=True))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("Sq,Sk,q_offset", [(50, 50, 0), (37, 61, 24),
                                            (1, 33, 32)])
def test_flash_ragged_and_offset_match_chunked_attention(Sq, Sk, q_offset):
    """Lengths that are no tile multiple, and queries at positions
    q_offset + i, against the reference's chunked attention (GQA 4/2)."""
    q, k, v = _qkv(Sq + Sk, (2, Sq, 4, 32), (2, Sk, 2, 32))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = np.asarray(jchunked(q, k, v, causal=True, chunk=16,
                               q_offset=q_offset))
    got = ops.flash_attention(tq, tk, tv, causal=True,
                              q_offset=q_offset).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    plain = chunked_attention(tq, tk, tv, causal=True, chunk=16,
                              q_offset=q_offset, use_kernels=False).numpy()
    np.testing.assert_allclose(plain, want, rtol=2e-5, atol=2e-5)


def test_flash_matches_model_attention_gqa():
    """The reference's test_flash_matches_model_attention (B 2, S 128,
    Hq 4, Hkv 2, hd 32): the flash path on the model's layout, without
    repeating K/V, against the reference's chunked attention at 2e-4."""
    q, k, v = _qkv(0, (2, 128, 4, 32), (2, 128, 2, 32))
    want = np.asarray(jchunked(q, k, v, causal=True, chunk=64))
    before = dict(ops.LAUNCHES)
    got = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=True, chunk=64,
                            use_kernels=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert ops.LAUNCHES == before       # the CPU runs the plain version


def test_flash_rejects_bad_inputs():
    q = torch.zeros(2, 8, 3, 16)
    kv = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError):
        ops.flash_attention(q, kv, kv)           # 3 query heads over 2
    with pytest.raises(ValueError):
        ops.flash_attention(q[:, :, :2], kv, kv, q_offset=-1)
    with pytest.raises(TypeError):
        ops.flash_attention(q[:, :, :2], kv.double(), kv)
    with pytest.raises(ValueError):                # 3-D: no head axis
        ops.flash_attention(q[:, :, 0], kv[:, :, 0], kv[:, :, 0])


# The bf16 kernel rounds p to bf16 before P.V (tensor cores).  Its plain
# emulation (ref.flash_attention_bf16_emul) is held to the f32 plain
# output within the bound derived from bf16's unit roundoff u = 2^-8:
# |o - o_plain| <= 2^-7 |o_plain| + 2^-8 softmax(s).|v| + 1e-4 elementwise
# (ref.flash_bf16_share); the reference's Pallas kernel (interpret mode,
# p in f32) is held to the emulation within the same bound; and a mask one
# position off and a non-causal output must both exceed it.  Heads: MHA,
# GQA and MQA, each at a length that is no tile multiple, two with queries
# at an offset (the last Sq of S positions).
BF16_CASES = [("mha", 2, 2, 2, 77, 0), ("gqa", 1, 4, 2, 131, 37),
              ("mqa", 1, 4, 1, 200, 37)]


def _bf16_qkv(seed, B, Sq, Sk, Hq, Hkv, hd):
    q, k, v = _qkv(seed, (B, Sq, Hq, hd), (B, Sk, Hkv, hd))
    return [torch.from_numpy(a).bfloat16() for a in (q, k, v)]


def _jax_flash_bf16(q, k, v, q_offset):
    """The reference's flash kernel on the port's layout: heads folded into
    the batch, K/V repeated per query head, and q_offset zero query rows
    in front so that its top-left causal mask puts row i at q_offset + i
    (q_offset + Sq == Sk)."""
    B, Sq, Hq, hd = q.shape
    G = Hq // k.shape[2]

    def fold(t):
        a = t.float().numpy()
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(-1, a.shape[1], hd),
                           jnp.bfloat16)

    qp = torch.cat([torch.zeros(B, q_offset, Hq, hd, dtype=q.dtype), q], 1)
    kr, vr = (t.repeat_interleave(G, dim=2) for t in (k, v))
    o = jflash(fold(qp), fold(kr), fold(vr), causal=True, bq=qp.shape[1],
               bk=kr.shape[1], interpret=True)
    o = np.asarray(o, np.float32).reshape(B, Hq, -1, hd).transpose(0, 2, 1, 3)
    return torch.from_numpy(np.ascontiguousarray(o[:, q_offset:]))


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("kind,B,Hq,Hkv,S,q_offset", BF16_CASES,
                         ids=[c[0] for c in BF16_CASES])
def test_flash_bf16_emulation_within_derived_bound(hd, kind, B, Hq, Hkv, S,
                                                   q_offset):
    q, k, v = _bf16_qkv(hd + S, B, S - q_offset, S, Hq, Hkv, hd)
    o, sv = ref.flash_bf16_bound(q, k, v, causal=True, q_offset=q_offset)
    emul = ref.flash_attention_bf16_emul(q, k, v, causal=True,
                                         q_offset=q_offset)
    assert emul.dtype == torch.bfloat16 and emul.shape == q.shape
    assert ref.flash_bf16_share(emul, o, sv) <= 1.0
    jax_o = _jax_flash_bf16(q, k, v, q_offset)
    assert ref.flash_bf16_share(jax_o, emul, sv) <= 1.0
    # the bound still tells a wrong attention apart
    for wrong in (dict(causal=True, q_offset=q_offset + 1),
                  dict(causal=False, q_offset=q_offset)):
        bad = ref.flash_attention_bf16_emul(q, k, v, **wrong)
        assert ref.flash_bf16_share(bad, o, sv) > 1.0, wrong


@pytest.mark.parametrize("bk", [16, 48, 128])
def test_flash_bf16_emulation_key_tile(bk):
    """The key tile moves only where p is rescaled and rounded: at any tile
    (one of 16 keys, one that splits the keys raggedly, one that holds them
    all) the emulation stays within the derived bound of the plain output
    and within one bf16 ulp (2^-7 relative) of the kernel's own tile."""
    q, k, v = _bf16_qkv(3, 1, 100, 100, 2, 1, 64)
    o, sv = ref.flash_bf16_bound(q, k, v)
    got = ref.flash_attention_bf16_emul(q, k, v, bk=bk)
    assert ref.flash_bf16_share(got, o, sv) <= 1.0
    torch.testing.assert_close(got.float(),
                               ref.flash_attention_bf16_emul(q, k, v).float(),
                               rtol=2 ** -7, atol=2 ** -8)


def test_flash_tma_strides():
    """The bf16 kernel's TMA checks, which the CPU can run on their own:
    the model's layouts pass (contiguous, and q, k, v sliced out of one
    fused projection), with an axis of size 1 given a contiguous stride;
    an unaligned base, a stride that is no multiple of 8 elements, a head
    dim other than 64/128/256 and a non-unit last stride are refused."""
    bf = torch.bfloat16
    q = torch.zeros(2, 10, 4, 64, dtype=bf)
    kv = torch.zeros(2, 12, 2, 64, dtype=bf)
    assert ops.flash_tma_strides(q, kv, kv) == (2560, 256, 64, 1536, 128,
                                                64, 1536, 128, 64)
    qkv = torch.zeros(2, 10, 3, 4, 128, dtype=bf)
    fused = ops.flash_tma_strides(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    assert fused == (15360, 1536, 128) * 3
    one = torch.zeros(1, 10, 1, 64, dtype=bf).as_strided((1, 10, 1, 64),
                                                         (7, 64, 3, 1))
    assert ops.flash_tma_strides(one, one, one)[:3] == (640, 64, 64)
    flat = torch.zeros(10 * 4 * 64 + 1, dtype=bf)
    unaligned = flat[1:].view(1, 10, 4, 64)
    wide = torch.zeros(1, 10, 1, 68, dtype=bf)[..., :64]
    for bad in (unaligned, wide, torch.zeros(1, 10, 1, 96, dtype=bf),
                torch.zeros(1, 10, 1, 128, dtype=bf)[..., ::2]):
        with pytest.raises(ValueError):
            ops.flash_tma_strides(bad, bad, bad)
