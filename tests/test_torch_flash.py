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
