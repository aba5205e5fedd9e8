"""Plain PyTorch versions of the hand-written kernels (their oracles).

They repeat the arithmetic of ``csrc/*.cu`` with PyTorch operators (in
plain f32) and are what the ``ops`` wrappers run for a tensor on the CPU.
The RBF form is the Gram expansion ``exp(-gamma * max(|x|^2 + |y|^2 -
2 x.y, 0))``.  Leading batch dimensions broadcast like ``torch.matmul``.
"""
from __future__ import annotations

import math

import torch


def kermat_ref(X, Y, *, kind="rbf", gamma=1.0, degree=3, coef0=0.0):
    g = X.float() @ Y.float().mT
    if kind == "linear":
        return g
    if kind == "poly":
        return (gamma * g + coef0) ** degree
    xx = torch.sum(X.float() ** 2, -1)[..., :, None]
    yy = torch.sum(Y.float() ** 2, -1)[..., None, :]
    return torch.exp(-gamma * torch.clamp(xx + yy - 2 * g, min=0.0))


def kmeans_assign_ref(X, Xm, W, s, *, gamma=1.0):
    """Fused assignment scores ``-2 K(X, Xm) @ W + s`` (RBF) and their row
    argmin (lowest index on ties).  Returns (assign (n,) int64, scores
    (n, k)); a center with ``s = +inf`` never wins."""
    k = kermat_ref(X, Xm, kind="rbf", gamma=gamma)
    scores = -2.0 * k @ W.float() + s.float()
    return torch.argmin(scores, dim=-1), scores


def _shifted(X, Y, kind):
    """(X - mu, Y - mu) with mu the mean of Y's rows, for rbf (as the
    cd_column_update and kernel_matvec kernels do: K depends on x - y
    alone, and the Gram expansion then cancels between smaller numbers);
    unchanged for linear and poly."""
    if kind != "rbf":
        return X, Y
    mu = Y.float().mean(dim=-2, keepdim=True)
    return X.float() - mu, Y.float() - mu


def cd_column_update_ref(X, y, Xb, w, *, kind="rbf", gamma=1.0, degree=3,
                         coef0=0.0):
    k = kermat_ref(*_shifted(X, Xb, kind), kind=kind, gamma=gamma,
                   degree=degree, coef0=coef0)
    return y * (k @ w)


def kernel_matvec_ref(X, Z, v, *, kind="rbf", gamma=1.0, degree=3, coef0=0.0):
    k = kermat_ref(*_shifted(X, Z, kind), kind=kind, gamma=gamma,
                   degree=degree, coef0=coef0)
    return (k @ v.float()[..., None])[..., 0]


# --- the bf16 operand forms (compute_dtype="bfloat16", csrc/bf16_gram.cu) --
#
# Both operands rounded to bf16 (to nearest even), the products summed in
# f32, the rbf norms of the rounded rows in f32, the transform in f32; no
# mean shift.  ``*_rounded`` take rows already rounded and held in f32 (a
# packed operand's values, exactly); v, w and y stay in their dtype.

def kermat_rounded(Xr, Yr, *, kind="rbf", gamma=1.0, degree=3, coef0=0.0):
    g = Xr @ Yr.mT
    if kind == "linear":
        return g
    if kind == "poly":
        return (gamma * g + coef0) ** degree
    xx = torch.sum(Xr * Xr, -1)[..., :, None]
    yy = torch.sum(Yr * Yr, -1)[..., None, :]
    return torch.exp(-gamma * torch.clamp(xx + yy - 2.0 * g, min=0.0))


def rounded(X, dtype=torch.bfloat16):
    """X rounded to ``dtype`` (to nearest even) and held in f32."""
    return X.to(dtype).float()


def kermat_bf16_ref(X, Y, **kw):
    return kermat_rounded(rounded(X), rounded(Y), **kw)


def kernel_matvec_rounded(Xr, Zr, v, **kw):
    k = kermat_rounded(Xr, Zr, **kw)
    return (k.to(v.dtype) @ v[..., None])[..., 0]


def kernel_matvec_bf16_ref(X, Z, v, **kw):
    return kernel_matvec_rounded(rounded(X), rounded(Z), v, **kw)


def cd_column_update_rounded(Xr, y, Xbr, w, **kw):
    return y * (kermat_rounded(Xr, Xbr, **kw).to(w.dtype) @ w)


def cd_column_update_bf16_ref(X, y, Xb, w, **kw):
    return cd_column_update_rounded(rounded(X), y, rounded(Xb), w, **kw)


# --- split-TF32 (the arithmetic of every SVM kernel in csrc/) --------------
#
# x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both rounded to
# nearest with ties away from zero (cvt.rna.tf32.f32); x.z is taken as
# lo_x.hi_z + hi_x.lo_z + hi_x.hi_z on the tensor cores with f32
# accumulation, the two small products in their own sum.  The RBF form is
# exp2(min(2c g - c|x|^2 - c|z|^2, 0)) with c = gamma log2(e) and the norms
# of the unsplit f32 values, after both operands are shifted by the mean of
# the second one's rows (K depends on x - z alone; ``ops.split_shift``).
# Past the width their shared memory holds whole, the kernels sum the
# products over depth slices of ``slab`` columns in order
# (``ops.split_tile_plan``).  The functions below emulate that arithmetic
# for the tests; nothing on the main path runs them.  ``passes=1`` keeps
# hi_x.hi_z alone (1xTF32), the control that must miss the reference's
# tolerance.

def tf32_rna(x):
    """Round float32 to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero: add 0x1000 to the bit pattern and clear its low 13
    bits (``cvt.rna.tf32.f32``)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    """(hi, lo) with hi = tf32(x) and lo = tf32(x - hi)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def dot_tf32_emul(X, Y, passes=3, slab=None):
    """X Y^T in split-TF32 (``passes=3``) or 1xTF32 (``passes=1``); with
    ``slab``, the small products and hi.hi each summed over depth slices of
    ``slab`` columns in order, then added."""
    if passes not in (1, 3):
        raise ValueError(f"passes is 1 or 3, got {passes}")
    xh, xl = split_tf32(X)
    yh, yl = split_tf32(Y)
    if passes == 1:
        return xh @ yh.mT
    if slab is None:
        return xl @ yh.mT + xh @ yl.mT + xh @ yh.mT
    small = big = 0.0
    for k0 in range(0, X.shape[-1], slab):
        k = slice(k0, k0 + slab)
        small = small + (xl[..., k] @ yh[..., k].mT + xh[..., k] @ yl[..., k].mT)
        big = big + xh[..., k] @ yh[..., k].mT
    return small + big


def kermat_tf32_emul(X, Y, *, kind="rbf", gamma=1.0, degree=3, coef0=0.0,
                     passes=3, slab=None):
    """Plain emulation of the ``kermat`` kernel's arithmetic."""
    X, Y = _shifted(X, Y, kind)
    g = dot_tf32_emul(X, Y, passes, slab)
    if kind == "linear":
        return g
    if kind == "poly":
        return (gamma * g + coef0) ** degree
    c = gamma * math.log2(math.e)
    ax = -c * torch.sum(X.float() ** 2, -1)[..., :, None]
    bz = -c * torch.sum(Y.float() ** 2, -1)[..., None, :]
    return torch.exp2(torch.clamp(2 * c * g + (ax + bz), max=0.0))


def cd_column_update_tf32_emul(X, y, Xb, w, *, passes=3, **kw):
    """Plain emulation of the ``cd_column_update`` kernel's arithmetic."""
    return y * (kermat_tf32_emul(X, Xb, passes=passes, **kw) @ w)


def kernel_matvec_tf32_emul(X, Z, v, *, passes=3, **kw):
    """Plain emulation of the ``kernel_matvec`` kernel's arithmetic."""
    k = kermat_tf32_emul(X, Z, passes=passes, **kw)
    return (k @ v.float()[..., None])[..., 0]


def kmeans_assign_tf32_emul(X, Xm, W, s, *, gamma=1.0, passes=3,
                            gram_passes=3, slab=None):
    """Plain emulation of the ``kmeans_assign`` kernel's arithmetic: K from
    the split Gram of X and Xm shifted by Xm's mean (``gram_passes``), then
    K W with K and W split again (``passes``), scores ``-2 K W + s`` and
    their row argmin.  Returns (assign, scores)."""
    k = kermat_tf32_emul(X, Xm, kind="rbf", gamma=gamma, passes=gram_passes,
                         slab=slab)
    scores = -2.0 * dot_tf32_emul(k, W.float().mT, passes) + s.float()
    return torch.argmin(scores, dim=-1), scores


def _attention_probs(q, k, *, causal, q_offset):
    """softmax(q k^T / sqrt(hd)) in f32, (B, Hkv, G, Sq, Sk), query head
    h = kv head * G + g, the causal fill -1e30."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        mask = qpos[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(mask, s, -1e30)
    return torch.softmax(s, dim=-1)


def _attend(p, v):
    B, Hkv, G, Sq, _ = p.shape
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Sq, Hkv * G, v.shape[-1])


def flash_attention_ref(q, k, v, *, causal=True, q_offset=0):
    """Naive softmax attention in f32 (the oracle of ``flash_attention``).

    q (B, Sq, Hq, hd) with k, v (B, Sk, Hkv, hd), query head h attending kv
    head h // (Hq // Hkv).  Under the causal mask query row i sits at
    position q_offset + i and masked scores are -1e30.  Returns q's shape
    and dtype."""
    p = _attention_probs(q, k, causal=causal, q_offset=q_offset)
    return _attend(p, v).to(q.dtype)


# The bf16 flash kernel rounds p to bf16 before P.V (as the model's plain
# attention does) and its output to bf16.  With u = 2^-8, bf16's unit
# roundoff, its distance from the f32 plain output o is bounded elementwise
# by u |o| for the output's rounding, doubled for the f32 sums that differ
# in order, plus u (softmax(s) . |v|) for p's rounding, plus an absolute
# 1e-4 for outputs near 0.  l sums the f32 p, so p's rounding adds nothing
# to it.
FLASH_BF16_REL, FLASH_BF16_P, FLASH_BF16_ATOL = 2.0 ** -7, 2.0 ** -8, 1e-4
# the bf16 kernel's key tile by head dim (csrc/flash_attention.cu)
FLASH_BF16_BK = {64: 128, 128: 128, 256: 64}


def flash_bf16_bound(q, k, v, *, causal=True, q_offset=0):
    """(o, sv): the f32 plain output on these inputs and softmax(s) . |v|,
    the two sides of the bf16 kernel's bound (``flash_bf16_share``)."""
    p = _attention_probs(q, k, causal=causal, q_offset=q_offset)
    return _attend(p, v), _attend(p, v.float().abs())


def flash_bf16_share(got, want, sv):
    """Worst share, over the elements, of the bound |got - want| <=
    2^-7 |want| + 2^-8 sv + 1e-4 (sv from ``flash_bf16_bound``): at most 1
    when ``got`` is within it."""
    tol = FLASH_BF16_REL * want.float().abs() + FLASH_BF16_P * sv + FLASH_BF16_ATOL
    return float(((got.float() - want.float()).abs() / tol).max())


def flash_attention_bf16_emul(q, k, v, *, causal=True, q_offset=0, bk=None):
    """Plain tiled emulation of the bf16 flash kernel's arithmetic (for the
    tests; nothing on the main path runs it): an online softmax over key
    tiles of ``bk`` (the kernel's, by default) in the log2 domain with the
    scale folded in, the f32 p summed into l, p rounded to bf16 before
    P.V with f32 accumulation, acc / max(l, 1e-30) cast to q's dtype."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    bk = bk or FLASH_BF16_BK[hd]
    c = math.log2(math.e) / math.sqrt(hd)
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]       # (B, Hkv, 1, Sk, hd)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    qpos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full(qf.shape[:-1], -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, Sk, bk):
        s = qf @ kf[..., k0:k0 + bk, :].mT
        if causal:
            kpos = k0 + torch.arange(s.shape[-1], device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1) * c)
        p = torch.exp2(s * c - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        acc = (acc * corr[..., None]
               + p.to(torch.bfloat16).float() @ vf[..., k0:k0 + bk, :])
        m = m_new
    o = acc / l.clamp(min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)
