"""Plain PyTorch versions of the hand-written kernels (their oracles).

They repeat the arithmetic of ``csrc/*.cu`` with PyTorch operators and are
what the ``ops`` wrappers run for a tensor on the CPU.  The RBF form is the
Gram expansion ``exp(-gamma * max(|x|^2 + |y|^2 - 2 x.y, 0))``.  Leading
batch dimensions broadcast like ``torch.matmul``.
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


def cd_column_update_ref(X, y, Xb, w, *, kind="rbf", gamma=1.0, degree=3,
                         coef0=0.0):
    k = kermat_ref(X, Xb, kind=kind, gamma=gamma, degree=degree, coef0=coef0)
    return y * (k @ w)


def kernel_matvec_ref(X, Z, v, *, kind="rbf", gamma=1.0, degree=3, coef0=0.0):
    k = kermat_ref(X, Z, kind=kind, gamma=gamma, degree=degree, coef0=coef0)
    return (k @ v.float()[..., None])[..., 0]


def flash_attention_ref(q, k, v, *, causal=True, q_offset=0):
    """Naive softmax attention in f32 (the oracle of ``flash_attention``).

    q (B, Sq, Hq, hd) with k, v (B, Sk, Hkv, hd), query head h attending kv
    head h // (Hq // Hkv).  Under the causal mask query row i sits at
    position q_offset + i and masked scores are -1e30.  Returns q's shape
    and dtype."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        mask = qpos[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float()).reshape(B, Sq, Hq, hd)
    return o.to(q.dtype)
