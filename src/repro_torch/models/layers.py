"""Transformer building blocks: RMSNorm, RoPE, GQA/MQA attention, gated
MLPs (port of ``repro.models.layers``).

Layer parameter groups are declared stacked over a leading layer axis, as
the reference declares them; the model indexes one layer at a time.

Full-sequence attention (train and prefill) goes through
``chunked_attention``: on a CUDA tensor it launches the hand-written flash
kernel (``kernels.ops.flash_attention``) unless the caller passes
``use_kernels=False``; otherwise it runs the reference's q-chunked plain
version.  Decode attends one token against a (B, Smax, Hkv, hd) cache with
a length mask, in plain PyTorch (the reference has no kernel for it).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.kernels import resolve_use_kernels
from repro_torch.kernels import ops
from repro_torch.models.param import ParamDecl

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# norms & RoPE
# ---------------------------------------------------------------------------

def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope_apply(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, hd), positions: (..., S).  NeoX-style half rotation in
    f32, then cast back."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., None] * freqs               # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_decls(cfg, L: int) -> Dict[str, ParamDecl]:
    D, hd = cfg.d_model, cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.n_kv
    d = {
        "wq": ParamDecl((L, D, Hq * hd), ("layers", "embed", "heads")),
        "wk": ParamDecl((L, D, Hkv * hd), ("layers", "embed", "heads")),
        "wv": ParamDecl((L, D, Hkv * hd), ("layers", "embed", "heads")),
        "wo": ParamDecl((L, Hq * hd, D), ("layers", "heads", "embed")),
    }
    if cfg.qkv_bias:
        d["bq"] = ParamDecl((L, Hq * hd), ("layers", "heads"), init="zeros")
        d["bk"] = ParamDecl((L, Hkv * hd), ("layers", "heads"), init="zeros")
        d["bv"] = ParamDecl((L, Hkv * hd), ("layers", "heads"), init="zeros")
    if cfg.qk_norm:
        d["q_scale"] = ParamDecl((L, hd), ("layers", None), init="ones")
        d["k_scale"] = ParamDecl((L, hd), ("layers", None), init="ones")
    return d


def _project_qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, Hq, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_scale"], cfg.norm_eps)
        k = rmsnorm(k, p["k_scale"], cfg.norm_eps)
    q = rope_apply(q, positions, cfg.rope_theta)
    k = rope_apply(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                      chunk: int = 1024, q_offset: int = 0,
                      use_kernels: Optional[bool] = None) -> Tensor:
    """q: (B, Sq, Hq, hd), k/v: (B, Sk, Hkv, hd) with Hq = G * Hkv.

    ``use_kernels`` None: the flash kernel on a CUDA tensor, the plain
    version on the CPU.  The plain version scans query chunks against the
    full K/V with an f32 softmax: scores are formed in the input dtype and
    cast to f32, and p is cast to v's dtype before the second product, as
    in the reference (the kernel keeps both in f32)."""
    if resolve_use_kernels(use_kernels, q.device):
        return ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, Sq)
    pad_q = (-Sq) % chunk
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    nch = (Sq + pad_q) // chunk
    qc = q.reshape(B, nch, chunk, Hkv, G, hd)
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    for i in range(nch):
        s = torch.einsum("bqkgh,bskh->bkgqs", qc[:, i], k).float() * scale
        if causal:
            qpos = q_offset + i * chunk + torch.arange(chunk, device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, -1e30)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v))
    out = torch.stack(outs, dim=1).reshape(B, Sq + pad_q, Hq, hd)
    return out[:, :Sq]


def attn_apply(p: Dict[str, Tensor], x: Tensor, cfg, positions: Tensor, *,
               causal: bool = True, chunk: int = 1024,
               use_kernels: Optional[bool] = None) -> Tensor:
    """Full-sequence attention (train)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = chunked_attention(q, k, v, causal=causal, chunk=chunk,
                            use_kernels=use_kernels)
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]


def attn_prefill(p, x, cfg, positions, *, chunk=1024, use_kernels=None):
    """Like ``attn_apply`` but also returns (k, v) for the cache."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = chunked_attention(q, k, v, causal=True, chunk=chunk,
                            use_kernels=use_kernels)
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"], (k, v)


def attn_decode(p: Dict[str, Tensor], x: Tensor, cfg, pos: int,
                cache_k: Tensor, cache_v: Tensor
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """One-token decode.  x: (B, 1, D); cache_k/v: (B, Smax, Hkv, hd); pos:
    the current position.  Writes this token's k, v into the caches at
    ``pos`` in place (the reference returns updated copies) and returns
    (out, cache_k, cache_v)."""
    B = x.shape[0]
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    cache_k[:, pos:pos + 1] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v.to(cache_v.dtype)
    qh = q.reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qh, cache_k).float() / math.sqrt(hd)
    mask = torch.arange(cache_k.shape[1], device=x.device) <= pos
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w.to(cache_v.dtype), cache_v)
    return o.reshape(B, 1, Hq * hd) @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_decls(cfg, L: int, d_ff: Optional[int] = None) -> Dict[str, ParamDecl]:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w1": ParamDecl((L, D, Fd), ("layers", "embed", "mlp")),
            "w3": ParamDecl((L, D, Fd), ("layers", "embed", "mlp")),
            "w2": ParamDecl((L, Fd, D), ("layers", "mlp", "embed")),
        }
    return {   # plain gelu (whisper)
        "w1": ParamDecl((L, D, Fd), ("layers", "embed", "mlp")),
        "b1": ParamDecl((L, Fd), ("layers", "mlp"), init="zeros"),
        "w2": ParamDecl((L, Fd, D), ("layers", "mlp", "embed")),
        "b2": ParamDecl((L, D), ("layers", None), init="zeros"),
    }


def _gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def mlp_apply(p: Dict[str, Tensor], x: Tensor, cfg) -> Tensor:
    if cfg.mlp in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp == "swiglu" else _gelu
        return (act(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
    return _gelu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
