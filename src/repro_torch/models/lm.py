"""Decoder-only LM assembly (port of ``repro.models.lm``, dense archs).

A config compiles to a ``StackPlan``: a repeating period of (mixer, ffn)
slots, ``n_periods`` deep, with parameters stacked over the period axis.
The reference scans the period; here the layers are a Python loop over the
stacked leading axis.  Only the dense period [(attn, dense)] is ported:
any other mixer or ffn, and an explicit prefix of layers, raise
``NotImplementedError`` (ROADMAP A20).

Two full-sequence modes share the slot code: "train" (a no-grad forward)
and "prefill" (the same, plus each layer's K/V for the cache);
``decode_step`` runs one token against the cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers as LY
from repro_torch.models.param import ParamDecl, torch_dtype, tree_map
from repro_torch.models.param import zeros as zeros_tree

Tensor = torch.Tensor
_TODO = "is not ported yet (ROADMAP A20)"


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    mixer: str                     # attn | mamba | mlstm | slstm
    ffn: str                       # dense | moe | none


@dataclasses.dataclass(frozen=True)
class StackPlan:
    period: Tuple[LayerPlan, ...]
    n_periods: int


def build_plan(cfg) -> StackPlan:
    if cfg.prefix_pattern:
        raise NotImplementedError(f"{cfg.name}: a layer prefix {_TODO}")
    if cfg.period_pattern is not None:
        period = tuple(LayerPlan(m, f) for m, f in cfg.period_pattern)
    else:
        period = (LayerPlan("attn", "dense"),)
    if cfg.n_layers % len(period):
        raise ValueError(f"{cfg.n_layers} layers is not a whole number of "
                         f"{len(period)}-slot periods")
    for p in period:
        if (p.mixer, p.ffn) != ("attn", "dense"):
            raise NotImplementedError(
                f"{cfg.name}: mixer {p.mixer!r} with ffn {p.ffn!r} {_TODO}")
    return StackPlan(period, cfg.n_layers // len(period))


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------

def _slot_decls(cfg, L: int) -> Dict[str, Any]:
    D = cfg.d_model
    return {"norm1": ParamDecl((L, D), ("layers", None), init="ones"),
            "attn": LY.attn_decls(cfg, L),
            "norm2": ParamDecl((L, D), ("layers", None), init="ones"),
            "mlp": LY.mlp_decls(cfg, L)}


def build_decls(cfg) -> Dict[str, Any]:
    plan = build_plan(cfg)
    D, V = cfg.d_model, cfg.vocab
    embed_axes = ("vocab", "embed") if cfg.tie_embeddings else (None, "embed")
    decls: Dict[str, Any] = {
        "embed": ParamDecl((V, D), embed_axes, init="embed", scale=D ** -0.5),
        "final_norm": ParamDecl((D,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        decls["unembed"] = ParamDecl((D, V), ("embed", "vocab"))
    decls["stack"] = {f"slot{i}": _slot_decls(cfg, plan.n_periods)
                      for i in range(len(plan.period))}
    return decls


# ---------------------------------------------------------------------------
# slot application
# ---------------------------------------------------------------------------

def apply_slot(cfg, plan: LayerPlan, p: Dict[str, Any], h: Tensor, *,
               mode: str, positions: Optional[Tensor] = None,
               pos: Optional[int] = None, state: Any = None,
               chunk: int = 1024, use_kernels: Optional[bool] = None):
    """One (attn, dense) layer.  Returns (h, new_state): None in "train",
    this layer's {"k", "v"} in "prefill", the updated cache in "decode"."""
    if (plan.mixer, plan.ffn) != ("attn", "dense"):
        raise NotImplementedError(
            f"mixer {plan.mixer!r} with ffn {plan.ffn!r} {_TODO}")
    hin = LY.rmsnorm(h, p["norm1"], cfg.norm_eps)
    new_state = None
    if mode == "train":
        mix = LY.attn_apply(p["attn"], hin, cfg, positions, chunk=chunk,
                            use_kernels=use_kernels)
    elif mode == "prefill":
        mix, (k, v) = LY.attn_prefill(p["attn"], hin, cfg, positions,
                                      chunk=chunk, use_kernels=use_kernels)
        new_state = {"k": k, "v": v}
    elif mode == "decode":
        mix, ck, cv = LY.attn_decode(p["attn"], hin, cfg, pos, state["k"],
                                     state["v"])
        new_state = {"k": ck, "v": cv}
    else:
        raise ValueError(f"unknown mode {mode!r}")
    h = h + mix
    hn = LY.rmsnorm(h, p["norm2"], cfg.norm_eps)
    return h + LY.mlp_apply(p["mlp"], hn, cfg), new_state


def _adtype(cfg) -> torch.dtype:
    return torch_dtype(cfg.activ_dtype)


def _embed(cfg, params, tokens: Tensor) -> Tensor:
    h = params["embed"][tokens]
    if cfg.embed_scale:
        # the reference multiplies by an f32 scalar, which promotes to f32
        h = h.float() * math.sqrt(cfg.d_model)
    return h.to(_adtype(cfg))


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    return tree_map(lambda a: a[i], tree)


def _logits(cfg, params, h: Tensor) -> Tensor:
    h = LY.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return h @ params["embed"].to(h.dtype).T
    return h @ params["unembed"]


@torch.no_grad()
def forward(cfg, params, tokens: Tensor, *, chunk: int = 1024,
            mode: str = "train", use_kernels: Optional[bool] = None
            ) -> Tuple[Tensor, Optional[Dict[str, Any]]]:
    """Returns (logits (B, S, V), cache or None).  tokens: (B, S).  In
    "prefill" the cache is {"stack": {"slot<i>": {"k", "v"}}} with k, v of
    shape (L, B, S, Hkv, hd)."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward mode {mode!r}: train or prefill")
    plan = build_plan(cfg)
    h = _embed(cfg, params, tokens)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device).expand(B, S)
    states: Dict[str, list] = {f"slot{i}": [] for i in range(len(plan.period))}
    for layer in range(plan.n_periods):
        for i, p_plan in enumerate(plan.period):
            h, st = apply_slot(cfg, p_plan, _layer(params["stack"][f"slot{i}"],
                                                   layer),
                               h, mode=mode, positions=positions, chunk=chunk,
                               use_kernels=use_kernels)
            if mode == "prefill":
                states[f"slot{i}"].append(st)
    cache = None
    if mode == "prefill":
        cache = {"stack": {name: {kv: torch.stack([s[kv] for s in sts])
                                  for kv in ("k", "v")}
                           for name, sts in states.items()}}
    return _logits(cfg, params, h), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def cache_decls(cfg, B: int, S_max: int) -> Dict[str, Any]:
    """Cache structure as ParamDecls: per slot, k and v of shape
    (L, B, S_max, Hkv, hd) in the activation dtype."""
    plan = build_plan(cfg)
    kv = ParamDecl((plan.n_periods, B, S_max, cfg.n_kv, cfg.hd),
                   ("layers", "batch", "kv_seq", None, None),
                   dtype=cfg.activ_dtype)
    return {"stack": {f"slot{i}": {"k": kv, "v": kv}
                      for i in range(len(plan.period))}}


def init_cache(cfg, B: int, S_max: int, device) -> Dict[str, Any]:
    return zeros_tree(cache_decls(cfg, B, S_max), _adtype(cfg),
                      torch.device(device))


@torch.no_grad()
def decode_step(cfg, params, cache: Dict[str, Any], tokens: Tensor,
                pos: int) -> Tuple[Tensor, Dict[str, Any]]:
    """One decode step.  tokens: (B, 1); pos: the current position.  Writes
    the token's K/V into ``cache`` in place and returns (logits (B, 1, V),
    cache)."""
    plan = build_plan(cfg)
    h = _embed(cfg, params, tokens)
    for layer in range(plan.n_periods):
        for i, p_plan in enumerate(plan.period):
            name = f"slot{i}"
            h, _ = apply_slot(cfg, p_plan, _layer(params["stack"][name], layer),
                              h, mode="decode", pos=int(pos),
                              state=_layer(cache["stack"][name], layer))
    return _logits(cfg, params, h), cache
