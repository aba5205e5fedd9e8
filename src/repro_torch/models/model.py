"""Model dispatch (port of ``repro.models.model``): the decoder-only LM;
the encoder-decoder branch raises ``NotImplementedError`` (ROADMAP A20)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import lm as LM

Tensor = torch.Tensor


def _no_enc_dec(cfg) -> None:
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder model is not ported yet "
            "(ROADMAP A20)")


def build_decls_any(cfg):
    _no_enc_dec(cfg)
    return LM.build_decls(cfg)


def forward_prefill(cfg, params, batch: Dict[str, Tensor], S_max: int, *,
                    chunk: int = 1024, use_kernels: Optional[bool] = None
                    ) -> Tuple[Tensor, Dict[str, Any]]:
    """Prefill program: a full-sequence forward that returns the
    last-position logits (B, 1, V) and the per-layer K/V (``S_max`` is the
    decode depth; the LM's cache is prompt-long, as in the reference)."""
    _no_enc_dec(cfg)
    if "prefix_embeds" in batch:
        raise NotImplementedError("prefix embeddings (VLM) are not ported "
                                  "yet (ROADMAP A20)")
    logits, cache = LM.forward(cfg, params, batch["tokens"], chunk=chunk,
                               mode="prefill", use_kernels=use_kernels)
    return logits[:, -1:], cache


def cache_decls_any(cfg, B: int, S_max: int):
    _no_enc_dec(cfg)
    return LM.cache_decls(cfg, B, S_max)


def decode_step_any(cfg, params, cache, tokens: Tensor, pos: int):
    _no_enc_dec(cfg)
    return LM.decode_step(cfg, params, cache, tokens, pos)
