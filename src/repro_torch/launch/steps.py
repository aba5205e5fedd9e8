"""Serve steps (port of ``repro.launch.steps``' serve builders).

``build_prefill`` and ``build_decode`` return plain callables: the
reference's jit, shardings and buffer donation have no counterpart on one
card in eager PyTorch.  The train step waits for ROADMAP A20.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import model as M

Tensor = torch.Tensor


def build_prefill(cfg, chunk: int = 1024, use_kernels: Optional[bool] = None
                  ) -> Callable[[Dict[str, Any], Dict[str, Tensor]],
                                Tuple[Tensor, Dict[str, Any]]]:
    """prefill(params, {"tokens": (B, S)}) -> (last-position logits
    (B, 1, V), per-layer K/V of the prompt)."""
    def prefill_step(params, batch):
        return M.forward_prefill(cfg, params, batch,
                                 S_max=batch["tokens"].shape[1], chunk=chunk,
                                 use_kernels=use_kernels)
    return prefill_step


def greedy(logits: Tensor) -> Tensor:
    """The next token of each row, (B, 1) int32: the argmax of the last
    position's logits in their own dtype (the first index on ties, as
    ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]


def build_decode(cfg) -> Callable[..., Tuple[Tensor, Dict[str, Any]]]:
    """step(params, cache, tokens (B, 1), pos) -> (next tokens (B, 1)
    int32, cache); the cache is updated in place."""
    def serve_step(params, cache, tokens, pos):
        logits, cache = M.decode_step_any(cfg, params, cache, tokens, pos)
        return greedy(logits), cache
    return serve_step
