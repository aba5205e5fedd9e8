"""Serving driver for the dense LMs: batched prefill, then a greedy decode
loop (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Parameters come from ``init_tree`` with ``--seed`` and prompts from a
seeded ``torch.Generator``.  The default device is ``cuda``, where every
layer's prefill attention launches the flash kernel; asking for ``cuda``
without a GPU raises.  The timings synchronise the device before reading
the host clock; ``serve/prefill`` and ``serve/decode`` spans label the two
phases for the profiler.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_decode, build_prefill, greedy
from repro_torch.models import model as M
from repro_torch.models.lm import init_cache
from repro_torch.models.param import init_tree, torch_dtype
from repro_torch.obs.spans import span

Tensor = torch.Tensor


def init_params(cfg, seed: int, device) -> Dict[str, Any]:
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_tree(M.build_decls_any(cfg), gen, torch_dtype(cfg.param_dtype),
                     dev)


def make_prompts(cfg, batch: int, prompt_len: int, seed: int,
                 device) -> Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, prompt_len),
                         generator=gen).to(device)


def prefill(cfg, params, prompts: Tensor, S_max: int, *,
            use_kernels: Optional[bool] = None
            ) -> Tuple[Tensor, Tensor, Dict[str, Any]]:
    """Prefill the prompts: (first generated tokens (B, 1) int32,
    last-position logits (B, 1, V), the decode cache).  The cache is
    allocated ``S_max`` deep at once and the prompt's K/V written into its
    first positions (the reference pads the prompt-long cache; the values
    are the same)."""
    B, P = prompts.shape
    step = build_prefill(cfg, chunk=min(1024, P), use_kernels=use_kernels)
    logits, raw = step(params, {"tokens": prompts})
    cache = init_cache(cfg, B, S_max, prompts.device)
    for name, kv in raw["stack"].items():
        for key in ("k", "v"):
            cache["stack"][name][key][:, :, :P] = kv[key]
    return greedy(logits), logits, cache


def decode(cfg, params, cache: Dict[str, Any], tok: Tensor, pos: int,
           steps: int) -> Tensor:
    """``steps`` greedy decode steps from ``tok`` at position ``pos``:
    returns (B, steps + 1) int32, ``tok`` first."""
    step = build_decode(cfg)
    out = [tok]
    for i in range(steps):
        tok, cache = step(params, cache, tok, pos + i)
        out.append(tok)
    return torch.cat(out, dim=1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.gen < 1 or args.prompt_len < 1 or args.batch < 1:
        ap.error("--batch, --prompt-len and --gen must be positive")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    S_max = args.prompt_len + args.gen
    params = init_params(cfg, args.seed, dev)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, args.seed + 1,
                           dev)

    with span("serve/prefill"):
        _sync(dev)
        t0 = time.perf_counter()
        tok, _, cache = prefill(cfg, params, prompts, S_max)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
    with span("serve/decode"):
        t0 = time.perf_counter()
        gen = decode(cfg, params, cache, tok, args.prompt_len, args.gen - 1)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    gen = gen.cpu()
    print(f"prefill: {t_prefill*1e3:.1f} ms for {args.batch}x{args.prompt_len} tokens")
    print(f"decode: {t_decode*1e3:.1f} ms for {args.batch}x{args.gen-1} tokens "
          f"({args.batch*(args.gen-1)/max(t_decode,1e-9):.1f} tok/s)")
    print("sample generations (token ids):")
    for row in gen[:2]:
        print("  ", row[:16].tolist())


if __name__ == "__main__":
    main()
