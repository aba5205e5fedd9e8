"""Parameter declaration trees (port of ``repro.models.param``).

A model's parameters are declared once as a nested dict of ``ParamDecl``
leaves (shape, logical axes, initializer).  ``init_tree`` materialises them
on one device, ``zeros`` allocates a tree of zeros and ``count_params``
counts without allocating.  The port runs on one card, so there are no
mesh, sharding or abstract trees.  A leaf's ``dtype`` is a string
(``"bfloat16"``); ``torch_dtype`` is the one place that maps it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; one of {sorted(DTYPES)}")


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis name per dim
    init: str = "fan_in"                     # fan_in|zeros|ones|normal|embed
    scale: Optional[float] = None            # stddev override
    dtype: Optional[str] = None              # None -> param dtype at init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of a tree of nested dicts (keys sorted, the
    order ``jax.tree_util`` flattens dicts in)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _init_one(decl: ParamDecl, gen: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    dt = torch_dtype(decl.dtype) if decl.dtype else dtype
    if decl.init == "zeros":
        return torch.zeros(decl.shape, dtype=dt, device=device)
    if decl.init == "ones":
        return torch.ones(decl.shape, dtype=dt, device=device)
    if decl.init in ("normal", "embed"):
        std = decl.scale if decl.scale is not None else (
            0.02 if decl.init == "normal" else 1.0)
    elif decl.init == "fan_in":
        # stddev = scale / sqrt(fan_in); fan_in = second-to-last dim
        fan_in = decl.shape[-2] if len(decl.shape) >= 2 else decl.shape[-1]
        std = (decl.scale if decl.scale is not None else 1.0) / math.sqrt(
            max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {decl.init!r}")
    x = torch.randn(decl.shape, generator=gen, device=device,
                    dtype=torch.float32)
    return (std * x).to(dt)


def init_tree(decls: Dict[str, Any], generator: torch.Generator,
              dtype: torch.dtype, device: torch.device) -> Dict[str, Any]:
    """Materialise parameters on ``device``, drawing in flattened path order
    from ``generator`` (a ``torch.Generator`` on that device).  The
    distributions are the reference's; its ``jax.random`` stream is not
    reproduced, so parity tests carry the reference's weights over
    (``convert.from_jax_lm``)."""
    return tree_map(lambda d: _init_one(d, generator, dtype, device), decls)


def zeros(decls: Dict[str, Any], dtype: torch.dtype,
          device: torch.device) -> Dict[str, Any]:
    return tree_map(lambda d: torch.zeros(
        d.shape, dtype=torch_dtype(d.dtype) if d.dtype else dtype,
        device=device), decls)


def count_params(decls: Dict[str, Any]) -> int:
    return int(sum(math.prod(d.shape) for d in leaves(decls)))
