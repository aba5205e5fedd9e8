"""What every comparison solver shares: its inputs on the device, the
signed dual matrix, the default draws and the fit's clock."""
from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from repro_torch.core.kernels import resolve_use_kernels
from repro_torch.device import DeviceLike, as_tensor, resolve_device


def prepare(X, y, device: DeviceLike, dtype: torch.dtype,
            use_kernels: Optional[bool]
            ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """(X, y) on ``device`` (default ``cuda``) in ``dtype``, and
    ``use_kernels`` resolved for that device (``None``: the CUDA kernels on
    a CUDA device)."""
    dev = resolve_device(device)
    X = as_tensor(X, dev, dtype).contiguous()
    y = as_tensor(y, dev, X.dtype)
    return X, y, resolve_use_kernels(use_kernels, dev)


def elapsed(t0: float, device: torch.device) -> float:
    """Seconds since ``t0`` once the device's queued work has finished
    (the reference's ``block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def signed(K: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Q = (y y') ∘ K, in place in K: with labels of +/-1, scaling the rows
    and then the columns gives the bits of the reference's product
    without two more n x n tensors."""
    return K.mul_(y[:, None]).mul_(y[None, :])


def draw_indices(n: int, b: int, seed: int) -> torch.Tensor:
    """``b`` distinct indices of ``n`` from an explicit CPU generator, where
    the reference draws ``jax.random.choice(PRNGKey(seed), n, (b,),
    replace=False)`` (pass that draw as ``init_idx`` to reproduce it)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=g)[:b]
