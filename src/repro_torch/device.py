"""Device and dtype policy of the port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Asking for ``cuda`` on a machine without a GPU raises: nothing falls back
to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_tensor(a, device: torch.device, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """Array-like -> tensor on ``device`` (``dtype`` kept when None)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    t = torch.as_tensor(a)
    return t.to(device=device, dtype=dtype or t.dtype)
