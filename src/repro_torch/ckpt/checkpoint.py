"""Atomic, keep-K checkpoints of nested tensors (port of
``repro.ckpt.checkpoint``).

* Atomic publish: a step is written to a temporary name and moved into
  place with ``os.replace``, so a crash mid-save never leaves a torn
  checkpoint; the manifest is published the same way.
* Keep-K rotation and a ``manifest.json`` of the kept steps: a restart
  finds the newest complete step with no coordinator.
* Device-agnostic files: leaves are stored as numpy arrays in an ``.npz``
  and placed on ``device`` when restored.
* Async save: the device-to-host copy happens inside ``save``; only the
  serialisation runs on a background thread.

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or scalars (``None`` is an empty subtree; any other object is a
leaf).  Each leaf is stored under its path written as
``jax.tree_util.keystr`` writes it (``['alpha']``, ``['a'][0]``), so a
file written by either package restores in the other.  Dtypes numpy
cannot hold (bf16, fp8) are stored as float32.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike


def _paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in the reference's flattening order: dict
    keys sorted, sequences in order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _paths(tree[k], f"{prefix}[{k!r}]")
        return out
    if type(tree) in (list, tuple):
        out = []
        for i, v in enumerate(tree):
            out += _paths(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf that later writes to ``leaf`` cannot reach."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.is_floating_point() and t.dtype not in (
                torch.float16, torch.float32, torch.float64):
            t = t.float()                            # bf16, fp8
        # a synchronous copy: a CPU tensor is copied too, and a CUDA copy
        # has landed before the writer thread can read it
        arr = t.to("cpu", copy=True).numpy()
    else:
        arr = np.array(leaf, copy=True)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _paths(tree)}


def save_pytree(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)


def _cast(arr: np.ndarray, like):
    """``arr`` in the type of the target leaf ``like``: a tensor of its
    dtype (on the CPU; a meta tensor may stand in for shape and dtype), a
    numpy array of its dtype, else numpy as stored."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(like.dtype)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return arr


def _rebuild(target, values: Dict[str, Any], prefix: str = ""):
    if target is None:
        return None
    if isinstance(target, dict):
        return {k: _rebuild(target[k], values, f"{prefix}[{k!r}]")
                for k in target}
    if type(target) in (list, tuple):
        return type(target)(_rebuild(v, values, f"{prefix}[{i}]")
                            for i, v in enumerate(target))
    return values[prefix]


def load_pytree(path: str, target) -> Any:
    """Load into the structure of ``target``: each leaf's stored array cast
    to the target leaf's dtype (tensor leaves come back as CPU tensors)."""
    with np.load(path, allow_pickle=False) as data:
        values = {key: _cast(data[key], like) for key, like in _paths(target)}
    return _rebuild(target, values)


def _to(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_to(v, device) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- paths -------------------------------------------------------------
    def _step_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}.npz")

    def _manifest(self) -> str:
        return os.path.join(self.dir, "manifest.json")

    def steps(self) -> List[int]:
        if not os.path.exists(self._manifest()):
            return []
        with open(self._manifest()) as f:
            return sorted(json.load(f)["steps"])

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save --------------------------------------------------------------
    def save(self, step: int, tree, blocking: Optional[bool] = None) -> None:
        """Save ``tree`` as ``step``.  The host copy is taken here; with
        ``async_save`` and not ``blocking`` the file is written by a
        background thread (one save in flight at a time: ``wait``)."""
        self.wait()
        host_tree = _flatten(tree)

        def work():
            tmp = os.path.join(self.dir, f".tmp_{step}.npz")
            np.savez(tmp, **host_tree)
            os.replace(tmp, self._step_path(step))
            steps = sorted([s for s in self.steps() if s != step] + [step])
            cut = max(0, len(steps) - self.keep)
            dropped, steps = steps[:cut], steps[cut:]
            with open(self._manifest() + ".tmp", "w") as f:
                json.dump({"steps": steps, "time": time.time()}, f)
            os.replace(self._manifest() + ".tmp", self._manifest())
            for s in dropped:
                try:
                    os.remove(self._step_path(s))
                except FileNotFoundError:
                    pass

        if self.async_save and not blocking:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore -----------------------------------------------------------
    def restore(self, target, step: Optional[int] = None,
                device: DeviceLike = None) -> Any:
        """The tree of ``step`` (default: the latest) in ``target``'s
        structure and dtypes; tensor leaves on ``device`` (default: the
        CPU)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        tree = load_pytree(self._step_path(step), target)
        if device is not None:
            tree = _to(tree, torch.device(device))
        return tree
