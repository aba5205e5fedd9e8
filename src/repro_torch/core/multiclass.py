"""Multiclass one-vs-all DC-SVM with a shared partition (port of
``repro.core.multiclass``).

One-vs-all trains ``n_classes`` binary machines, class c against the rest.
The divide step looks only at X, so one partition serves every class:
``fit_ova`` stacks the per-class +/-1 label vectors into an
(n_classes, n) matrix and the shared Algorithm-1 driver solves every
class's sub-QPs of a level on the same cluster Grams.  Prediction is the
argmax over the per-class decision values (``core.predict``'s ``*_ova``
variants), including eq.-11 early serving.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.dcsvm import (DCSVMConfig, DCSVMModel, Draws,
                                    _fit_algorithm1)
from repro_torch.core.kkmeans import Partition
from repro_torch.core.tasks import CSVC
from repro_torch.device import DeviceLike, as_tensor, resolve_device


@dataclasses.dataclass
class MulticlassModel:
    config: DCSVMConfig
    X: torch.Tensor                # (n, d) training points
    classes: np.ndarray            # (n_classes,) original label values
    Y: torch.Tensor                # (n_classes, n) one-vs-all labels in {-1, +1}
    alpha: torch.Tensor            # (n_classes, n) per-class dual solutions
    partition: Optional[Partition]
    is_early: bool
    level_stats: List[Dict[str, Any]]

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    @property
    def sv_union(self) -> np.ndarray:
        """Indices with alpha > 0 in ANY class machine (serving working set)."""
        return np.nonzero((self.alpha > 0).any(dim=0).cpu().numpy())[0]

    def binary(self, c: int) -> DCSVMModel:
        """View of class c's one-vs-rest machine as a binary DCSVMModel."""
        return DCSVMModel(self.config, self.X, self.Y[c], self.alpha[c],
                          self.partition, self.is_early, self.level_stats)


def labels_to_ova(y, n_classes: Optional[int] = None,
                  dtype: torch.dtype = torch.float32, device=None):
    """(n,) labels -> (classes, (n_classes, n) +/-1 matrix).

    Without ``n_classes`` the classes are the sorted unique observed labels.
    With ``n_classes`` the labels must be integers in [0, n_classes) and the
    class set is exactly 0..n_classes-1; a class absent from ``y`` gets an
    all-negative machine."""
    y_np = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    if n_classes is None:
        classes, y_idx = np.unique(y_np, return_inverse=True)
    else:
        y_idx = y_np.astype(np.int64)
        if not np.array_equal(y_idx, y_np):
            raise ValueError("n_classes requires integer labels")
        if y_np.size and (y_idx.min() < 0 or y_idx.max() >= n_classes):
            raise ValueError(
                f"labels must lie in [0, {n_classes}); got "
                f"[{y_idx.min()}, {y_idx.max()}]")
        classes = np.arange(n_classes)
    onehot = y_idx[None, :] == np.arange(len(classes))[:, None]
    Y = torch.as_tensor(np.where(onehot, 1.0, -1.0), dtype=dtype,
                        device=device)
    return classes, Y


def ova_cost_vectors(Y: torch.Tensor, C: float, class_weight,
                     classes) -> torch.Tensor:
    """Per-class cost vectors for weighted one-vs-all: machine c's box is
    ``C * w_c`` on its positive (class-c) side and ``C`` on the rest.

    ``class_weight`` is a dict {class label: weight} (absent classes get
    1.0) or an array-like of per-class weights aligned with ``classes``."""
    n_cls = Y.shape[0]
    if isinstance(class_weight, dict):
        w = np.ones(n_cls)
        lookup = {c: i for i, c in enumerate(np.asarray(classes).tolist())}
        for label, wi in class_weight.items():
            if label not in lookup:
                raise ValueError(f"class_weight key {label!r} not in classes "
                                 f"{np.asarray(classes).tolist()}")
            w[lookup[label]] = float(wi)
    else:
        w = np.asarray(class_weight, np.float64)
        if w.shape != (n_cls,):
            raise ValueError(f"class_weight must have one weight per class "
                             f"({n_cls}), got shape {w.shape}")
    wt = torch.as_tensor(w, dtype=Y.dtype, device=Y.device)
    return C * torch.where(Y > 0, wt[:, None], 1.0)


def fit_ova(cfg: DCSVMConfig, X, y, n_classes: Optional[int] = None,
            callback=None, class_weight=None, device: DeviceLike = None,
            draws: Optional[Draws] = None) -> MulticlassModel:
    """Train one-vs-all DC-SVM on ``device`` (default ``cuda``): Algorithm 1
    with the class-stacked (n_classes, n) label matrix, through the same
    driver as binary ``fit``.  ``callback(level, alpha, stats)`` receives
    the class-stacked alpha; ``draws`` injects each level's k-means draws
    as in ``fit``.  Adaptive clustering samples from the union of the
    per-class support vectors.  ``class_weight`` upweights each machine's
    positive box (``ova_cost_vectors``)."""
    dev = resolve_device(device)
    X = as_tensor(X, dev, torch.float32).contiguous()
    classes, Y = labels_to_ova(y, n_classes, X.dtype, dev)
    td = CSVC().build(X, Y, cfg.C)
    if class_weight is not None:
        td = td._replace(Cvec=ova_cost_vectors(Y, cfg.C, class_weight,
                                               classes))
    alpha, partition, stats, is_early = _fit_algorithm1(cfg, X, td, callback,
                                                        draws)
    return MulticlassModel(cfg, X, classes, Y, alpha, partition, is_early,
                           stats)
