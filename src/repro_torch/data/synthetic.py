"""Deterministic synthetic datasets (port of ``repro.data.synthetic``).

The generators have the structure of the reference's: multi-modal
class-conditional Gaussian mixtures in [0, 1]^d with label noise.  They
draw from a ``numpy.random.Generator``, so they give other numbers than the
reference's ``jax.random`` draws from the same seed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def gaussian_mixture(rng: np.random.Generator, n: int, d: int = 10,
                     modes_per_class: int = 8, spread: float = 0.18,
                     label_noise: float = 0.0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Each class is a mixture of ``modes_per_class`` Gaussians in [0,1]^d.
    Returns float32 X (n, d) and labels y in {-1, +1}."""
    centers = rng.uniform(size=(2 * modes_per_class, d))
    mode = rng.integers(0, 2 * modes_per_class, size=n)
    X = centers[mode] + spread * rng.standard_normal((n, d), dtype=np.float32)
    y = np.where(mode < modes_per_class, 1.0, -1.0)
    if label_noise > 0:
        flip = rng.uniform(size=n) < label_noise
        y = np.where(flip, -y, y)
    return np.clip(X, 0.0, 1.0).astype(np.float32), y.astype(np.float32)


def gaussian_mixture_multiclass(rng: np.random.Generator, n: int,
                                n_classes: int = 3, d: int = 10,
                                modes_per_class: int = 4, spread: float = 0.12
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Multiclass analogue of ``gaussian_mixture``: class c is a mixture of
    ``modes_per_class`` Gaussians.  Returns float32 X (n, d) and int32
    labels 0..n_classes-1 (the one-vs-all workload)."""
    centers = rng.uniform(size=(n_classes * modes_per_class, d))
    mode = rng.integers(0, n_classes * modes_per_class, size=n)
    X = centers[mode] + spread * rng.standard_normal((n, d), dtype=np.float32)
    y = mode // modes_per_class
    return np.clip(X, 0.0, 1.0).astype(np.float32), y.astype(np.int32)


def covtype_like(rng: np.random.Generator, n: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Stand-in for covtype: 54-dim, 16 modes per class, spread 0.12,
    2% label noise."""
    return gaussian_mixture(rng, n, d=54, modes_per_class=16, spread=0.12,
                            label_noise=0.02)


def webspam_like(rng: np.random.Generator, n: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Stand-in for webspam: 254-dim, 10 modes per class, spread 0.10, with
    about 70% of coordinates zeroed (webspam's features are sparse)."""
    X, y = gaussian_mixture(rng, n, d=254, modes_per_class=10, spread=0.10)
    keep = rng.uniform(size=X.shape) < 0.3
    return (X * keep).astype(np.float32), y


def train_test_split(rng: np.random.Generator, X, y, test_frac: float = 0.2):
    """Random split; the training side gets round(n * (1 - test_frac))."""
    n = X.shape[0]
    perm = rng.permutation(n)
    nt = int(round(n * (1.0 - test_frac)))
    tr, te = perm[:nt], perm[nt:]
    return X[tr], y[tr], X[te], y[te]
