"""Deterministic synthetic datasets (port of ``repro.data.synthetic``).

The generators have the structure of the reference's: multi-modal
class-conditional Gaussian mixtures in [0, 1]^d with label noise, an
imbalanced mixture (weighted C-SVC), a contaminated one (one-class SVM),
regression targets (epsilon-SVR) and two 2-D stress tests.  They draw from
a ``numpy.random.Generator``, so they give other numbers than the
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


def gaussian_mixture_imbalanced(rng: np.random.Generator, n: int,
                                d: int = 10, modes_per_class: int = 4,
                                spread: float = 0.15, pos_frac: float = 0.05
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Imbalanced binary mixture: the +1 class is a ~``pos_frac`` minority
    drawn from its own Gaussian modes (the weighted C-SVC workload; split
    it with ``stratified_split``)."""
    centers = rng.uniform(size=(2 * modes_per_class, d))
    is_pos = rng.uniform(size=n) < pos_frac
    mode = rng.integers(0, modes_per_class, size=n)
    mode = np.where(is_pos, mode, mode + modes_per_class)
    X = centers[mode] + spread * rng.standard_normal((n, d), dtype=np.float32)
    y = np.where(is_pos, 1.0, -1.0)
    return np.clip(X, 0.0, 1.0).astype(np.float32), y.astype(np.float32)


def gaussian_with_outliers(rng: np.random.Generator, n: int, d: int = 6,
                           modes: int = 3, spread: float = 0.06,
                           outlier_frac: float = 0.05
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Anomaly-detection mixture: inliers from ``modes`` tight Gaussians
    (centers inside [0.25, 0.75]^d), outliers uniform over [0, 1]^d.
    Labels are +1 (inlier) / -1 (outlier), for evaluation only: the
    one-class SVM trains without them."""
    centers = rng.uniform(size=(modes, d)) * 0.5 + 0.25
    is_out = rng.uniform(size=n) < outlier_frac
    mode = rng.integers(0, modes, size=n)
    Xin = centers[mode] + spread * rng.standard_normal((n, d),
                                                       dtype=np.float32)
    Xout = rng.uniform(size=(n, d))
    X = np.where(is_out[:, None], Xout, Xin)
    y = np.where(is_out, -1.0, 1.0)
    return X.astype(np.float32), y.astype(np.float32)


def sinc1d(rng: np.random.Generator, n: int, noise: float = 0.05,
           x_range: Tuple[float, float] = (-3.0, 3.0)
           ) -> Tuple[np.ndarray, np.ndarray]:
    """1-D sinc regression y = sin(pi x)/(pi x) + noise."""
    X = rng.uniform(x_range[0], x_range[1], size=(n, 1))
    y = np.sinc(X[:, 0]) + noise * rng.standard_normal(n)
    return X.astype(np.float32), y.astype(np.float32)


def friedman1(rng: np.random.Generator, n: int, d: int = 10,
              noise: float = 0.1, standardize: bool = True
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Friedman #1: x ~ U[0,1]^d (d >= 5; coordinates past the fifth are
    distractors) and y = 10 sin(pi x1 x2) + 20 (x3 - 1/2)^2 + 10 x4 + 5 x5
    + noise; ``standardize`` rescales y to zero mean and unit variance."""
    if d < 5:
        raise ValueError(f"friedman1 needs d >= 5, got {d}")
    X = rng.uniform(size=(n, d))
    y = (10.0 * np.sin(np.pi * X[:, 0] * X[:, 1])
         + 20.0 * (X[:, 2] - 0.5) ** 2 + 10.0 * X[:, 3] + 5.0 * X[:, 4])
    y = y + noise * rng.standard_normal(n)
    if standardize:
        y = (y - y.mean()) / max(y.std(), 1e-8)
    return X.astype(np.float32), y.astype(np.float32)


def checkerboard(rng: np.random.Generator, n: int, cells: int = 4,
                 noise: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """2-D checkerboard: no linear model beats chance."""
    X = rng.uniform(size=(n, 2))
    ix = np.floor(X[:, 0] * cells).astype(np.int64)
    iy = np.floor(X[:, 1] * cells).astype(np.int64)
    y = np.where((ix + iy) % 2 == 0, 1.0, -1.0)
    X = X + noise * rng.standard_normal((n, 2))
    return X.astype(np.float32), y.astype(np.float32)


def two_spirals(rng: np.random.Generator, n: int, noise: float = 0.05,
                turns: float = 1.75) -> Tuple[np.ndarray, np.ndarray]:
    """Two interleaved spirals scaled into about [0, 1]^2 (2 * (n // 2)
    points)."""
    m = n // 2
    t = np.sqrt(rng.uniform(size=m)) * turns * 2 * np.pi
    r = t / (turns * 2 * np.pi)
    x1 = np.stack([r * np.cos(t), r * np.sin(t)], 1)
    X = np.concatenate([x1, -x1], 0) + noise * rng.standard_normal((2 * m, 2))
    y = np.concatenate([np.ones(m), -np.ones(m)])
    X = (X + 1.2) / 2.4
    return X.astype(np.float32), y.astype(np.float32)


def train_test_split(rng: np.random.Generator, X, y, test_frac: float = 0.2):
    """Random split; the training side gets round(n * (1 - test_frac))."""
    n = X.shape[0]
    perm = rng.permutation(n)
    nt = int(round(n * (1.0 - test_frac)))
    tr, te = perm[:nt], perm[nt:]
    return X[tr], y[tr], X[te], y[te]


def stratified_split(rng: np.random.Generator, X, y, test_frac: float = 0.2):
    """Per-class split: each label keeps about ``test_frac`` of its points
    in the test set (at least one in training), so a small minority stays
    on both sides; both sides are shuffled."""
    y_np = np.asarray(y)
    tr_parts, te_parts = [], []
    for label in np.unique(y_np):
        idx = np.nonzero(y_np == label)[0]
        perm = rng.permutation(len(idx))
        nt = max(1, int(len(idx) * (1.0 - test_frac)))
        tr_parts.append(idx[perm[:nt]])
        te_parts.append(idx[perm[nt:]])
    tr = np.concatenate(tr_parts)
    te = np.concatenate(te_parts)
    tr, te = tr[rng.permutation(len(tr))], te[rng.permutation(len(te))]
    return X[tr], y[tr], X[te], y[te]
