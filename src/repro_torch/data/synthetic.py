"""Synthetic datasets for tests and the smoke run: clustered high-dim data
with labels, drawn from a numpy ``Generator`` (the JAX package draws the
same shapes from threefry keys; the two streams differ)."""
from __future__ import annotations

import numpy as np


def gaussian_mixture(seed, n: int, d: int, n_clusters: int,
                     sep: float = 6.0, scale: float = 1.0):
    """Well-separated clusters on a random simplex.

    Returns (x (n, d) float32, labels (n,) int64) as numpy arrays."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)) * sep / np.sqrt(2)
    labels = rng.integers(0, n_clusters, n)
    x = centers[labels] + rng.standard_normal((n, d)) * scale
    return x.astype(np.float32), labels.astype(np.int64)


def mnist_like(seed, n: int = 4096, d: int = 784, n_classes: int = 10):
    """MNIST-shaped stand-in: class templates + structured deformation."""
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal((n_classes, d)) * 2.0
    basis = rng.standard_normal((n_classes, 8, d)) * 0.8
    labels = rng.integers(0, n_classes, n)
    coeff = rng.standard_normal((n, 8))
    x = templates[labels] + np.einsum("nk,nkd->nd", coeff, basis[labels])
    x = x + 0.3 * rng.standard_normal((n, d))
    return x.astype(np.float32), labels.astype(np.int64)
