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


def swiss_roll(seed, n: int, d: int = 3, noise: float = 0.05):
    """The classic manifold; dimensions past 3 are small noise.  Labels
    are the roll angle's quartile (for the KNN-classifier metric).

    Returns (x (n, d) float32, labels (n,) int64) as numpy arrays."""
    rng = np.random.default_rng(seed)
    u_t = rng.random(n, dtype=np.float32)
    u_h = rng.random(n, dtype=np.float32)
    e = rng.standard_normal((n, 3), dtype=np.float32)
    pad = rng.standard_normal((n, d - 3), dtype=np.float32) if d > 3 else None
    return swiss_roll_from(u_t, u_h, e, pad, noise)


def swiss_roll_from(u_t, u_h, e, pad, noise: float):
    """The swiss roll of given draws: u_t, u_h (n,) uniform in [0, 1),
    e (n, 3) and pad (n, d - 3) or None standard normal, all float32; the
    formula is the JAX package's, in float32."""
    t = 1.5 * np.pi * (1 + 2 * u_t)
    h = 21 * u_h
    x = np.stack([t * np.cos(t), h, t * np.sin(t)], axis=1) + noise * e
    if pad is not None:
        x = np.concatenate([x, 0.01 * pad], axis=1)
    labels = np.clip((t - t.min()) / (t.max() - t.min()) * 4, 0, 3)
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
