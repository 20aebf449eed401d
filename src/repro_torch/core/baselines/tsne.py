"""Exact symmetric SNE and t-SNE layouts (the Fig 5 / Table 2 arms).

The paper's comparison uses Barnes-Hut to reach millions of points; the
exact O(N^2) gradient is simpler and a stronger baseline at up to ~10^4
points (no tree-approximation error).  Both run full-batch gradient
descent with momentum and early exaggeration (van der Maaten's
settings) on the same weighted KNN graph LargeVis builds (paper §4.3).
The formulas are the JAX package's, the broadcast (N, N, s) squared
distances included.
"""
from __future__ import annotations

import torch


def _p_matrix(knn_idx, weights, n: int) -> torch.Tensor:
    """Dense symmetric P (n, n) from the weighted KNN graph.  The ids of a
    row are distinct, so each entry is written at most once (an empty
    slot, id -1, wraps to column n-1 as JAX's indexing does)."""
    dev = weights.device
    w = weights.float()
    w = w / w.sum().clamp_min(1e-12)
    P = torch.zeros((n, n), device=dev)
    rows = torch.arange(n, device=dev).repeat_interleave(knn_idx.shape[1])
    P[rows, knn_idx.reshape(-1).long().remainder(n)] = w.reshape(-1)
    P = 0.5 * (P + P.T)
    return (P / P.sum().clamp_min(1e-12)).clamp_min(1e-12)


def _grad(y, P, student_t: bool):
    """(gradient (n, s), KL(P || Q) as a 0-d tensor)."""
    d2 = ((y[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    num = 1.0 / (1.0 + d2) if student_t else torch.exp(-d2)
    num.fill_diagonal_(0.0)
    Q = (num / num.sum().clamp_min(1e-12)).clamp_min(1e-12)
    PQ = P - Q
    W = PQ * num if student_t else PQ
    g = 4.0 * (W.sum(1, keepdim=True) * y - W @ y)
    kl = (P * (torch.log(P) - torch.log(Q))).sum()
    return g, kl


def tsne_layout(knn_idx, weights, *, n_iter: int = 1000, lr: float = 200.0,
                momentum: float = 0.8, early_exag: float = 12.0,
                exag_iters: int = 250, student_t: bool = True,
                generator: torch.Generator | None = None, out_dim: int = 2,
                y0=None):
    """Returns (y (n, out_dim), KL every 100 iterations as floats).

    ``student_t=False`` is symmetric SNE.  ``y0`` is the start; None
    draws N(0, 1e-4^2) from ``generator``.  The KL is read to the host
    only every 100 iterations."""
    n = knn_idx.shape[0]
    dev = weights.device
    P = _p_matrix(knn_idx, weights, n)
    if y0 is None:
        y = torch.randn((n, out_dim), generator=generator, device=dev) * 1e-4
    else:
        y = torch.as_tensor(y0).to(device=dev, dtype=torch.float32)
    v = torch.zeros_like(y)
    kls = []
    for it in range(n_iter):
        Pe = P * early_exag if it < exag_iters else P
        g, kl = _grad(y, Pe, student_t)
        mom = 0.5 if it < exag_iters else momentum
        v = mom * v - lr * g
        y = y + v
        y = y - y.mean(0)
        if it % 100 == 0:
            kls.append(float(kl))
    return y, kls
