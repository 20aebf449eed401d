"""Edge weights for the KNN graph (paper Eqn 1-2, the t-SNE scheme).

sigma_i is calibrated per node so the conditional distribution p_{.|i}
over its K neighbors has the target perplexity: a fixed-count bisection
on beta_i = 1/(2 sigma_i^2), all rows at once.  Symmetrization
w_ij = (p_{j|i} + p_{i|j}) / 2N looks up i inside knn(j) for every
directed edge, a (tile, K, K) gather + compare per row tile.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def calibrate_p(knn_sqdist: torch.Tensor, perplexity: float,
                iters: int = 64) -> torch.Tensor:
    """Row-stochastic p_{j|i} (N, K) at the target perplexity (Eqn 1)."""
    d2 = knn_sqdist.float()
    d2 = d2 - d2.min(dim=1, keepdim=True).values          # stability shift
    target = torch.log(torch.tensor(perplexity, dtype=torch.float32))

    def entropy(beta):
        logits = -beta[:, None] * d2
        logz = torch.logsumexp(logits, dim=1)
        p = torch.exp(logits - logz[:, None])
        return logz + beta * (p * d2).sum(1), p

    n = d2.shape[0]
    lo = torch.zeros(n, device=d2.device)
    hi = torch.full((n,), 1e5, device=d2.device) / d2.mean(1).clamp_min(1e-8)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_flat = entropy(mid)[0] > target       # entropy high -> raise beta
        lo = torch.where(too_flat, mid, lo)
        hi = torch.where(too_flat, hi, mid)
    return entropy(0.5 * (lo + hi))[1]


def symmetrize(knn_idx: torch.Tensor, p: torch.Tensor, *,
               tile: int = ops.SYMMETRIZE_TILE) -> torch.Tensor:
    """w_ij = (p_{j|i} + p_{i|j}) / (2N) per directed edge slot (Eqn 2)."""
    N = knn_idx.shape[0]
    rev = torch.empty_like(p)
    for t0 in range(0, N, tile):
        rows = torch.arange(t0, min(t0 + tile, N), device=p.device)
        nbrs = knn_idx[rows].long()                        # (T, K)
        hit = knn_idx[nbrs] == rows[:, None, None]         # knn(j) == i
        rev[t0:t0 + tile] = torch.where(hit, p[nbrs], 0.0).sum(-1)
    return (p + rev) / (2.0 * N)


def edge_weights(knn_idx, knn_sqdist, perplexity: float, *,
                 iters: int = 64) -> torch.Tensor:
    return symmetrize(knn_idx, calibrate_p(knn_sqdist, perplexity, iters))


def perplexity_of(p: torch.Tensor) -> torch.Tensor:
    """Realized perplexity per row (for validation)."""
    plogp = torch.where(p > 0, p * torch.log(p), torch.zeros_like(p))
    return torch.exp(-plogp.sum(1))
