"""Edge weights for the KNN graph (paper Eqn 1-2, the t-SNE scheme).

sigma_i is calibrated per node so the conditional distribution p_{.|i}
over its K neighbors has the target perplexity: a fixed-count bisection
on beta_i = 1/(2 sigma_i^2), all rows at once.  Symmetrization
w_ij = (p_{j|i} + p_{i|j}) / 2N looks up i inside knn(j) for every
directed edge, a (tile, K, K) gather + compare per row tile.

On the data mesh (``calibrate_p_sharded``, ``symmetrize_sharded``,
``edge_weights_sharded``) each rank computes its own block of rows in the
layout of ``runtime/sharding.py`` and the blocks are all-gathered.  Every
operation is row-local (a reduction along a row, or a lookup in the
global graph and p table every rank holds), so the weights are bitwise
the single-device ones at every shard count.
"""
from __future__ import annotations

import torch

from repro_torch.runtime import autotune
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.fault_tolerance import fire_per_shard


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
               tile: int | None = None) -> torch.Tensor:
    """w_ij = (p_{j|i} + p_{i|j}) / (2N) per directed edge slot (Eqn 2).

    ``tile`` rows are looked up at a time; each row's sum is its own, so
    the tile moves only memory and speed, and None asks the tuner
    (legacy 4096)."""
    N, K = knn_idx.shape
    if tile is None:
        tile = autotune.get("symmetrize", dict(n=N, k=K),
                            autotune.legacy_default("symmetrize"),
                            backend=knn_idx.device.type)["tile"]
    return (p + _reverse_rows(knn_idx, p, 0, N, tile)) / (2.0 * N)


def _reverse_rows(knn_idx, p, r0: int, r1: int, tile: int) -> torch.Tensor:
    """p_{i|j} for every edge (i, j = knn[i][k]) of rows [r0, r1), looked
    up ``tile`` rows at a time in the global graph and p table."""
    rev = torch.empty((r1 - r0, p.shape[1]), dtype=p.dtype, device=p.device)
    for t0 in range(r0, r1, tile):
        rows = torch.arange(t0, min(t0 + tile, r1), device=p.device)
        nbrs = knn_idx[rows].long()                        # (T, K)
        hit = knn_idx[nbrs] == rows[:, None, None]         # knn(j) == i
        rev[t0 - r0:t0 - r0 + tile] = torch.where(hit, p[nbrs], 0.0).sum(-1)
    return rev


def edge_weights(knn_idx, knn_sqdist, perplexity: float, *,
                 iters: int = 64) -> torch.Tensor:
    return symmetrize(knn_idx, calibrate_p(knn_sqdist, perplexity, iters))


def perplexity_of(p: torch.Tensor) -> torch.Tensor:
    """Realized perplexity per row (for validation)."""
    plogp = torch.where(p > 0, p * torch.log(p), torch.zeros_like(p))
    return torch.exp(-plogp.sum(1))


def calibrate_p_sharded(knn_sqdist, perplexity: float, *, iters: int = 64,
                        mesh, fault=None) -> torch.Tensor:
    """:func:`calibrate_p` a row block a rank, then all-gathered: (N, K),
    the same on every rank.  Padded rows (zero distances) bisect
    harmlessly and are sliced off.  ``fault`` fires the per-shard
    ``calibrate_shard:<s>`` sites first (``ShardFailedError``, stage
    ``"calibrate"``)."""
    fire_per_shard(fault, "calibrate_shard", mesh.size, stage="calibrate")
    p_loc = calibrate_p(sh.shard_rows(knn_sqdist, mesh), perplexity, iters)
    return mesh.all_gather(p_loc)[:knn_sqdist.shape[0]]


def symmetrize_sharded(knn_idx, p, *, mesh, tile: int | None = None,
                       fault=None) -> torch.Tensor:
    """:func:`symmetrize` a row block a rank: each rank looks its rows'
    reverse weights up in the global graph and p table, and the blocks
    are all-gathered.  ``fault`` fires the per-shard
    ``symmetrize_exchange:<s>`` sites first (``ShardFailedError``, stage
    ``"symmetrize"``)."""
    N, K = knn_idx.shape
    n_loc = sh.rows_per_shard(N, mesh.size)
    if tile is None:
        tile = autotune.get("symmetrize", dict(n=N, k=K),
                            autotune.legacy_default("symmetrize"),
                            backend=knn_idx.device.type)["tile"]
    fire_per_shard(fault, "symmetrize_exchange", mesh.size,
                   stage="symmetrize")
    lo = mesh.rank * n_loc
    hi = min(lo + n_loc, N)
    w = torch.zeros((n_loc, K), dtype=p.dtype, device=p.device)
    if hi > lo:
        rev = _reverse_rows(knn_idx, p, lo, hi, int(min(tile, n_loc)))
        w[:hi - lo] = (p[lo:hi] + rev) / (2.0 * N)
    return mesh.all_gather(w)[:N]


def edge_weights_sharded(knn_idx, knn_sqdist, perplexity: float, *,
                         iters: int = 64, mesh, fault=None) -> torch.Tensor:
    """Calibration and symmetrization on the data mesh, bitwise
    :func:`edge_weights`; ``fault`` reaches both stages' sites."""
    p = calibrate_p_sharded(knn_sqdist, perplexity, iters=iters, mesh=mesh,
                            fault=fault)
    return symmetrize_sharded(knn_idx, p, mesh=mesh, fault=fault)
