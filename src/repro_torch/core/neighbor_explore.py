"""Neighbor exploring (paper §3.1 step 3): "a neighbor of my neighbor is
also likely to be my neighbor."

Per iteration, each node's candidates are its neighbors' neighbors plus
its reverse neighbors (nodes that list it); their distances are computed
directly and merged with the current list by ``knn.merge_candidates``,
which suppresses duplicate ids.  Rows are processed in tiles so the
(tile, C, d) candidate gather stays near 256 MB.  ``sample`` caps the
candidate columns (0 = all K^2 + K, the paper-faithful default).
"""
from __future__ import annotations

import torch

from repro_torch.core import knn as knn_lib
from repro_torch.kernels import ops


def reverse_neighbors(knn_idx: torch.Tensor, r_cap: int) -> torch.Tensor:
    """(N, r_cap) reverse adjacency, padded with the row's own index (made
    inert by ``merge_candidates``' self-suppression).

    Edges sort stably by destination and take their rank in the segment
    as their slot.  A row with more than ``r_cap`` reverse edges gets its
    last slot cleared, as the JAX version's scatter leaves it (the
    overflowing edges all write -1 to the last slot, in stream order).
    """
    N, K = knn_idx.shape
    dev = knn_idx.device
    dst = knn_idx.reshape(-1).long()
    src = torch.arange(N, dtype=torch.int32, device=dev).repeat_interleave(K)
    order = torch.sort(dst, stable=True).indices
    dst_s, src_s = dst[order], src[order]
    seg_start = torch.searchsorted(dst_s, torch.arange(N, device=dev))
    rank = torch.arange(N * K, device=dev) - seg_start[dst_s.clamp_min(0)]
    real = dst_s >= 0                                      # -1: empty slot
    keep = real & (rank < r_cap)
    out = torch.full((N, r_cap), -1, dtype=torch.int32, device=dev)
    out[dst_s[keep], rank[keep]] = src_s[keep]
    over = torch.bincount(dst_s[real], minlength=N) > r_cap
    out[over, r_cap - 1] = -1
    rows = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    return torch.where(out < 0, rows, out)


def _tile_explore(x, knn_idx, knn_dist, rev, rows, sample: int,
                  generator):
    """One tile of nodes; returns merged (idx (T, K), dist (T, K))."""
    T = rows.shape[0]
    K = knn_idx.shape[1]
    nbrs = knn_idx[rows]                                   # (T, K)
    fwd = knn_idx[nbrs.long()].reshape(T, K * K)           # neighbors' nbrs
    cand = torch.cat([fwd, rev[rows]], dim=1)
    if sample and sample < cand.shape[1]:
        cols = torch.randint(0, cand.shape[1], (T, sample),
                             generator=generator, device=x.device)
        cand = torch.gather(cand, 1, cols)
    diff = (x[cand.long()] - x[rows][:, None, :]).float()  # (T, C, d)
    cd = (diff * diff).sum(-1)
    ids = torch.cat([nbrs, cand], dim=1)
    ds = torch.cat([knn_dist[rows], cd], dim=1)
    return knn_lib.merge_candidates(ids, ds, K, self_idx=rows)


def _explore_round(x, knn_idx, knn_dist, rows, *, sample: int, tile: int,
                   r_cap: int, generator):
    """One exploring iteration over ``rows``, tile by tile; every tile
    reads the graph as it was at the start of the round, and only
    ``rows`` are written."""
    rev = reverse_neighbors(knn_idx, r_cap)
    out_i = knn_idx.clone()
    out_d = knn_dist.clone()
    for t0 in range(0, rows.shape[0], tile):
        r = rows[t0:t0 + tile]
        out_i[r], out_d[r] = _tile_explore(x, knn_idx, knn_dist, rev, r,
                                           sample, generator)
    return out_i, out_d


def neighbor_explore(x, knn_idx, knn_dist, *, iters: int = 1,
                     sample: int = 0, generator=None,
                     tile: int | None = None, rows=None):
    """Refine (knn_idx, knn_dist) for ``iters`` rounds.

    Reverse neighbors are capped at K per row.  ``tile`` bounds the
    (tile, K^2 + K, d) gather; it is further capped so that gather stays
    under ~256 MB of f32.  ``rows`` (row indices) restricts
    exploring to those rows, the repair mode of ``transform.knn_insert``:
    candidates still come from the full graph, forward and reverse, but
    only ``rows`` are recomputed and written back.
    """
    N, K = knn_idx.shape
    if rows is None:
        rows = torch.arange(N, device=x.device)
    rows = rows.to(device=x.device, dtype=torch.int64)
    n_rows = rows.shape[0]
    if n_rows == 0:
        return knn_idx, knn_dist
    tile = tile or ops.EXPLORE_TILE
    budget = 64 * (1 << 20)
    tile = max(16, min(tile, n_rows,
                       budget // max(1, (K * K + K) * x.shape[1])))
    for _ in range(iters):
        knn_idx, knn_dist = _explore_round(x, knn_idx, knn_dist, rows,
                                           sample=sample, tile=tile,
                                           r_cap=K, generator=generator)
    return knn_idx, knn_dist
