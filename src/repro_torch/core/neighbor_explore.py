"""Neighbor exploring (paper §3.1 step 3): "a neighbor of my neighbor is
also likely to be my neighbor."

Per iteration, each node's candidates are its neighbors' neighbors plus
its reverse neighbors (nodes that list it); their distances are computed
directly and merged with the current list by ``knn.merge_candidates``,
which suppresses duplicate ids.  Rows are processed in tiles so the
(tile, C, d) candidate gather stays near 256 MB.  ``sample`` caps the
candidate columns (0 = all K^2 + K, the paper-faithful default).

``sharded_explore_round`` is the data mesh's round: every rank gathers
the (N, K) graph (output-sized, which is how a rank learns its rows'
reverse neighbors), forms its own rows' candidates, and fills their
distances by streaming the point slabs round the ring, so no rank holds
more than its own slab of points and one in flight.
"""
from __future__ import annotations

import torch

from repro_torch.core import knn as knn_lib
from repro_torch.runtime import autotune


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


def capped_tile(tile: int, n_rows: int, K: int, d: int) -> int:
    """The row tile exploring runs: ``tile`` capped by the rows and so
    that the (tile, K^2 + K, d) gather stays under ~256 MB of f32."""
    budget = 64 * (1 << 20)
    return max(16, min(tile, n_rows, budget // max(1, (K * K + K) * d)))


def neighbor_explore(x, knn_idx, knn_dist, *, iters: int = 1,
                     sample: int = 0, generator=None,
                     tile: int | None = None, rows=None):
    """Refine (knn_idx, knn_dist) for ``iters`` rounds.

    Reverse neighbors are capped at K per row.  ``tile`` bounds the
    (tile, K^2 + K, d) gather (``capped_tile``); None asks the tuner,
    but only when ``sample == 0``: a sampled round draws its candidate
    columns tile by tile, so there the tile is part of the result and
    the legacy 1024 runs.  ``rows`` (row indices) restricts exploring to
    those rows, the repair mode of ``transform.knn_insert``: candidates
    still come from the full graph, forward and reverse, but only
    ``rows`` are recomputed and written back.
    """
    N, K = knn_idx.shape
    if rows is None:
        rows = torch.arange(N, device=x.device)
    rows = rows.to(device=x.device, dtype=torch.int64)
    n_rows = rows.shape[0]
    if n_rows == 0:
        return knn_idx, knn_dist
    if tile is None:
        tile = autotune.legacy_default("neighbor_explore")["tile"]
        if sample == 0:
            tile = autotune.get("neighbor_explore",
                                dict(n=n_rows, k=K, d=x.shape[1]),
                                dict(tile=tile),
                                backend=x.device.type)["tile"]
    tile = capped_tile(tile, n_rows, K, x.shape[1])
    for _ in range(iters):
        knn_idx, knn_dist = _explore_round(x, knn_idx, knn_dist, rows,
                                           sample=sample, tile=tile,
                                           r_cap=K, generator=generator)
    return knn_idx, knn_dist


def sharded_explore_round(mesh, x_loc, ids_loc, knn_idx_loc, knn_dist_loc,
                          *, n_real: int, generator=None, sample: int = 0,
                          r_cap: int = 0, tile: int = 0):
    """One exploring round for this rank's rows of the data mesh.

    x_loc        (n_loc, d)   this rank's point slab (padded rows zero)
    ids_loc      (n_loc,)     the slab's global ids, a contiguous range
    knn_idx_loc  (n_loc, K)   its rows of the graph (global ids)
    knn_dist_loc (n_loc, K)

    The JAX package's ``sharded_explore_round``, op for op: the graph is
    all-gathered and its reverse adjacency built whole (padding rows
    included); a row's candidates are its neighbors' neighbors and its
    reverse neighbors, a padding id replaced by the row's own (then
    suppressed), optionally ``sample`` columns of them drawn from
    ``generator``; their distances fill over P ring steps, each reading
    only the slab held; ``knn.merge_candidates`` merges them with the
    row's list.  Candidates and distances are made ``tile`` rows at a
    time (0: the (tile, C, d) gather under ~256 MB of f32), and a row's
    merge runs with its last ring step, so beside the one-step (n_loc, C)
    distance table (only for P > 1) nothing of size (n_loc, C) exists;
    the merge is per row, so the tile moves memory, never the result.
    Returns the merged (idx, dist) of the local rows.
    """
    n_loc, K = knn_idx_loc.shape
    d = x_loc.shape[1]
    dev = x_loc.device
    r_cap = r_cap or K
    lo = mesh.rank * n_loc
    g_idx = mesh.all_gather(knn_idx_loc)                   # (Np, K)
    rev = reverse_neighbors(g_idx, r_cap)[lo:lo + n_loc]
    C = K * K + r_cap
    cols = None
    if sample and sample < C:
        cols = torch.randint(0, C, (n_loc, sample), generator=generator,
                             device=dev)
        C = sample
    budget = 64 * (1 << 20)
    T = int(tile) or max(16, min(n_loc, budget // max(1, C * d)))
    T = min(T, n_loc)

    def candidates(r0, r1):
        fwd = g_idx[knn_idx_loc[r0:r1].long()].reshape(r1 - r0, K * K)
        cand = torch.cat([fwd, rev[r0:r1]], dim=1)
        if cols is not None:
            cand = torch.gather(cand, 1, cols[r0:r1])
        own = ids_loc[r0:r1, None].to(cand.dtype)
        return torch.where(cand >= n_real, own, cand)

    out_i = torch.empty_like(knn_idx_loc)
    out_d = torch.empty_like(knn_dist_loc)
    cd = None
    rx = x_loc
    for s in range(mesh.size):
        roff = ((mesh.rank - s) % mesh.size) * n_loc       # slab held
        last = s == mesh.size - 1
        if not last and cd is None:
            cd = torch.full((n_loc, C), knn_lib.INF, device=dev)
        for r0 in range(0, n_loc, T):
            r1 = min(r0 + T, n_loc)
            cand = candidates(r0, r1)
            rel = cand.long() - roff
            in_rng = (rel >= 0) & (rel < n_loc)
            xc = rx[rel.clamp(0, n_loc - 1)]               # (T, C, d)
            diff = (xc - x_loc[r0:r1][:, None, :]).float()
            prev = (cd[r0:r1] if cd is not None
                    else torch.full(cand.shape, knn_lib.INF, device=dev))
            filled = torch.where(in_rng, (diff * diff).sum(-1), prev)
            if not last:
                cd[r0:r1] = filled
                continue
            ids = torch.cat([knn_idx_loc[r0:r1], cand], dim=1)
            ds = torch.cat([knn_dist_loc[r0:r1], filled], dim=1)
            out_i[r0:r1], out_d[r0:r1] = knn_lib.merge_candidates(
                ids, ds, K, self_idx=ids_loc[r0:r1])
        if not last:
            rx = mesh.ring_shift(rx)
    return out_i, out_d
