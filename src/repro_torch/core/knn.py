"""Approximate KNN graph construction (paper §3.1, Algo 1), one device.

The projection forest gives each point a bucket code per tree, in one of
two modes:

* ``rp_mode="hash"``: ``depth`` sign-projections (one matmul);
* ``rp_mode="tree"``: the paper's random-projection tree, descended level
  by level for all points at once: every node's hyperplane is
  equidistant to a sampled pair of points, and each point takes the
  hyperplane of the node its code addresses (``tree_codes``).

Points sort by code, and each block of W sorted points is compared with
its ±W neighbourhood (3W candidates) by the streaming distance -> top-k
kernel, seeded with the running top-k of the block's rows.  All
``ceil(N/W)`` blocks of one tree are one kernel launch (a leading group
dimension).  Neighbor exploring (``core/neighbor_explore.py``) then
repairs the graph.

Every argsort here is stable, as ``jnp.argsort`` is, so ties between
equal codes or ids order the same way in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as ref_lib

INF = 3.4e38


def brute_force_knn(x: torch.Tensor, k: int):
    """Exact KNN: (idx (N, k) int32, sqdist (N, k) f32), self excluded."""
    N = x.shape[0]
    k = min(int(k), N - 1)
    ids = torch.arange(N, dtype=torch.int32, device=x.device)
    return ops.topk_sqdist(x, x, k, a_ids=ids, b_ids=ids)


def merge_candidates(ids: torch.Tensor, dists: torch.Tensor, k: int,
                     self_idx: torch.Tensor | None = None):
    """Per-row top-k over candidate (ids, dists), duplicates suppressed.

    ids: (R, C) int32; dists: (R, C) f32.  Repeated ids and self-edges
    get INF distance.  Returns (idx (R, k), dist (R, k)); ties keep the
    earliest position of the id-sorted row, as ``lax.top_k`` does.
    """
    R = ids.shape[0]
    if self_idx is not None:
        dists = dists.masked_fill(ids == self_idx[:, None], INF)
    order = torch.sort(ids, dim=1, stable=True).indices
    ids_s = torch.gather(ids, 1, order)
    d_s = torch.gather(dists, 1, order)
    dup = torch.cat([torch.zeros((R, 1), dtype=torch.bool, device=ids.device),
                     ids_s[:, 1:] == ids_s[:, :-1]], dim=1)
    d_s = d_s.masked_fill(dup, INF)
    ni = torch.sort(d_s, dim=1, stable=True).indices[:, :k]
    return torch.gather(ids_s, 1, ni), torch.gather(d_s, 1, ni)


def _auto_depth(n: int, leaf_target: int) -> int:
    return max(2, min(24, int(np.ceil(np.log2(max(n, 2) / leaf_target)))))


def hash_codes(x: torch.Tensor, n_trees: int, depth: int, *,
               proj: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Sign-random-projection bucket codes: (N, n_trees) int32.

    ``proj`` (d, n_trees*depth) gives the hyperplanes; without it they
    are drawn from ``generator``.  The product runs in full f32: a TF32
    product would flip code bits near the hyperplanes.
    """
    N, d = x.shape
    if proj is None:
        proj = torch.randn((d, n_trees * depth), generator=generator,
                           device=x.device, dtype=torch.float32)
    bits = (x.float() @ proj.to(x.device, torch.float32)) > 0.0
    bits = bits.reshape(N, n_trees, depth).to(torch.int32)
    weights = 1 << torch.arange(depth, dtype=torch.int32, device=x.device)
    return (bits * weights).sum(-1).to(torch.int32)


def tree_codes(x: torch.Tensor, n_trees: int, depth: int, *,
               pairs: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Random-projection tree codes: (N, n_trees) int32.

    ``pairs`` (n_trees, 2**depth - 1, 2) holds each node's sampled pair
    of point ids in heap order (level l's nodes start at 2**l - 1);
    without it they are drawn from ``generator``.  Node (a, b) splits at
    the hyperplane equidistant to x_a and x_b: h = x_a - x_b, offset
    b = h.(x_a + x_b)/2, and a point goes right when x.h > b.  A pair
    with a == b gives h = 0, so every point goes left.  The dot products
    are row products summed in f32 (no TF32, no batched matmul); their
    summation order is not XLA's, so a point within rounding of its
    plane can take the other side than in the JAX package.
    """
    N, d = x.shape
    xf = x.float()
    if pairs is None:
        pairs = torch.randint(0, N, (n_trees, (1 << depth) - 1, 2),
                              generator=generator, device=x.device)
    pairs = pairs.to(x.device, torch.int64)
    codes = torch.empty((N, n_trees), dtype=torch.int32, device=x.device)
    for t in range(n_trees):
        code = torch.zeros(N, dtype=torch.int64, device=x.device)
        for level in range(depth):
            node = pairs[t, (1 << level) - 1:(1 << (level + 1)) - 1]
            xa, xb = xf[node[:, 0]], xf[node[:, 1]]
            h = xa - xb                                    # (2^level, d)
            b = (h * (xa + xb) * 0.5).sum(1)
            side = (xf * h[code]).sum(1) > b[code]
            code = code * 2 + side
        codes[:, t] = code
    return codes


def tree_code_flips(x, pairs, codes, other, depth: int):
    """Where two tree codings of x differ, the plane that split them.

    For each point whose ``codes`` and ``other`` (both (N, n_trees))
    differ in some tree, the first level that differs names one node both
    codings reached; returns (point, tree, margin, bound) as f64 numpy
    arrays, with margin = |x.h - b| in f64 from the f32 h = x_a - x_b
    and bound = 4 d 2^-23 (|x| |h| + |b|): a flip is f32 rounding only
    while margin <= bound.
    """
    xs = np.array(torch.as_tensor(x).cpu(), np.float32)
    pr = np.asarray(torch.as_tensor(pairs).cpu(), np.int64)
    a = np.asarray(torch.as_tensor(codes).cpu(), np.int64)
    o = np.asarray(torch.as_tensor(other).cpu(), np.int64)
    pt, tr = np.nonzero(a != o)
    diff = a[pt, tr] ^ o[pt, tr]
    top = np.floor(np.log2(diff)).astype(np.int64)        # first bit apart
    level = depth - 1 - top
    prefix = a[pt, tr] >> (top + 1)                        # shared node
    node = pr[tr, (1 << level) - 1 + prefix]               # (F, 2)
    xa, xb = xs[node[:, 0]], xs[node[:, 1]]
    h = (xa - xb).astype(np.float64)
    mid = (xa + xb).astype(np.float64)
    b = (h * mid * 0.5).sum(1)
    xp = xs[pt].astype(np.float64)
    margin = np.abs((xp * h).sum(1) - b)
    d = xs.shape[1]
    bound = 4 * d * 2.0 ** -23 * (np.linalg.norm(xp, axis=1)
                                  * np.linalg.norm(h, axis=1) + np.abs(b))
    return pt, tr, margin, bound


def window_fold_args(x, code, k: int, window: int, run_ids, run_d):
    """The grouped ``topk_sqdist`` arguments of one tree's window fold.

    Points sort by bucket code; sorted block j (W rows) meets blocks j-1,
    j, j+1 (3W candidates), seeded with the running state of its rows.
    The edge blocks' repeated neighbour segment (block 0's j-1 is itself,
    the last block's j+1 is itself) carries id -1, so no candidate is
    offered twice; candidates already in the state are masked (dedup).
    The blocks are row indices into x (the index form: x is read in
    place, -1 a padding row), and a row's index is its id.
    Returns (x, x, kwargs, order): ``order`` maps sorted rows to points.
    """
    N = x.shape[0]
    W = min(window, N)
    dev = x.device
    order = torch.sort(code, stable=True).indices          # sorted -> orig
    nb = -(-N // W)
    pad = nb * W - N
    order_p = torch.cat([order, order.new_full((pad,), -1)]) if pad else order
    safe = order_p.clamp(0, N - 1)
    valid = (order_p >= 0)[:, None]
    st_i = torch.where(valid, run_ids[safe], -1)
    st_d = torch.where(valid, run_d[safe], ref_lib.INVALID_DIST)
    ids = order_p.to(torch.int32).reshape(nb, W)
    jj = torch.arange(nb, device=dev)
    nbr = torch.stack([(jj - 1).clamp(0, nb - 1), jj,
                       (jj + 1).clamp(0, nb - 1)], dim=1)  # (nb, 3)
    bid = ids[nbr]                                         # (nb, 3, W)
    bid[0, 0] = -1                                         # j-1 == j at 0
    bid[nb - 1, 2] = -1                                    # j+1 == j at end
    bid = bid.reshape(nb, 3 * W)
    kw = dict(a_idx=ids, b_idx=bid, a_ids=ids, b_ids=bid,
              init_ids=st_i.reshape(nb, W, k),
              init_dists=st_d.reshape(nb, W, k), dedup=True, bn=3 * W)
    return x, x, kw, order


def _window_fold_one_tree(x, code, k: int, window: int, run_ids, run_d):
    """Fold one tree's sorted-window candidates into the running top-k
    (one grouped kernel launch); returns (idx, dist) in point order."""
    N = x.shape[0]
    a, b, kw, order = window_fold_args(x, code, k, window, run_ids, run_d)
    cid, cd = ops.topk_sqdist(a, b, k, **kw)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(N, device=x.device)
    return cid.reshape(-1, k)[inv], cd.reshape(-1, k)[inv]


def forest_knn(x: torch.Tensor, *, n_trees: int, depth: int, k: int,
               window: int, rp_mode: str = "hash",
               proj: torch.Tensor | None = None,
               pairs: torch.Tensor | None = None,
               generator: torch.Generator | None = None):
    """Initial approximate KNN from the projection forest.

    ``rp_mode`` "hash" codes points by ``hash_codes`` (``proj`` fixes the
    hyperplanes), "tree" by ``tree_codes`` (``pairs`` fixes the nodes'
    pairs).  The running (N, k) top-k folds one tree after another; a
    candidate already held is never offered again (dedup), so the result
    is the top-k of the union of all trees' windows.
    """
    N = x.shape[0]
    if rp_mode == "hash":
        codes = hash_codes(x, n_trees, depth, proj=proj, generator=generator)
    elif rp_mode == "tree":
        codes = tree_codes(x, n_trees, depth, pairs=pairs,
                           generator=generator)
    else:
        raise ValueError(f"rp_mode={rp_mode!r}: expected 'hash' or 'tree'")
    run_ids = torch.full((N, k), -1, dtype=torch.int32, device=x.device)
    run_d = torch.full((N, k), ref_lib.INVALID_DIST, device=x.device)
    for t in range(n_trees):
        run_ids, run_d = _window_fold_one_tree(x, codes[:, t], k, window,
                                               run_ids, run_d)
    return run_ids, run_d


def build_knn_graph(x: torch.Tensor, cfg, *,
                    generator: torch.Generator | None = None,
                    proj: torch.Tensor | None = None,
                    pairs: torch.Tensor | None = None):
    """Forest + neighbor exploring: (idx (N, K) int32, sqdist (N, K) f32).

    ``cfg.rp_mode`` picks the forest's codes (``proj`` or ``pairs`` fix
    its randomness, see ``forest_knn``).  With ``cfg.distributed`` (and
    ``routing.knn_stage`` other than "forest") the graph is built on the
    data mesh instead: the ring of ``core/knn_sharded.py``.
    """
    from repro_torch.core.neighbor_explore import neighbor_explore
    if cfg.distributed and cfg.routing.knn_stage != "forest":
        from repro_torch.core.knn_sharded import build_knn_graph_sharded
        return build_knn_graph_sharded(x, cfg, generator=generator,
                                       proj=proj)
    N = x.shape[0]
    k = min(cfg.n_neighbors, N - 1)
    depth = cfg.tree_depth or _auto_depth(N, cfg.leaf_target)
    idx, dist = forest_knn(x, n_trees=cfg.n_trees, depth=depth, k=k,
                           window=cfg.window, rp_mode=cfg.rp_mode,
                           proj=proj, pairs=pairs, generator=generator)
    if cfg.n_explore_iters:
        idx, dist = neighbor_explore(x, idx, dist, iters=cfg.n_explore_iters,
                                     sample=cfg.explore_sample,
                                     generator=generator)
    return idx, dist


def knn_recall(idx: torch.Tensor, true_idx: torch.Tensor, *,
               tile: int = 4096) -> float:
    """Fraction of true K nearest neighbors recovered, row-tiled so the
    (tile, K, K) match tensor stays small."""
    N, K = idx.shape
    hits = 0.0
    for t0 in range(0, N, tile):
        a = idx[t0:t0 + tile]
        t = true_idx[t0:t0 + tile].to(a.dtype)
        hits += float((a[:, :, None] == t[:, None, :]).any(-1).sum())
    return hits / (N * K)
