"""Vantage-point tree KNN (Yianilos 1993), the t-SNE baseline in Fig 2.

Host-side numpy, as in the JAX package: a pointer-chasing metric tree is
a CPU algorithm, and it is here as the baseline the paper beats.  Build:
a random vantage point, split at the median distance.  Query: descent
with triangle-inequality pruning against the search radius ``tau``; an
``eps`` slack prunes more (the approximate variant of the time/recall
curve).
"""
from __future__ import annotations

import heapq
import sys

import numpy as np


class VPTree:
    __slots__ = ("point", "index", "mu", "inside", "outside")

    def __init__(self, point, index, mu, inside, outside):
        self.point = point
        self.index = index
        self.mu = mu
        self.inside = inside
        self.outside = outside


def build_vptree(x: np.ndarray, idx: np.ndarray | None = None,
                 rng: np.random.Generator | None = None):
    if rng is None:
        rng = np.random.default_rng(0)
    if idx is None:
        idx = np.arange(x.shape[0])
    if len(idx) == 0:
        return None
    vp_pos = rng.integers(len(idx))
    vp = idx[vp_pos]
    rest = np.delete(idx, vp_pos)
    if len(rest) == 0:
        return VPTree(x[vp], vp, 0.0, None, None)
    d = np.linalg.norm(x[rest] - x[vp], axis=1)
    mu = float(np.median(d))
    return VPTree(x[vp], vp, mu,
                  build_vptree(x, rest[d < mu], rng),
                  build_vptree(x, rest[d >= mu], rng))


def query_vptree(root: VPTree, q: np.ndarray, k: int,
                 eps: float = 0.0) -> np.ndarray:
    """The k nearest indices to q, nearest first; eps > 0 prunes more."""
    heap: list = []           # max-heap of (-dist, idx)
    tau = [np.inf]
    shrink = 1.0 + eps

    def search(node):
        if node is None:
            return
        d = float(np.linalg.norm(q - node.point))
        if d < tau[0]:
            if len(heap) == k:
                heapq.heappop(heap)
            heapq.heappush(heap, (-d, node.index))
            if len(heap) == k:
                tau[0] = -heap[0][0]
        if d < node.mu:
            if d - tau[0] / shrink < node.mu:
                search(node.inside)
            if d + tau[0] / shrink >= node.mu:
                search(node.outside)
        else:
            if d + tau[0] / shrink >= node.mu:
                search(node.outside)
            if d - tau[0] / shrink < node.mu:
                search(node.inside)

    search(root)
    out = sorted((-nd, i) for nd, i in heap)
    return np.array([i for _, i in out], np.int32)


def vptree_knn(x: np.ndarray, k: int, eps: float = 0.0,
               n_query: int | None = None) -> np.ndarray:
    """(n_query, k) KNN of the first n_query points, self excluded, from
    one vp-tree (built with ``default_rng(0)``)."""
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100000))
    x = np.asarray(x, np.float32)
    root = build_vptree(x)
    n = x.shape[0] if n_query is None else min(n_query, x.shape[0])
    out = np.zeros((n, k), np.int32)
    for i in range(n):
        nn = query_vptree(root, x[i], k + 1, eps=eps)
        nn = nn[nn != i][:k]
        out[i, :len(nn)] = nn
    return out
