"""Alias-method samplers: O(1) weighted edge sampling and negative
sampling from the noise distribution P_n(j) ∝ d_j^0.75 (paper §3.2).

A draw is one uniform slot, one uniform number, a compare and a gather.
Tables are built on the device by ``_alias_pairing``: a stable partition
into smalls and larges, prefix sums and two ``searchsorted`` resolve
Vose's pairing with exact per-index marginals.  The prefix sums run in
float64, which the card has natively (float32 loses the marginals from
E ~ 1e5 on).  ``build_alias`` is the numpy Vose loop, kept as the oracle.

The in-degree sum of the negative sampler is an ``index_add_``, which on
CUDA uses atomics: tables built on the card may differ in their slots
from run to run, never in their marginals.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def build_alias(probs: np.ndarray):
    """Vose's alias method on the host.  probs: (n,) nonnegative, any
    scale.  Returns (threshold (n,) f32, alias (n,) i32)."""
    p = np.asarray(probs, np.float64)
    n = p.shape[0]
    assert n > 0 and (p >= 0).all()
    s = p.sum()
    assert s > 0, "all-zero probabilities"
    scaled = p * (n / s)
    threshold = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s_i = small.pop()
        l_i = large.pop()
        threshold[s_i] = scaled[s_i]
        alias[s_i] = l_i
        scaled[l_i] = scaled[l_i] - (1.0 - scaled[s_i])
        (small if scaled[l_i] < 1.0 else large).append(l_i)
    for rest in (small, large):
        for i in rest:
            threshold[i] = 1.0
    return threshold.astype(np.float32), alias


def _alias_pairing(probs: torch.Tensor, *, hi_dtype=torch.float64):
    """Vectorized alias-table construction.  probs: (n,) nonnegative, any
    scale (all zero -> uniform).  Returns (threshold (n,) f32, alias (n,)
    int32) with exact per-index marginals.

    Smalls (scaled < 1, deficit 1-s) are stably partitioned in front of
    larges (surplus s-1).  Small i aliases the first large whose
    cumulative surplus reaches its cumulative deficit; a small straddling
    a surplus boundary is charged wholly to the later large, which repays
    the earlier one by aliasing the remainder of its own slot to it (a
    backward chain over the larges).  The same construction, op for op,
    as the JAX package's, so on the CPU the tables are bitwise equal.
    """
    dev = probs.device
    p = probs.float().reshape(-1).to(hi_dtype).clamp_min(0.0)
    n = p.shape[0]
    total = p.sum()
    p = torch.where(total > 0, p, torch.ones_like(p))
    n_t = torch.tensor(float(n), dtype=hi_dtype, device=dev)
    total = torch.where(total > 0, total, n_t)
    # a tensor numerator: ``int / tensor`` is reciprocal-then-multiply
    scaled = p * (n_t / total)

    is_small = scaled < 1.0
    m = is_small.sum()                       # partition point
    rank_small = torch.cumsum(is_small.int(), 0) - 1
    rank_large = m + torch.cumsum((~is_small).int(), 0) - 1
    dest = torch.where(is_small, rank_small, rank_large)
    pos = torch.arange(n, device=dev)
    order = torch.empty(n, dtype=torch.int64, device=dev)
    order[dest] = pos                        # partitioned -> original
    ss = scaled[order]
    small = pos < m
    zero = torch.zeros((), dtype=hi_dtype, device=dev)
    d = torch.where(small, 1.0 - ss, zero)   # deficits, small prefix
    e = torch.where(small, zero, ss - 1.0)   # surpluses, large suffix
    D = torch.cumsum(d, 0)
    SE = torch.cumsum(e, 0)

    tgt = torch.minimum(torch.maximum(torch.searchsorted(SE, D, side="left"),
                                      m), torch.tensor(n - 1, device=dev))
    prev_se = SE - e
    hi = torch.searchsorted(D, prev_se, side="right") - 1
    covered = torch.where(hi >= 0, D[hi.clamp(0, n - 1)], zero)
    beta = (prev_se - covered).clamp(0.0, 1.0)

    thr_sorted = torch.where(small, ss, 1.0 - beta).float()
    prev = torch.minimum(torch.maximum(pos - 1, m),
                         torch.tensor(n - 1, device=dev))
    alias_sorted = torch.where(small, order[tgt], order[prev])
    threshold = torch.empty(n, dtype=torch.float32, device=dev)
    threshold[order] = thr_sorted
    alias = torch.empty(n, dtype=torch.int32, device=dev)
    alias[order] = alias_sorted.to(torch.int32)
    return threshold, alias


def sample_alias(generator, threshold, alias, shape):
    """Batched alias draws -> int32 indices of the given shape."""
    n = threshold.shape[0]
    dev = threshold.device
    idx = torch.randint(0, n, shape, generator=generator, device=dev,
                        dtype=torch.int32)
    u = torch.rand(shape, generator=generator, device=dev)
    return torch.where(u < threshold[idx], idx, alias[idx])


@dataclasses.dataclass
class EdgeSampler:
    """Directed edge list (src, dst) with an alias table over weights."""
    src: torch.Tensor          # (E,) int32
    dst: torch.Tensor          # (E,) int32
    threshold: torch.Tensor    # (E,) f32
    alias: torch.Tensor        # (E,) int32
    n_edges: int

    def sample(self, generator, batch: int):
        e = sample_alias(generator, self.threshold, self.alias, (batch,))
        return self.src[e], self.dst[e]


@dataclasses.dataclass
class NodeSampler:
    """Noise distribution over nodes, P_n(j) ∝ deg_j^power."""
    threshold: torch.Tensor
    alias: torch.Tensor
    n_nodes: int

    def sample(self, generator, shape):
        return sample_alias(generator, self.threshold, self.alias, shape)


def build_edge_sampler(knn_idx, weights) -> EdgeSampler:
    """(N, K) directed graph -> edge sampler, built on the graph's device.

    An empty slot (id -1) wraps to row N-1, as JAX's indexing does."""
    N, K = knn_idx.shape
    src = torch.arange(N, dtype=torch.int32,
                       device=knn_idx.device).repeat_interleave(K)
    dst = knn_idx.reshape(-1).remainder(N).to(torch.int32)
    thr, alias = _alias_pairing(weights.reshape(-1))
    return EdgeSampler(src, dst, thr, alias, N * K)


def build_negative_sampler(knn_idx, weights, *,
                           power: float = 0.75) -> NodeSampler:
    """Weighted degree d_j = sum_i w_ij (in + out), then ^power."""
    N, _ = knn_idx.shape
    w = weights.float().clamp_min(0.0)
    deg = w.sum(1).index_add_(0, knn_idx.reshape(-1).remainder(N),
                              w.reshape(-1))
    thr, alias = _alias_pairing(deg.clamp_min(1e-12) ** power)
    return NodeSampler(thr, alias, N)


def alias_marginals(threshold, alias) -> np.ndarray:
    """The exact per-index draw probability an alias table encodes,
    ``(threshold_i + sum_j 1[alias_j = i] (1 - threshold_j)) / n``, in
    f64 on the host."""
    thr = np.asarray(torch.as_tensor(threshold).cpu(), np.float64)
    ali = np.asarray(torch.as_tensor(alias).cpu(), np.int64)
    m = thr.copy()
    np.add.at(m, ali, 1.0 - thr)
    return m / thr.shape[0]
