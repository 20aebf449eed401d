"""Alias-method samplers: O(1) weighted edge sampling and negative
sampling from the noise distribution P_n(j) ∝ d_j^0.75 (paper §3.2).

A draw is one uniform slot, one uniform number, a compare and a gather.
Tables are built on the device by ``_alias_pairing``: a stable partition
into smalls and larges, prefix sums and two ``searchsorted`` resolve
Vose's pairing with exact per-index marginals.  The prefix sums run in
float64, which the card has natively (float32 loses the marginals from
E ~ 1e5 on).  ``build_alias`` is the numpy Vose loop, kept as the oracle.

The tables are a function of the graph, on the card too, so two fits
from one seed are bitwise equal: the negative sampler's in-degree sum
adds duplicate destinations in stream order (``ops.scatter_add_ordered``),
as the JAX package's ``deg.at[idx].add`` does, and on CUDA the f64 sums
of ``_alias_pairing`` go through :func:`ordered_cumsum`, whose float
grouping is fixed by the length alone (a 1-D ``torch.cumsum`` on CUDA
groups by timing).  On the CPU ``torch.cumsum`` adds left to right, as
the JAX package does, and stays.

On the data mesh (``build_samplers_sharded``) each rank pairs its own
rows' edges and nodes; a (P,)-entry shard table over the shards' total
masses sits on top, so a two-level draw is exactly proportional to the
global weights (``ShardedEdgeSampler``, ``ShardedNodeSampler``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.runtime import sharding as sh


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


# the row length of ordered_cumsum
SCAN_BLOCK = 1024


def ordered_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of the 1-D ``x`` whose float grouping depends
    on its length alone: ``x`` in rows of ``SCAN_BLOCK`` (zero-padded, at
    least two rows), each row scanned on its own, the row totals added
    left to right, and each row's carry added to it.

    A 1-D ``torch.cumsum`` on CUDA is a decoupled look-back scan, which
    adds the tiles' sums in the order they finish.  A (rows, block) scan
    along its last dimension takes one fixed tree a row, and a (rows, 2)
    scan along its first one a single sequential pass a column, so both
    group the same way on every run.  For nonnegative ``x`` the result
    is nondecreasing: a row's last sum is exactly the next row's carry.
    """
    n = x.shape[0]
    rows = max(2, -(-n // SCAN_BLOCK))
    padded = x.new_zeros(rows * SCAN_BLOCK)
    padded[:n] = x
    part = padded.view(rows, SCAN_BLOCK).cumsum(1)
    last = part[:, -1]
    totals = torch.stack([last, torch.zeros_like(last)], 1).cumsum(0)[:, 0]
    carry = torch.cat([totals.new_zeros(1), totals[:-1]])
    return (part + carry[:, None]).view(-1)[:n]


def _alias_pairing(probs: torch.Tensor, *, hi_dtype=torch.float64,
                   ordered: bool | None = None):
    """Vectorized alias-table construction.  probs: (n,) nonnegative, any
    scale (all zero -> uniform).  Returns (threshold (n,) f32, alias (n,)
    int32) with exact per-index marginals.

    ``ordered`` (default: on CUDA) takes the float sums through
    :func:`ordered_cumsum`; otherwise through ``torch.sum`` and
    ``torch.cumsum``, left to right on the CPU as in the JAX package.

    Smalls (scaled < 1, deficit 1-s) are stably partitioned in front of
    larges (surplus s-1).  Small i aliases the first large whose
    cumulative surplus reaches its cumulative deficit; a small straddling
    a surplus boundary is charged wholly to the later large, which repays
    the earlier one by aliasing the remainder of its own slot to it (a
    backward chain over the larges).  The same construction, op for op,
    as the JAX package's, so on the CPU the tables are bitwise equal.
    """
    dev = probs.device
    if ordered is None:
        ordered = dev.type == "cuda"
    # each intermediate is dropped once it is dead (the same ops in the
    # same order), so the peak stays at ALIAS_PEAK_BYTES an entry instead
    # of about 170 with every name kept to the end
    p = probs.float().reshape(-1).to(hi_dtype).clamp_min(0.0)
    n = p.shape[0]
    total = ordered_cumsum(p)[-1] if ordered else p.sum()
    p = torch.where(total > 0, p, torch.ones_like(p))
    n_t = torch.tensor(float(n), dtype=hi_dtype, device=dev)
    total = torch.where(total > 0, total, n_t)
    # a tensor numerator: ``int / tensor`` is reciprocal-then-multiply
    scaled = p * (n_t / total)
    del p

    is_small = scaled < 1.0
    m = is_small.sum()                       # partition point
    rank_small = torch.cumsum(is_small.int(), 0) - 1
    rank_large = m + torch.cumsum((~is_small).int(), 0) - 1
    dest = torch.where(is_small, rank_small, rank_large)
    del is_small, rank_small, rank_large
    pos = torch.arange(n, device=dev)
    order = torch.empty(n, dtype=torch.int64, device=dev)
    order[dest] = pos                        # partitioned -> original
    del dest
    ss = scaled[order]
    del scaled
    small = pos < m
    zero = torch.zeros((), dtype=hi_dtype, device=dev)
    d = torch.where(small, 1.0 - ss, zero)   # deficits, small prefix
    e = torch.where(small, zero, ss - 1.0)   # surpluses, large suffix
    scan = ordered_cumsum if ordered else functools.partial(torch.cumsum,
                                                            dim=0)
    D = scan(d)
    del d
    SE = scan(e)

    tgt = torch.minimum(torch.maximum(torch.searchsorted(SE, D, side="left"),
                                      m), torch.tensor(n - 1, device=dev))
    prev_se = SE - e
    del SE, e
    hi = torch.searchsorted(D, prev_se, side="right") - 1
    covered = torch.where(hi >= 0, D[hi.clamp(0, n - 1)], zero)
    del hi, D
    beta = (prev_se - covered).clamp(0.0, 1.0)
    del prev_se, covered

    thr_sorted = torch.where(small, ss, 1.0 - beta).float()
    del ss, beta
    prev = torch.minimum(torch.maximum(pos - 1, m),
                         torch.tensor(n - 1, device=dev))
    del pos
    alias_sorted = torch.where(small, order[tgt], order[prev])
    del small, tgt, prev
    threshold = torch.empty(n, dtype=torch.float32, device=dev)
    threshold[order] = thr_sorted
    del thr_sorted
    alias = torch.empty(n, dtype=torch.int32, device=dev)
    alias[order] = alias_sorted.to(torch.int32)
    return threshold, alias


# the pairing's reckoned peak, bytes an entry, at ``covered``: order, pos,
# tgt, hi (int64), ss, D, prev_se (f64) and small (bool) live, 57 bytes,
# and the where's mask, clamped index, gathered D and result, 25 more
ALIAS_PEAK_BYTES = 57 + 25


def alias_peak_bytes(n: int) -> int:
    """The reckoned device bytes :func:`_alias_pairing` holds at its peak
    for ``n`` entries, beside its input and outputs."""
    return ALIAS_PEAK_BYTES * int(n)


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


@dataclasses.dataclass
class ShardedEdgeSampler:
    """Per-shard edge alias tables with a shard-selection table on top.

    The per-shard tables are stacked ``(P, E_loc)``, the same on every
    rank: ``alias`` holds LOCAL edge indices (each shard's table covers
    its own edges), ``src``/``dst`` GLOBAL node ids.  ``shard_threshold``
    / ``shard_alias`` is the (P,)-entry table over the shards' total
    masses, so a two-level draw is exactly proportional to the global
    w_ij.  At one shard :meth:`sample` is the flat sampler of row 0, the
    same stream."""
    src: torch.Tensor              # (P, E_loc) int32, global node ids
    dst: torch.Tensor              # (P, E_loc) int32
    threshold: torch.Tensor        # (P, E_loc) f32
    alias: torch.Tensor            # (P, E_loc) int32, local edge indices
    shard_threshold: torch.Tensor  # (P,) f32
    shard_alias: torch.Tensor      # (P,) int32
    n_shards: int
    n_edges: int                   # real (unpadded) directed edges

    def local(self, i: int = 0) -> EdgeSampler:
        """Shard ``i``'s flat sampler: what rank ``i`` of the local-SGD
        layout draws from (stratified edge sampling)."""
        return EdgeSampler(self.src[i], self.dst[i], self.threshold[i],
                           self.alias[i], int(self.src.shape[1]))

    def sample(self, generator, batch: int):
        if self.n_shards == 1:
            return self.local().sample(generator, batch)
        s = sample_alias(generator, self.shard_threshold, self.shard_alias,
                         (batch,)).long()
        e = _second_level(generator, self.threshold, self.alias, s,
                          (batch,))
        return self.src[s, e], self.dst[s, e]


@dataclasses.dataclass
class ShardedNodeSampler:
    """Per-shard noise distribution P_n(j) ∝ deg_j^power over the row
    layout of ``runtime/sharding.py``: local node l of shard s is global
    node ``s * n_loc + l``.  Padded rows carry exactly zero mass, so a
    padded id is never drawn."""
    threshold: torch.Tensor        # (P, n_loc) f32
    alias: torch.Tensor            # (P, n_loc) int32, local node indices
    shard_threshold: torch.Tensor  # (P,) f32
    shard_alias: torch.Tensor      # (P,) int32
    n_shards: int
    n_nodes: int                   # real (unpadded) nodes

    def sample(self, generator, shape):
        if self.n_shards == 1:
            return sample_alias(generator, self.threshold[0], self.alias[0],
                                shape)
        s = sample_alias(generator, self.shard_threshold, self.shard_alias,
                         shape).long()
        n_loc = self.threshold.shape[1]
        l = _second_level(generator, self.threshold, self.alias, s, shape)
        return (s * n_loc + l).to(torch.int32)


def _second_level(generator, threshold, alias, s, shape) -> torch.Tensor:
    """Alias draws from the stacked tables' rows ``s`` (int64 of
    ``shape``): a uniform slot, a uniform number, compare, gather."""
    n = threshold.shape[1]
    idx = torch.randint(0, n, shape, generator=generator,
                        device=threshold.device)
    u = torch.rand(shape, generator=generator, device=threshold.device)
    return torch.where(u < threshold[s, idx], idx, alias[s, idx].long())


def build_edge_sampler(knn_idx, weights) -> EdgeSampler:
    """(N, K) directed graph -> edge sampler, built on the graph's device.

    An empty slot (id -1) wraps to row N-1, as JAX's indexing does."""
    N, K = knn_idx.shape
    src = torch.arange(N, dtype=torch.int32,
                       device=knn_idx.device).repeat_interleave(K)
    dst = knn_idx.reshape(-1).remainder(N).to(torch.int32)
    thr, alias = _alias_pairing(weights.reshape(-1))
    return EdgeSampler(src, dst, thr, alias, N * K)


def weighted_degree(knn_idx, weights) -> torch.Tensor:
    """d_j = sum_i w_ij over out- and in-edges, (N,) f32: the row sums,
    then each edge's weight added to its destination in stream order (an
    empty slot, id -1, wraps to row N-1 as JAX's indexing does)."""
    N, _ = knn_idx.shape
    w = weights.float().clamp_min(0.0)
    deg = w.sum(1)
    ops.scatter_add_ordered(deg[:, None], knn_idx.reshape(-1).remainder(N),
                            w.reshape(-1, 1))
    return deg


def build_negative_sampler(knn_idx, weights, *,
                           power: float = 0.75) -> NodeSampler:
    """Weighted degree d_j = sum_i w_ij (in + out), then ^power."""
    deg = weighted_degree(knn_idx, weights)
    thr, alias = _alias_pairing(deg.clamp_min(1e-12) ** power)
    return NodeSampler(thr, alias, knn_idx.shape[0])


def alias_marginals(threshold, alias) -> np.ndarray:
    """The exact per-index draw probability an alias table encodes,
    ``(threshold_i + sum_j 1[alias_j = i] (1 - threshold_j)) / n``, in
    f64 on the host."""
    thr = np.asarray(torch.as_tensor(threshold).cpu(), np.float64)
    ali = np.asarray(torch.as_tensor(alias).cpu(), np.int64)
    m = thr.copy()
    np.add.at(m, ali, 1.0 - thr)
    return m / thr.shape[0]


def edge_marginals(sampler) -> np.ndarray:
    """The per-directed-edge draw probabilities, row-major ``(E,)``, of an
    :class:`EdgeSampler` or a :class:`ShardedEdgeSampler` (the shard
    table's marginal times the shard's own; the shards' blocks in order
    are the global row order, padding last and sliced off).  Tables built
    from one graph on any mesh agree up to the pairing's rounding (w_e /
    W in exact arithmetic)."""
    if isinstance(sampler, ShardedEdgeSampler):
        if sampler.n_shards == 1:
            return alias_marginals(sampler.threshold[0],
                                   sampler.alias[0])[:sampler.n_edges]
        shard_p = alias_marginals(sampler.shard_threshold,
                                  sampler.shard_alias)
        per = [shard_p[s] * alias_marginals(sampler.threshold[s],
                                            sampler.alias[s])
               for s in range(sampler.n_shards)]
        return np.concatenate(per)[:sampler.n_edges]
    return alias_marginals(sampler.threshold,
                           sampler.alias)[:sampler.n_edges]


def _total(mass: torch.Tensor) -> torch.Tensor:
    """The f64 total of a nonnegative mass vector, summed as
    ``_alias_pairing`` sums it (in a fixed order on the card)."""
    p = mass.float().reshape(-1).double().clamp_min(0.0)
    return ordered_cumsum(p)[-1] if p.is_cuda else p.sum()


def build_samplers_sharded(knn_idx, weights, *, power: float = 0.75, mesh):
    """(ShardedEdgeSampler, ShardedNodeSampler) built on the data mesh,
    the same on every rank.

    Every rank holds the global (N, K) graph and weights; rank s pairs
    the edges and the node masses of its own row block (padded rows:
    zero weight, exactly zero mass), and the blocks' tables are
    all-gathered into the stacked samplers, with the (P,) shard tables
    paired from the gathered totals.  A node's mass is its weighted
    degree :func:`weighted_degree` of the global graph, the flat
    sampler's bits at every shard count (the in-degree added to the
    out-degree in stream order; the JAX package sums each shard's
    in-degree part from zero and adds it after, which differs in the
    last bit unless the weights are integers).  So at one shard both
    tables are bitwise the flat samplers', and at any P the node masses
    are."""
    N, K = knn_idx.shape
    P = mesh.size
    n_loc = sh.rows_per_shard(N, P)
    lo = mesh.rank * n_loc
    dev = knn_idx.device
    idx_loc = sh.shard_rows(knn_idx, mesh)
    w_loc = sh.shard_rows(weights.float(), mesh)
    src = torch.arange(lo, lo + n_loc, dtype=torch.int32,
                       device=dev).repeat_interleave(K)
    dst = idx_loc.reshape(-1).remainder(N).to(torch.int32)
    ethr, eali = _alias_pairing(w_loc.reshape(-1))
    mass = sh.shard_rows(weighted_degree(knn_idx, weights).clamp_min(1e-12)
                         ** power, mesh)
    nthr, nali = _alias_pairing(mass)
    totals = torch.stack([_total(w_loc), _total(mass)])
    parts = [torch.stack(mesh.all_gather_list(t)) for t in
             (src, dst, ethr, eali, nthr, nali, totals)]
    src_s, dst_s, ethr_s, eali_s, nthr_s, nali_s, tot = parts
    sthr_e, sali_e = _alias_pairing(tot[:, 0])
    sthr_n, sali_n = _alias_pairing(tot[:, 1])
    edge_s = ShardedEdgeSampler(src_s, dst_s, ethr_s, eali_s, sthr_e, sali_e,
                                P, N * K)
    node_s = ShardedNodeSampler(nthr_s, nali_s, sthr_n, sali_n, P, N)
    return edge_s, node_s
