"""Out-of-sample projection and incremental graph maintenance.

Two online operations on a fitted model, built from the batch pipeline's
own pieces:

* :func:`project` embeds Q held-out queries into a FROZEN fitted layout.
  One ``ops.topk_sqdist`` call finds each query's k corpus neighbors;
  ``perplexity.calibrate_p`` turns their distances into a distribution
  p_{.|q}; each query starts at the p-weighted mean of its neighbors'
  coordinates and then takes ``cfg.transform_steps`` SGD steps of the
  batch layout's own ``apply_edge_batch`` on one [corpus; queries]
  tensor with ``n_frozen = N``: corpus rows pull and push the queries,
  but their updates are -0.0, so the fitted coordinates keep their bits.
  A query's positive edge is drawn from p_{.|q}, its negatives from the
  fitted noise sampler.  The steps run ``cfg.steps_per_dispatch`` a
  dispatch through the layout's ``StepChunks`` (the JAX package scans
  them in ``_project_scan``); on the card its graphs are kept across
  calls, one unit a shape (:func:`_query_unit`).
* :func:`knn_insert` grows the (N, K) KNN graph by Q new points without
  a rebuild: the new rows merge their corpus top-k with a query-vs-query
  top-k, corpus rows adopt new points through a reverse-candidate
  scatter, and ``neighbor_explore(rows=touched)`` repairs only the rows
  that changed.

Both back :class:`repro_torch.LargeVis`'s ``transform`` and ``insert``.
"""
from __future__ import annotations

import collections
import functools

import torch

from repro_torch.configs.largevis_default import LargeVisConfig
from repro_torch.core import knn as knn_lib
from repro_torch.core import neighbor_explore as explore_lib
from repro_torch.core import perplexity as perp_lib
from repro_torch.core import layout_engine
from repro_torch.core.largevis import seeded_generator
from repro_torch.core.layout_engine import apply_edge_batch
from repro_torch.core.sampler import NodeSampler
from repro_torch.kernels import ops

# projection units kept on the card, most recently used last
_UNITS: collections.OrderedDict = collections.OrderedDict()
MAX_UNITS = 8


def uniform_node_sampler(n: int, device) -> NodeSampler:
    """Uniform noise over n nodes as a degenerate alias table (threshold 1:
    every draw keeps its uniform bin); the noise sampler when the fitted
    one is not at hand."""
    return NodeSampler(threshold=torch.ones(n, device=device),
                       alias=torch.arange(n, dtype=torch.int32,
                                          device=device), n_nodes=n)


def query_neighbors(x_new, x, k: int):
    """Each query's k nearest corpus points: ids (Q, k) int32, sqdists
    (Q, k) f32, ascending.  One streaming distance -> top-k call (a group
    of one, as ``knn.brute_force_knn`` calls it): no (Q, N) matrix."""
    ids, dist = ops.topk_sqdist(x_new[None], x[None], k)
    return ids[0], dist[0]


def _weighted_mean_init(p, nn_idx, y):
    """Each query at the p-weighted mean of its neighbors' coordinates."""
    return torch.einsum("qk,qks->qs", p, y[nn_idx.long()])


def sample_query_edges(generator, p, nn_idx, neg_sampler, n_negatives: int):
    """One positive and M negatives per query row.

    The positive is neighbor column c of the row with probability
    p[row, c] (one categorical draw per row, argmax of p / Exp(1), the
    draw ``torch.multinomial(p, 1)`` makes, without its host-side check
    of p, which a captured step cannot have); the negatives come from the
    noise sampler, and a negative equal to the positive is masked, as in
    ``layout_engine.sgd_edge_step``.  Returns (j, negs, neg_mask)."""
    expo = torch.empty_like(p).exponential_(1.0, generator=generator)
    cols = torch.div(p, expo).argmax(1, keepdim=True)            # (Q, 1)
    j = torch.gather(nn_idx, 1, cols)[:, 0]
    negs = neg_sampler.sample(generator, (p.shape[0], n_negatives))
    neg_mask = (negs != j[:, None]).float()
    return j, negs, neg_mask


def project(x_new, *, x, y, generator=None, cfg: LargeVisConfig | None = None,
            neg_sampler=None):
    """Project queries into a fitted layout; the corpus never moves.

    x_new (Q, d) queries; x (N, d) the fitted corpus; y (N, s) its layout,
    which is read and never written.  ``neg_sampler`` is the fitted noise
    sampler (uniform when absent).  ``generator`` (on y's device; default
    seeded with ``cfg.seed``) draws every edge.

    Returns ``(y_new (Q, s), aux)`` with ``aux = {nn_idx, nn_dist, p}``,
    the query neighborhoods that :func:`knn_insert` reuses.
    """
    cfg = cfg if cfg is not None else LargeVisConfig()
    dev = y.device
    n = x.shape[0]
    k = min(cfg.n_neighbors, n)
    q = x_new.shape[0]
    if q == 0:
        return torch.zeros((0, y.shape[1]), dtype=y.dtype, device=dev), {
            "nn_idx": torch.zeros((0, k), dtype=torch.int32, device=dev),
            "nn_dist": torch.zeros((0, k), device=dev),
            "p": torch.zeros((0, k), device=dev)}
    if generator is None:
        generator = seeded_generator(dev, cfg.seed)
    nn_idx, nn_dist = query_neighbors(x_new, x, k)
    p = perp_lib.calibrate_p(nn_dist, min(cfg.perplexity, float(k)),
                             iters=cfg.perplexity_iters)
    y_full = torch.cat([y.float(), _weighted_mean_init(p, nn_idx, y).float()])
    if neg_sampler is None:
        neg_sampler = uniform_node_sampler(n, dev)
    steps = int(cfg.transform_steps)
    lrs = layout_engine.lr_table(cfg.transform_rho0 or cfg.rho0, steps, dev)
    H = layout_engine.dispatch_steps(int(cfg.steps_per_dispatch),
                                     n_nodes=n + q, batch=q,
                                     backend=dev.type)
    unit = _query_unit(n, q, k, y_full.shape[1], dev, cfg, H)
    unit.y.copy_(y_full)
    unit.p.copy_(p)
    unit.nn_idx.copy_(nn_idx)
    unit.neg.threshold.copy_(neg_sampler.threshold)
    unit.neg.alias.copy_(neg_sampler.alias)
    if H > 1:
        unit.chunks.run_all(generator, lrs)
    else:
        for t in range(steps):
            unit.step(unit.y, generator, lr=lrs[t])
    return unit.y[n:].clone(), {"nn_idx": nn_idx, "nn_dist": nn_dist,
                                "p": p}


class _QueryUnit:
    """The projection's state for one shape: [corpus; queries] ``y``, the
    queries' neighbors ``nn_idx`` and distribution ``p``, the noise
    tables ``neg``, one frozen-corpus step over them, and with H > 1 its
    ``StepChunks``."""

    def __init__(self, n: int, q: int, k: int, s: int, dev, cfg, H: int):
        f32, i32 = dict(dtype=torch.float32, device=dev), dict(
            dtype=torch.int32, device=dev)
        self.y = torch.empty((n + q, s), **f32)
        self.p = torch.empty((q, k), **f32)
        self.nn_idx = torch.empty((q, k), **i32)
        self.neg = NodeSampler(torch.empty(n, **f32), torch.empty(n, **i32),
                               n)
        self.step = functools.partial(
            _query_step, i=n + torch.arange(q, **i32), p=self.p,
            nn_idx=self.nn_idx, neg_sampler=self.neg,
            n_negatives=cfg.n_negatives, prob_fn=cfg.prob_fn, a=cfg.prob_a,
            gamma=cfg.gamma, clip=cfg.grad_clip,
            layout_step=cfg.routing.layout_step, n_frozen=n)
        if H > 1:
            self.chunks = layout_engine.StepChunks(self.step, self.y, H)


def _query_step(y, generator, *, lr, i, p, nn_idx, neg_sampler,
                n_negatives: int, n_frozen: int, **kw):
    """One frozen-corpus SGD step of the queries, y updated in place."""
    j, negs, neg_mask = sample_query_edges(generator, p, nn_idx,
                                           neg_sampler, n_negatives)
    apply_edge_batch(y, i, j, negs, neg_mask, lr, n_frozen=n_frozen, **kw)


def _query_unit(n: int, q: int, k: int, s: int, dev, cfg, H: int):
    """A :class:`_QueryUnit` with its ``StepChunks`` graphs.  On the CPU a
    fresh one each call; on the card one kept for each (N, Q, k, s, H,
    step hyper-parameters), at most ``MAX_UNITS``, so a graph is captured
    once a shape and each call copies its inputs into the unit."""
    if dev.type != "cuda":
        return _QueryUnit(n, q, k, s, dev, cfg, H)
    key = (dev, n, q, k, s, H, cfg.n_negatives, cfg.prob_fn, cfg.prob_a,
           cfg.gamma, cfg.grad_clip, cfg.routing.layout_step)
    unit = _UNITS.pop(key, None)
    if unit is None:
        unit = _QueryUnit(n, q, k, s, dev, cfg, H)
    _UNITS[key] = unit
    while len(_UNITS) > MAX_UNITS:
        _UNITS.popitem(last=False)
    return unit


# ---------------------------------------------------------------------------
# incremental KNN graph maintenance
# ---------------------------------------------------------------------------

def _reverse_candidates(dst, src, dist, n: int, r_cap: int):
    """Scatter directed candidate edges (src -> dst) into per-``dst`` slots.

    ``neighbor_explore.reverse_neighbors``'s sorted scatter (stable sort by
    destination, rank within the segment, cap at ``r_cap``) carrying each
    candidate's distance along.  A row with more than ``r_cap`` candidates
    gets its last slot cleared, as the JAX version's scatter leaves it.
    Empty slots hold the row's own index at INF distance, inert under
    ``merge_candidates``."""
    dev = dst.device
    order = torch.sort(dst, stable=True).indices
    dst_s, src_s, d_s = dst[order].long(), src[order], dist[order]
    seg_start = torch.searchsorted(dst_s, torch.arange(n, device=dev))
    rank = torch.arange(dst.shape[0], device=dev) - seg_start[dst_s]
    keep = rank < r_cap
    ids = torch.full((n, r_cap), -1, dtype=torch.int32, device=dev)
    ds = torch.full((n, r_cap), knn_lib.INF, dtype=torch.float32, device=dev)
    ids[dst_s[keep], rank[keep]] = src_s[keep].to(torch.int32)
    ds[dst_s[keep], rank[keep]] = d_s[keep].float()
    over = torch.bincount(dst_s, minlength=n) > r_cap
    ids[over, r_cap - 1] = -1
    ds[over, r_cap - 1] = knn_lib.INF
    rows = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    return torch.where(ids < 0, rows, ids), ds


def _insert_merge(x, knn_idx, knn_dist, x_new, qc_idx, qc_dist, *, k: int):
    """The merge step of :func:`knn_insert`: the (N+Q, k) graph.

    Query rows: their corpus top-k merged with a query-vs-query top-k
    (global ids N..N+Q-1; self is suppressed by the merge).  Corpus rows:
    their lists merged with the reverse candidates that the queries'
    corpus neighborhoods induce.  Returns (idx, dist, changed (N,) bool)."""
    n, q = x.shape[0], x_new.shape[0]
    dev = x.device
    self_q = n + torch.arange(q, dtype=torch.int32, device=dev)

    qq_idx, qq_dist = ops.topk_sqdist(x_new, x_new, min(k, q))
    q_ids = torch.cat([qc_idx.to(torch.int32), n + qq_idx], dim=1)
    q_ds = torch.cat([qc_dist, qq_dist], dim=1)
    q_idx, q_dist = knn_lib.merge_candidates(q_ids, q_ds, k, self_idx=self_q)

    rev_ids, rev_ds = _reverse_candidates(
        qc_idx.reshape(-1), self_q.repeat_interleave(qc_idx.shape[1]),
        qc_dist.reshape(-1), n, r_cap=min(k, max(q, 1)))
    c_ids = torch.cat([knn_idx, rev_ids], dim=1)
    c_ds = torch.cat([knn_dist, rev_ds], dim=1)
    c_idx, c_dist = knn_lib.merge_candidates(
        c_ids, c_ds, k,
        self_idx=torch.arange(n, dtype=torch.int32, device=dev))

    changed = ((c_idx != knn_idx) | (c_dist != knn_dist)).any(dim=1)
    return (torch.cat([c_idx, q_idx]), torch.cat([c_dist, q_dist]),
            changed)


def knn_insert(x, knn_idx, knn_dist, x_new, *, generator=None,
               cfg: LargeVisConfig | None = None, qc_idx=None, qc_dist=None):
    """Insert Q new points into an (N, K) KNN graph without a rebuild.

    Returns ``(x_all (N+Q, d), knn_idx (N+Q, K), knn_dist (N+Q, K))``.
    (1) One streaming top-k gives each new point its corpus neighborhood
    (or ``qc_idx``/``qc_dist`` from :func:`project`); (2)
    :func:`_insert_merge` splices the new rows in and lets corpus rows
    adopt closer new points; (3) one round of neighbor exploring (the
    JAX package's default ``explore_iters=1``) over only the touched
    rows (new rows and corpus rows whose lists changed) repairs
    second-order effects.  ``generator`` draws the
    exploring's candidate sample when ``cfg.explore_sample`` is set.
    """
    cfg = cfg if cfg is not None else LargeVisConfig()
    n, k = knn_idx.shape
    q = x_new.shape[0]
    if q == 0:
        return x, knn_idx, knn_dist
    x_new = x_new.to(x.dtype)
    if qc_idx is None:
        qc_idx, qc_dist = query_neighbors(x_new, x, k)
    x_all = torch.cat([x, x_new])
    idx_all, dist_all, changed = _insert_merge(
        x, knn_idx, knn_dist, x_new, qc_idx, qc_dist, k=k)
    if generator is None:
        generator = seeded_generator(x.device, cfg.seed)
    touched = torch.cat([torch.nonzero(changed).flatten(),
                         torch.arange(n, n + q, device=x.device)])
    idx_all, dist_all = explore_lib.neighbor_explore(
        x_all, idx_all, dist_all, sample=cfg.explore_sample,
        generator=generator, rows=touched)
    return x_all, idx_all, dist_all
