"""Sharded KNN-graph construction over the data mesh (paper §3.1 at scale).

The single-device pipeline (``core/knn.py``) holds all N points on one
device.  Here every rank owns one contiguous slab of ``rows_per_shard``
points (``runtime/sharding.py``) and the graph is built with a fixed
footprint a rank:

1. **Codes**: each rank codes its own slab by the sign of its products
   with the shared hyperplanes (drawn once, broadcast from rank 0).
2. **Ring pass**: the slabs go round the ring (``DataMesh.ring_shift``);
   at each of the P ring steps a rank folds the slab it holds through
   the streaming distance -> top-k kernel (``ops.topk_sqdist``):
   padding, self pairs and bucket mismatches are masked inside the fold,
   and no (N, N) matrix or gathered candidate buffer exists; the P
   (n_loc, k) lists merge in slab order (``ring_fold``).  Exact mode
   (``n_trees=0``) folds with no codes: the brute-force graph.
3. **Sharded neighbor exploring**: ``neighbor_explore.
   sharded_explore_round`` gathers the (N, K) graph, forms each local
   row's forward and reverse candidates, and fills their distances in a
   second ring pass over the slabs.

Every rank calls :func:`build_knn_graph_sharded` with the same points
and gets the same global graph.  The result does not depend on the
shard count: ties break by id in the merge, the kernel sums each
distance in feature order, and the codes are summed in feature order
too (:func:`slab_codes`).
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import knn as knn_lib
from repro_torch.core.neighbor_explore import sharded_explore_round
from repro_torch.kernels import ops
from repro_torch.kernels.ref import total_order
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.fault_tolerance import fire_per_shard


def slab_codes(x: torch.Tensor, proj: torch.Tensor, n_trees: int,
               depth: int) -> torch.Tensor:
    """``knn.hash_codes`` of the rows of ``x`` with the hyperplanes
    ``proj`` (d, n_trees*depth), each product summed in feature order
    (every product and sum rounded on its own).  A library product picks
    its summation order by the shape (on the card, cuBLAS's kernel for
    the row count), which would let a point near a plane take another
    side at another shard count."""
    N, d = x.shape
    xf, pf = x.float(), proj.to(x.device, torch.float32)
    acc = xf[:, :1] * pf[0]
    for q in range(1, d):
        acc = acc + xf[:, q:q + 1] * pf[q]
    bits = (acc > 0.0).reshape(N, n_trees, depth).to(torch.int32)
    weights = 1 << torch.arange(depth, dtype=torch.int32, device=x.device)
    return (bits * weights).sum(-1).to(torch.int32)


def explore_generator(device, seed: int, rank: int, it: int):
    """The generator of rank ``rank``'s exploring round ``it`` (drawn
    from only when ``explore_sample > 0``)."""
    mixed = ((int(seed) * 1_000_003 + rank) * 1_000_003 + it) % 2**63
    return torch.Generator(device=device).manual_seed(mixed)


def ring_fold(mesh, x_loc, ids_loc, codes, k: int, n_real: int):
    """The ring pass: each of the P slabs in turn (this rank's own first,
    then the one the previous rank held, the slab, its codes and its ids
    shifted one rank along the ring between folds) folded by one
    ``topk_sqdist`` launch into a (n_loc, k) list of its own, and the P
    lists merged in slab order.  Padding ids (>= ``n_real``) are masked
    to -1.

    The JAX package carries one running state from fold to fold.  A
    carried state breaks a distance tie by arrival, and the slabs arrive
    in another order at every rank and shard count, so on the card 19 of
    the 15M slots of the 100,000-point graph differed between one shard
    and two.  The merge in slab order, stable in the kernel's total
    order of similarities, breaks every tie by id, as the single fold of
    one shard does: the graph is the same at every shard count."""
    P = mesh.size
    parts = [None] * P
    rx, rc, rid = x_loc, codes, ids_loc
    for step in range(P):
        rid_eff = torch.where(rid >= n_real, -1, rid)
        parts[(mesh.rank - step) % P] = ops.topk_sqdist(
            x_loc, rx, k, a_ids=ids_loc, b_ids=rid_eff, codes_a=codes,
            codes_b=rc)
        if step + 1 < P:
            rx = mesh.ring_shift(rx)
            rid = mesh.ring_shift(rid)
            if codes is not None:
                rc = mesh.ring_shift(rc)
    return parts[0] if P == 1 else merge_slab_lists(parts, k)


def merge_slab_lists(parts, k: int):
    """The k best of the slabs' (ids, sqdists) lists ``parts``, in slab
    order: a stable sort of the (n_loc, P*k) concatenation in the
    kernel's total order, so a distance tie goes to the earlier slab,
    the lower id.  At its peak it holds 4-byte ids, distances, keys and
    sorted keys and the sort's 8-byte order: about 24 P k bytes a row."""
    ids = torch.cat([p[0] for p in parts], dim=1)
    dist = torch.cat([p[1] for p in parts], dim=1)
    order = torch.sort(total_order(-dist), dim=1, descending=True,
                       stable=True).indices[:, :k]
    return torch.gather(ids, 1, order), torch.gather(dist, 1, order)


def build_knn_graph_sharded(x: torch.Tensor, cfg, *, mesh=None,
                            generator: torch.Generator | None = None,
                            proj: torch.Tensor | None = None, fault=None,
                            timings: dict | None = None):
    """Sharded ``knn.build_knn_graph``: (idx (N, K) int32, sqdist (N, K)
    f32), the same on every rank.

    ``mesh`` defaults to ``make_data_mesh(cfg.data_shards)`` on x's
    device.  N need not divide the shard count: the slabs are padded
    with zero rows whose ids are masked before any top-k.  ``proj``
    (d, max(n_trees, 1)*depth) fixes the hyperplanes; without it they
    are drawn from ``generator``, which then draws the seed of the
    exploring rounds' generators.  ``fault`` fires the per-shard
    ``knn_ring_step:<s>`` sites before the ring (a shard fault raises
    ``ShardFailedError``, stage ``"knn"``).  ``timings``, when given,
    receives ``ring_s`` and ``explore_s``.
    """
    if mesh is None:
        from repro_torch.launch.mesh import make_data_mesh
        mesh = make_data_mesh(cfg.data_shards, device=x.device)
    dev = mesh.device
    x = x.to(dev, torch.float32)
    P = mesh.size
    N, d = x.shape
    k = min(cfg.n_neighbors, N - 1)
    depth = cfg.tree_depth or knn_lib._auto_depth(N, cfg.leaf_target)
    if proj is None:
        proj = torch.randn((d, max(cfg.n_trees, 1) * depth),
                           generator=generator, device=dev)
    seed = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                         device=dev)
    proj = mesh.broadcast(proj.to(dev, torch.float32))
    seed = int(mesh.broadcast(seed))
    n_loc = sh.rows_per_shard(N, P)
    lo = mesh.rank * n_loc
    x_loc = sh.shard_rows(x, mesh)
    ids_loc = torch.arange(lo, lo + n_loc, dtype=torch.int32, device=dev)
    codes = (slab_codes(x_loc, proj, cfg.n_trees, depth) if cfg.n_trees
             else None)
    fire_per_shard(fault, "knn_ring_step", P, stage="knn")
    t0 = time.perf_counter()
    bi, bd = ring_fold(mesh, x_loc, ids_loc, codes, k, N)
    _sync(dev)
    t1 = time.perf_counter()
    for it in range(cfg.n_explore_iters):
        bi, bd = sharded_explore_round(
            mesh, x_loc, ids_loc, bi, bd, n_real=N,
            generator=explore_generator(dev, seed, mesh.rank, it),
            sample=cfg.explore_sample)
    idx, dist = mesh.all_gather(bi)[:N], mesh.all_gather(bd)[:N]
    _sync(dev)
    if timings is not None:
        timings.update(ring_s=t1 - t0, explore_s=time.perf_counter() - t1)
    return idx, dist


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
