"""LargeVis on PyTorch: data matrix in, 2-D/3-D layout out.

    from repro_torch import largevis
    result = largevis(x, device="cuda")   # x: (N, d) array or tensor
    coords = result.y                      # (N, 2) tensor on the device

The pipeline is the paper's two stages, on one device: (1) the
approximate KNN graph (projection forest + neighbor exploring) and its
perplexity-calibrated weights, (2) the alias samplers and the
edge-sampling SGD layout, ``cfg.steps_per_dispatch`` steps a CUDA graph
replay.  ``callback(t, steps, y)`` (visual progress) selects the
per-step loop, as in the JAX package.  Each stage is timed after
``torch.cuda.synchronize()``, so the timings split the work honestly.

The entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, the plain versions of the kernels); without CUDA and
without that request they raise.  Randomness comes from
``torch.Generator``s on the device: the graph stage's seeded with
``cfg.seed``, the layout's with ``cfg.seed + 1``.  TF32 is switched off
for matrix products and convolutions: a TF32 product in ``hash_codes``
flips code bits.  That is the port's one environment pin: the JAX
package's ``runtime/platform.py`` sets XLA flags and has no counterpart.
``cfg.routing.autotune`` sets the tile tuner's mode
(``runtime/autotune.py``) at each entry point, as in the JAX package.

Crash safety, as in the JAX package: with ``cfg.checkpoint`` each stage
boundary (``graph``, ``weights``, ``samplers``, and the layout every
``every_chunks`` dispatches) is written atomically, and rerunning the
same call after a crash restores each completed stage from disk and
gives a bitwise-identical embedding.  ``fault`` takes a
:class:`~repro_torch.runtime.fault_tolerance.FaultInjector`, fired after
each stage boundary commits (``stage:graph``, ``stage:weights``,
``stage:samplers``) and in the layout (``layout_chunk``,
``layout_saved``).

Distributed (``cfg.distributed``): every rank of a ``torch.distributed``
process group calls the same entry point with the same ``x`` and config,
and every stage runs on the data mesh of ``cfg.data_shards`` ranks
(``launch/mesh.py``): the ring KNN and its exploring round
(``core/knn_sharded.py``; ``routing.knn_stage="forest"`` keeps the
single-device forest for this stage), the row-parallel weights, the
per-shard samplers and the local-SGD layout.  The result is global and
the same on every rank; ranks outside a smaller mesh receive it by
broadcast.  A shard failure (``ShardFailedError``) halves the mesh with
one ``DegradedModeWarning`` and re-enters from the last committed stage;
at one shard it propagates.  With no process group, the mesh is a world
of one.
"""
from __future__ import annotations

import dataclasses
import signal
import time
import warnings

import numpy as np
import torch

from repro_torch.checkpoint import largevis_state as lvs
from repro_torch.configs.largevis_default import LargeVisConfig
from repro_torch.core import knn as knn_lib
from repro_torch.core import layout as layout_lib
from repro_torch.core import perplexity as perp_lib
from repro_torch.core import sampler as sampler_lib
from repro_torch.runtime import autotune
from repro_torch.runtime.fault_tolerance import (DegradedModeWarning,
                                                 PreemptionGuard,
                                                 ShardFailedError)


@dataclasses.dataclass
class LargeVisResult:
    """Fitted-model carrier: embedding, graph, weights, samplers."""
    y: torch.Tensor                # (N, s) layout
    knn_idx: torch.Tensor          # (N, K) int32
    knn_dist: torch.Tensor         # (N, K) squared distances
    weights: torch.Tensor          # (N, K) symmetrized edge weights
    timings: dict
    edge_samples: int
    x: torch.Tensor | None = None  # (N, d) corpus points
    edge_sampler: sampler_lib.EdgeSampler | None = None
    neg_sampler: sampler_lib.NodeSampler | None = None
    cfg: LargeVisConfig | None = None
    # the layout's SGD steps and how they were dispatched
    steps: int = 0
    steps_per_dispatch: int = 0
    dispatches: int = 0


def resolve_device(device) -> torch.device:
    """The device to run on; "cuda" (the default) raises without CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "the plain versions of the kernels on the CPU")
    if dev.type == "cuda":
        # full f32 products: TF32 flips hash-code bits near the hyperplanes
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def as_tensor(v, device, dtype=None) -> torch.Tensor:
    """``v`` (array or tensor) on ``device``; numpy input is copied, so a
    read-only array never backs a tensor."""
    if not torch.is_tensor(v):
        v = torch.from_numpy(np.array(v))
    return v.to(device=device, dtype=dtype)


def seeded_generator(device, seed: int) -> torch.Generator:
    """A torch.Generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _apply_autotune_mode(cfg: LargeVisConfig) -> None:
    """Honour ``cfg.routing.autotune`` for this process: "auto" leaves
    the mode to the ``AUTOTUNE`` variable (default "cache"), anything
    else pins it (``runtime/autotune.py``)."""
    m = cfg.routing.autotune
    autotune.set_mode(None if m in ("auto", None) else m)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stage_ckpt(data, generator, cfg: LargeVisConfig, proj=None):
    """StageCheckpointer for the graph-prep stages, else None.

    The fingerprint binds a strided sample of the stage's input data
    (and of the forest's hyperplanes when they are given), the
    generator's entry state and the cfg: resuming a stage against other
    points would silently hand the next stage another dataset's graph."""
    if cfg.checkpoint is None:
        return None
    fp = lvs.run_fingerprint(data, generator, cfg)
    if proj is not None:
        fp += "-" + lvs.run_fingerprint(proj, None, cfg)
    return lvs.StageCheckpointer(cfg.checkpoint, fp)


def _data_mesh(cfg: LargeVisConfig, dev: torch.device, mesh=None):
    """The data mesh every distributed stage shares (None without
    ``cfg.distributed``)."""
    if not cfg.distributed:
        return None
    if mesh is None:
        from repro_torch.launch.mesh import make_data_mesh
        mesh = make_data_mesh(cfg.data_shards, device=dev)
    return mesh


def build_graph(x, *, cfg: LargeVisConfig | None = None, device="cuda",
                generator: torch.Generator | None = None, proj=None,
                fault=None, mesh=None):
    """Stage 1: KNN graph + calibrated weights.

    Returns (idx, dist, weights, timings): ``knn_s`` and ``weights_s``,
    and on the ring ``knn_ring_s`` and ``knn_explore_s``.  ``proj``
    (d, n_trees*depth) fixes the forest's or the ring's hyperplanes.
    With ``cfg.distributed`` the stages run on ``mesh`` (default: the
    data mesh of ``cfg.data_shards``).  With ``cfg.checkpoint`` the
    graph and the weights are each written at their boundary (by mesh
    rank 0) and restored on a rerun (inside the stage's timing), on any
    mesh; ``fault`` fires ``stage:graph`` / ``stage:weights`` after each
    boundary commits, and the sharded stages' per-shard sites."""
    cfg = cfg if cfg is not None else LargeVisConfig()
    _apply_autotune_mode(cfg)
    dev = resolve_device(device)
    mesh = _data_mesh(cfg, dev, mesh)
    if mesh is not None:
        dev = mesh.device
    x = as_tensor(x, dev, torch.float32)
    if proj is not None:
        proj = as_tensor(proj, dev, torch.float32)
    if generator is None:
        generator = seeded_generator(dev, cfg.seed)
    ckpt = _stage_ckpt(x, generator, cfg, proj)
    topo = {"topology": lvs.topology_tag(cfg, x.shape[0], mesh)}
    writer = mesh is None or mesh.rank == 0
    timings: dict = {}
    _sync(dev)
    t0 = time.perf_counter()
    cached = (ckpt.restore("graph", dev, mesh=mesh) if ckpt is not None
              else None)
    if cached is not None:
        idx, dist = cached[0]["idx"], cached[0]["dist"]
    else:
        if mesh is not None and cfg.routing.knn_stage != "forest":
            from repro_torch.core.knn_sharded import build_knn_graph_sharded
            idx, dist = build_knn_graph_sharded(
                x, cfg, mesh=mesh, generator=generator, proj=proj,
                fault=fault, timings=timings)
        else:
            idx, dist = knn_lib.build_knn_graph(
                x, dataclasses.replace(cfg, distributed=False),
                generator=generator, proj=proj)
        _sync(dev)
        if ckpt is not None and writer:
            ckpt.save("graph", {"idx": idx, "dist": dist}, extra=topo)
        if mesh is not None:
            mesh.barrier()
        if fault is not None:
            fault.fire("stage:graph")
    _sync(dev)
    t1 = time.perf_counter()
    cached = (ckpt.restore("weights", dev, mesh=mesh)
              if ckpt is not None and cached is not None else None)
    if cached is not None:
        w = cached[0]["w"]
    else:
        if mesh is not None:
            w = perp_lib.edge_weights_sharded(idx, dist, cfg.perplexity,
                                              iters=cfg.perplexity_iters,
                                              mesh=mesh, fault=fault)
        else:
            w = perp_lib.edge_weights(idx, dist, cfg.perplexity,
                                      iters=cfg.perplexity_iters)
        _sync(dev)
        if ckpt is not None and writer:
            ckpt.save("weights", {"w": w}, extra=topo)
        if mesh is not None:
            mesh.barrier()
        if fault is not None:
            fault.fire("stage:weights")
    _sync(dev)
    t2 = time.perf_counter()
    out = {"knn_s": t1 - t0, "weights_s": t2 - t1}
    out.update({f"knn_{k}": v for k, v in timings.items()})
    return idx, dist, w, out


def layout_graph(knn_idx, weights, *, cfg: LargeVisConfig | None = None,
                 device="cuda", generator: torch.Generator | None = None,
                 callback=None, return_samplers: bool = False, fault=None,
                 mesh=None):
    """Stage 2: alias samplers + SGD layout of a weighted KNN graph.

    Returns (LayoutResult, timings), or (LayoutResult, (edge_sampler,
    neg_sampler), timings) with ``return_samplers``.  With ``cfg.checkpoint``
    the alias tables are written at the stage boundary (``samplers``)
    and restored on a rerun (inside ``sampler_s``), and the layout
    checkpoints itself (see ``run_layout``); ``fault`` fires
    ``stage:samplers`` after the boundary commits and goes on into the
    layout.

    With ``cfg.distributed`` the tables are built a shard a rank
    (``sampler.build_samplers_sharded``) and the layout runs local SGD
    (``layout.run_layout_local_sgd``, round-granular checkpoints; a
    world of one runs ``run_layout``; ``callback`` is not called), as in
    the JAX package: the sampler
    build is not checkpointed (it is cheap to redo) and the samplers come
    back as ``(None, None)``."""
    cfg = cfg if cfg is not None else LargeVisConfig()
    _apply_autotune_mode(cfg)
    dev = resolve_device(device)
    mesh = _data_mesh(cfg, dev, mesh)
    if mesh is not None:
        dev = mesh.device
    knn_idx = as_tensor(knn_idx, dev)
    weights = as_tensor(weights, dev, torch.float32)
    if generator is None:
        generator = seeded_generator(dev, cfg.seed + 1)
    if mesh is not None:
        _sync(dev)
        t0 = time.perf_counter()
        edge_s, neg_s = sampler_lib.build_samplers_sharded(
            knn_idx, weights, power=cfg.neg_power, mesh=mesh)
        _sync(dev)
        t1 = time.perf_counter()
        res = layout_lib.run_layout_local_sgd(
            generator, edge_s, neg_s, knn_idx.shape[0], cfg, mesh,
            fault=fault, weights=weights)
        _sync(dev)
        timings = {"sampler_s": t1 - t0,
                   "layout_s": time.perf_counter() - t1}
        if return_samplers:
            return res, (None, None), timings
        return res, timings
    ckpt = _stage_ckpt(weights, generator, cfg)
    _sync(dev)
    t0 = time.perf_counter()
    cached = ckpt.load("samplers") if ckpt is not None else None
    if cached is not None:
        tree, _, extra = cached
        edge_s, neg_s = lvs._samplers_from_tree(
            tree, extra["sampler_static"], dev)
    else:
        edge_s = sampler_lib.build_edge_sampler(knn_idx, weights)
        neg_s = sampler_lib.build_negative_sampler(knn_idx, weights,
                                                   power=cfg.neg_power)
        _sync(dev)
        if ckpt is not None:
            tree, static = lvs._samplers_to_tree(edge_s, neg_s)
            ckpt.save("samplers", tree, extra={"sampler_static": static})
        if fault is not None:
            fault.fire("stage:samplers")
    _sync(dev)
    t1 = time.perf_counter()
    res = layout_lib.run_layout(generator, edge_s, neg_s, knn_idx.shape[0],
                                cfg, device=dev, callback=callback,
                                fault=fault)
    _sync(dev)
    t2 = time.perf_counter()
    timings = {"sampler_s": t1 - t0, "layout_s": t2 - t1}
    if return_samplers:
        return res, (edge_s, neg_s), timings
    return res, timings


def largevis(x, *, cfg: LargeVisConfig | None = None, device="cuda",
             proj=None, callback=None, fault=None) -> LargeVisResult:
    """Run the full pipeline; see the module docstring.

    While ``cfg.checkpoint`` is set a
    :class:`~repro_torch.runtime.fault_tolerance.PreemptionGuard` is
    armed: SIGTERM/SIGINT saves the newest layout chunk boundary, and
    the process then exits by the signal.

    With ``cfg.distributed``, a :class:`ShardFailedError` (a per-shard
    fault site) is met with one :class:`DegradedModeWarning`, the mesh
    rebuilt with ``data_shards`` P -> max(1, P // 2), and a new pass that
    restores every committed stage (with ``cfg.checkpoint``); the ranks
    left outside the smaller mesh wait for its result.  At one shard the
    error propagates.  An injector's hit counts persist across the retry,
    so the same injected fault does not fire again."""
    cfg = cfg if cfg is not None else LargeVisConfig()
    _apply_autotune_mode(cfg)
    dev = resolve_device(device)
    guard = None
    if cfg.checkpoint is not None and PreemptionGuard.active() is None:
        guard = PreemptionGuard(signals=(signal.SIGTERM, signal.SIGINT),
                                exit_after_save=True).activate()
    try:
        while True:
            mesh = _data_mesh(cfg, dev)
            try:
                if mesh is not None and not mesh.in_mesh:
                    return _receive_result(mesh, x, cfg)
                res = _largevis_once(x, cfg=cfg, device=dev, proj=proj,
                                     callback=callback, fault=fault,
                                     mesh=mesh)
                if mesh is not None:
                    _share_result(mesh, res)
                return res
            except ShardFailedError as e:
                if mesh is None or mesh.size <= 1:
                    raise           # nothing left to shed: a real failure
                shards = max(1, mesh.size // 2)
                warnings.warn(DegradedModeWarning(
                    e.stage, f"mesh[{mesh.size}]", f"mesh[{shards}]", e),
                    stacklevel=2)
                cfg = dataclasses.replace(cfg, data_shards=shards)
    finally:
        if guard is not None:
            guard.restore_handlers()


def _largevis_once(x, *, cfg, device, proj, callback, fault, mesh):
    """One pipeline pass, on ``mesh`` when distributed."""
    dev = mesh.device if mesh is not None else device
    x = as_tensor(x, dev, torch.float32)
    idx, dist, w, t_graph = build_graph(x, cfg=cfg, device=dev, proj=proj,
                                        fault=fault, mesh=mesh)
    res, (edge_s, neg_s), t_layout = layout_graph(
        idx, w, cfg=cfg, device=dev, callback=callback,
        return_samplers=True, fault=fault, mesh=mesh)
    return LargeVisResult(y=res.y, knn_idx=idx, knn_dist=dist, weights=w,
                          timings={**t_graph, **t_layout},
                          edge_samples=res.edge_samples, x=x,
                          edge_sampler=edge_s, neg_sampler=neg_s, cfg=cfg,
                          steps=res.steps,
                          steps_per_dispatch=res.steps_per_dispatch,
                          dispatches=res.dispatches)


_SHARED = ("y", "knn_idx", "knn_dist", "weights")
_SCALARS = ("edge_samples", "steps", "steps_per_dispatch", "dispatches")


def _share_result(mesh, res: LargeVisResult) -> None:
    """Rank 0's result to the ranks outside the mesh (a no-op when the
    mesh is the whole world)."""
    from repro_torch.launch.mesh import broadcast_from_mesh
    broadcast_from_mesh(mesh, [getattr(res, f) for f in _SHARED],
                        {"timings": res.timings,
                         **{f: getattr(res, f) for f in _SCALARS}})


def _receive_result(mesh, x, cfg: LargeVisConfig) -> LargeVisResult:
    """The mesh's result on a rank outside it."""
    from repro_torch.launch.mesh import broadcast_from_mesh
    x = as_tensor(x, mesh.device, torch.float32)
    N = x.shape[0]
    K = min(cfg.n_neighbors, N - 1)
    empty = [torch.empty((N, cfg.out_dim), device=mesh.device),
             torch.empty((N, K), dtype=torch.int32, device=mesh.device),
             torch.empty((N, K), device=mesh.device),
             torch.empty((N, K), device=mesh.device)]
    got, meta = broadcast_from_mesh(mesh, empty, None)
    return LargeVisResult(**dict(zip(_SHARED, got)), x=x, cfg=cfg,
                          edge_sampler=None, neg_sampler=None, **meta)
