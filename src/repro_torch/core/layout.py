"""Layout optimization: batched edge-sampling SGD on one device (§3.2).

The paper's asynchronous batch-1 updates become synchronous batches with
a deterministic accumulation order; the paper's own sparsity argument
("conflicting updates are rare") is why the two dynamics agree, as long
as the batch stays below about N/2 (``_collision_capped_batch``).

lr schedule: rho_t = rho0 * (1 - t/T), per-coordinate gradient clip as
in the reference implementation.  The steps run H =
``cfg.steps_per_dispatch`` a dispatch through ``layout_engine.StepChunks``
(a CUDA graph replay a chunk on the card), as the JAX package's
``layout_chunk`` scans them; a ``callback`` or ``steps_per_dispatch <= 1``
selects the per-step loop, which gives the same trajectory.

At the chunk boundaries ``run_layout`` has the JAX package's robustness
hooks: resume from ``y0``/``start_step`` or from the newest layout
checkpoint (``cfg.checkpoint``), the health probe with rollback
(``cfg.health``), the fused -> split demotion of a failing first chunk,
the straggler watchdog, the preemption guard's save, ``on_chunk`` and
the ``layout_chunk``/``layout_saved`` fault sites.  The CUDA graphs read
the unit's ``y`` and lr buffers in place, so a resume, a rollback and a
fault's payload are copied into ``y``, never rebound, and the layout
generator's Philox state is restored with ``set_state``.

``run_layout_local_sgd`` is the data mesh's layout (the JAX package's
local SGD, its form of the paper's asynchronous SGD): every rank keeps a
full replica of y, draws from its own shard of the edge table, runs
``sync_every`` steps and then adds up the replicas' moves.  A world of
one has nothing to add up and runs ``run_layout``; the two layout loops share
the preemption guard's deferral and the fused -> split demotion.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.largevis_state import (AsyncStageWriter,
                                                   StageCheckpointer,
                                                   run_fingerprint)
from repro_torch.core import layout_engine
from repro_torch.core.sampler import ShardedEdgeSampler
from repro_torch.runtime.fault_tolerance import (DegradedModeWarning,
                                                 DivergenceWarning,
                                                 InjectedFault,
                                                 LayoutDivergedError,
                                                 PreemptionGuard,
                                                 TopologyChangeWarning,
                                                 Watchdog, fire_per_shard)


@dataclasses.dataclass
class LayoutResult:
    y: torch.Tensor
    steps: int                       # the steps this call ran
    edge_samples: int
    steps_per_dispatch: int = 1      # 1: the per-step loop
    dispatches: int = 0
    # robustness diagnostics: divergence rollbacks taken, the final lr
    # backoff scale, and the watchdog's straggler dispatches
    rollbacks: int = 0
    rho0_scale: float = 1.0
    stragglers: list = dataclasses.field(default_factory=list)


def layout_health(y: torch.Tensor):
    """The health probe: ``(nonfinite_count, max_abs)`` of y as 0-d
    tensors on its device, two reductions; non-finite entries are left
    out of the max so one NaN cannot hide a norm blowup."""
    finite = torch.isfinite(y)
    return (~finite).sum(), torch.where(finite, y, 0.0).abs().amax()


def _layout_stage_ckpt(generator, n_nodes: int, cfg, edge_sampler=None,
                       table=None):
    """StageCheckpointer for the layout stage, else None.

    The layout trajectory is a function of (samplers, generator, cfg,
    N), so the fingerprint binds all four: the sampler by a strided
    sample of its alias threshold table, the generator by its state at
    the layout's entry.  ``table`` replaces the sampler's table: the
    local-SGD layout passes the global edge weights, which are the same
    on every mesh (a sharded sampler's tables are laid out by shard, and
    would bind the checkpoint to the shard count)."""
    if cfg.checkpoint is None:
        return None
    if table is not None:
        table = table.reshape(-1, 1)
    elif edge_sampler is not None:
        table = edge_sampler.threshold.reshape(-1, 1)
    fp = run_fingerprint(table, generator, cfg) + f"-n{n_nodes}"
    return StageCheckpointer(cfg.checkpoint, fp)


def _collision_capped_batch(batch_size: int, n_nodes: int,
                            total: int = 0) -> int:
    """Cap the batch at ~N/2 nodes (and at the total sample count): with
    larger batches every node collects several stale summed updates per
    step and the layout overshoots (on a 2000-node graph, batch 4096
    drops the KNN-classifier accuracy from 0.98 to 0.74)."""
    cap = max(1, n_nodes // 2)
    if total:
        cap = min(cap, max(total, 1))
    return min(batch_size, cap)


def fused_or_demoted(y, generator, fused, split) -> bool:
    """Run ``fused()``, the fused route's first eager steps on ``y`` from
    ``generator``, so that a failure of the fused kernel (its build, no
    kernel image for the card, a launch configuration) surfaces here.  On
    such a failure y and the generator go back to their state before it,
    ``split()`` runs the same steps on the split route, and one
    :class:`DegradedModeWarning` is raised.  Returns whether it
    demoted."""
    y_before, rng = y.to("cpu", copy=True), generator.get_state()
    try:
        fused()
        return False
    except InjectedFault:
        raise
    except Exception as e:          # a backend failure of the fused step
        if y.is_cuda:
            # waits for the steps queued before the failure; a sticky
            # error (an illegal address) raises again here, and nothing
            # is demoted past it
            torch.cuda.synchronize(y.device)
        warnings.warn(DegradedModeWarning("layout_step", "fused", "split", e),
                      stacklevel=4)
        y.copy_(y_before)
        generator.set_state(rng)
        split()
        return True


def _first_fused_chunk(unit, generator, lrs, split_step):
    """Run the first chunk of the fused route, which runs eagerly (the
    graph recipe's warm-up), through :func:`fused_or_demoted`: on a
    failure the run continues on the split route.  Returns the unit that
    ran."""
    ran = [unit]

    def split():
        ran[0] = layout_engine.StepChunks(split_step, unit.y, unit.H)
        ran[0].run(generator, lrs)

    fused_or_demoted(unit.y, generator, lambda: unit.run(generator, lrs),
                     split)
    return ran[0]


def _defer_signals(stage_ckpt):
    """The active :class:`PreemptionGuard` (armed by ``largevis()``),
    deferring signals, when the layout checkpoints; else None.  The
    handler then only records a signal (it may land inside a capture, or
    beside the writer thread): the loop saves at its next boundary and
    calls ``finish()``."""
    guard = PreemptionGuard.active() if stage_ckpt is not None else None
    if guard is not None:
        guard.defer()
    return guard


def _release_signals(guard) -> None:
    """End the deferral; a signal after the last boundary's check leaves
    now (that boundary was saved by the cadence)."""
    if guard is not None:
        guard.defer(False)
        if guard.pending is not None:
            guard.finish()


def _topology(P: int, n_nodes: int) -> dict:
    return {"distributed": True, "data_shards": P, "n_rows": int(n_nodes)}


def _saved_shards(extra: dict, default: int) -> int:
    """The shard count a layout checkpoint was written on."""
    return int((extra.get("topology") or {}).get("data_shards", default))


def run_layout(generator, edge_sampler, neg_sampler, n_nodes: int, cfg, *,
               device, callback: Optional[Callable] = None, y0=None,
               start_step: int = 0, on_chunk: Optional[Callable] = None,
               fault=None, weights=None) -> LayoutResult:
    """Drive the layout for T = samples_per_node * N edge samples;
    ``generator`` (on ``device``) draws the N(0, init_scale) start and
    every edge and negative sample.

    With ``callback is None`` and H = ``cfg.steps_per_dispatch`` > 1 the
    steps run H a dispatch (full chunks, then the remainder).  Otherwise
    they run one by one, and ``callback(t, steps, y)`` is called every
    ``steps // 20`` steps, as in the JAX package.

    Resume: pass ``y0`` and ``start_step`` with ``generator`` in the state
    step ``start_step`` would find it; the lr positions continue from
    there.  ``on_chunk(t, steps, y)`` fires after every dispatch on the
    chunked path with ``y`` synced (``y`` is the live buffer: clone it to
    keep it).

    Robustness (chunked path), as in the JAX package:

    * ``cfg.checkpoint`` — the layout checkpoints ``{"y", "rng"}`` (the
      generator's state) every ``every_chunks`` dispatches (atomic,
      keep-last-k, fingerprinted); with no ``y0`` it resumes from the
      newest valid checkpoint, so a killed and resumed run is bitwise
      an uninterrupted one.
    * ``cfg.health`` — every ``check_every_chunks`` dispatches the probe
      (:func:`layout_health`) checks y; a divergence (non-finite entries
      or |y| past ``max_abs``) restores y and the generator of the last
      healthy chunk and reruns with rho0 scaled by ``lr_backoff``
      (``DivergenceWarning``), raising ``LayoutDivergedError`` after
      ``max_rollbacks``.
    * degraded mode — a backend failure in the first (eager) chunk of the
      fused route demotes the run to the split route with one
      ``DegradedModeWarning``.
    * a :class:`Watchdog` times every dispatch that is synced anyway
      (health, a fault or ``on_chunk`` set) and lists outliers in
      ``result.stragglers``.  A checkpoint-only run keeps the replays
      queued: its saves go through an :class:`AsyncStageWriter` (an
      on-device snapshot and an event a save), and the watchdog times
      the intervals between snapshots.
    * the active :class:`PreemptionGuard` (armed by ``largevis()``): a
      SIGTERM/SIGINT is held to the next chunk boundary, which is saved
      (after the writer's queued saves) before the process exits by it.
    * ``fault`` — a FaultInjector fired at ``layout_chunk`` (payload y,
      inside the timed window) and ``layout_saved`` (after a commit).

    ``weights`` (the global edge weights) makes this the data mesh's
    layout at one shard (:func:`run_layout_local_sgd` hands its world of
    one here): the checkpoint's fingerprint binds the weights in place of
    the sampler's table, its ``extra`` records the topology and the edge
    samples done, and a checkpoint another shard count wrote resumes
    from the step covering its samples, with one
    :class:`TopologyChangeWarning`.
    """
    health = cfg.health
    stage_ckpt = _layout_stage_ckpt(generator, n_nodes, cfg, edge_sampler,
                                    table=weights)
    total = int(cfg.samples_per_node) * n_nodes
    batch = _collision_capped_batch(cfg.batch_size, n_nodes, total)
    steps = max(1, total // batch)
    rho0_scale, rollbacks = 1.0, 0
    if stage_ckpt is not None and y0 is None and start_step == 0:
        loaded = stage_ckpt.load("layout")
        if loaded is not None:
            tree, start_step, extra = loaded
            y0 = tree["y"]
            saved = _saved_shards(extra, 1)
            if saved == 1:
                generator.set_state(torch.from_numpy(tree["rng"]))
            else:       # its streams were the replicas': start afresh
                start_step = min(int(extra.get("samples_done", 0)) // batch,
                                 steps)
                warnings.warn(TopologyChangeWarning("layout", saved, 1,
                                                    start_step),
                              stacklevel=2)
            rho0_scale = float(extra.get("rho0_scale", 1.0))
            rollbacks = int(extra.get("rollbacks", 0))
    if y0 is None:
        y = torch.randn((n_nodes, cfg.out_dim), generator=generator,
                        device=device) * cfg.init_scale
    else:
        y = torch.as_tensor(y0).to(device=device, dtype=torch.float32,
                                   copy=True)
    start = min(int(start_step), steps)
    step = functools.partial(
        layout_engine.sgd_edge_step, edge_sampler=edge_sampler,
        neg_sampler=neg_sampler,
        n_negatives=cfg.n_negatives, prob_fn=cfg.prob_fn, a=cfg.prob_a,
        gamma=cfg.gamma, clip=cfg.grad_clip, batch=batch,
        layout_step=cfg.routing.layout_step)
    lrs = layout_engine.lr_table(cfg.rho0 * rho0_scale, steps, device)
    H = layout_engine.dispatch_steps(int(cfg.steps_per_dispatch),
                                     n_nodes=n_nodes, batch=batch,
                                     backend=torch.device(device).type)
    watchdog = None
    if callback is None and H > 1:
        # sync each chunk only when something needs it anyway; a
        # checkpoint-only run keeps the replays queued and saves off-thread
        monitored = (on_chunk is not None or health is not None
                     or fault is not None)
        watchdog = (Watchdog() if monitored or stage_ckpt is not None
                    else None)
        writer = None
        if stage_ckpt is not None and not monitored:
            writer = AsyncStageWriter(stage_ckpt, watchdog=watchdog)
        ckpt_cfg = cfg.checkpoint
        keep = max(1, ckpt_cfg.keep) if ckpt_cfg is not None else 1

        def extras(t):
            out = {"rho0_scale": rho0_scale, "rollbacks": rollbacks}
            if weights is not None:
                out.update(topology=_topology(1, n_nodes),
                           samples_done=t * batch)
            return out

        unit = layout_engine.StepChunks(step, y, H)
        fused = (cfg.prob_fn == "inv_quadratic"
                 and cfg.routing.layout_step != "split")
        last_good = None
        if health is not None:
            last_good = (y.clone(), start, generator.get_state())
        t, chunk_i, dispatches = start, 0, 0
        guard = _defer_signals(stage_ckpt)
        try:
            while t < steps:
                h = min(H, steps - t)
                saved = False
                t0 = time.perf_counter()
                if fused and dispatches == 0:
                    unit = _first_fused_chunk(
                        unit, generator, lrs[t:t + h],
                        functools.partial(step, layout_step="split"))
                else:
                    unit.run(generator, lrs[t:t + h])
                dispatches += 1
                t += h
                chunk_i += 1
                if fault is not None:
                    y_f = fault.fire("layout_chunk", y)
                    if y_f is not y:
                        y.copy_(y_f)
                if monitored:
                    if y.is_cuda:
                        torch.cuda.synchronize(y.device)
                    watchdog.observe(t, time.perf_counter() - t0)
                if health is not None and (
                        chunk_i % max(1, health.check_every_chunks) == 0
                        or t >= steps):
                    nf, mx = layout_health(y)
                    nf, mx = int(nf), float(mx)
                    if nf or mx > health.max_abs:
                        rollbacks += 1
                        if rollbacks > health.max_rollbacks:
                            raise LayoutDivergedError(
                                f"layout still diverging after "
                                f"{health.max_rollbacks} rollbacks "
                                f"(step {t}: nonfinite={nf}, "
                                f"max|y|={mx:.3g})")
                        rho0_scale *= health.lr_backoff
                        warnings.warn(DivergenceWarning(
                            t, last_good[1], nf, mx, rho0_scale),
                            stacklevel=2)
                        y.copy_(last_good[0])
                        t = last_good[1]
                        generator.set_state(last_good[2])
                        lrs = layout_engine.lr_table(cfg.rho0 * rho0_scale,
                                                     steps, device)
                        continue
                    last_good[0].copy_(y)
                    last_good = (last_good[0], t, generator.get_state())
                if stage_ckpt is not None and (
                        chunk_i % max(1, ckpt_cfg.every_chunks) == 0
                        or t >= steps):
                    tree = {"y": y, "rng": generator.get_state()}
                    if writer is not None:
                        writer.submit("layout", tree, step=t, keep=keep,
                                      extra=extras(t))
                    else:
                        stage_ckpt.save("layout", tree, step=t, keep=keep,
                                        extra=extras(t))
                        if fault is not None:
                            fault.fire("layout_saved")
                    saved = True
                if on_chunk is not None:
                    on_chunk(t, steps, y)
                if guard is not None and guard.pending is not None:
                    if writer is not None:      # its saves commit first
                        writer.close()
                        writer = None
                    if not saved:
                        stage_ckpt.save(
                            "layout", {"y": y, "rng": generator.get_state()},
                            step=t, keep=keep, extra=extras(t))
                    guard.finish()
        finally:
            try:
                if writer is not None:
                    writer.close()
            finally:
                _release_signals(guard)
    else:
        H, dispatches = 1, steps - start
        for t in range(start, steps):
            step(y, generator, lr=lrs[t])
            if callback is not None and t % max(1, steps // 20) == 0:
                callback(t, steps, y)
    stragglers = list(watchdog.stragglers) if watchdog is not None else []
    # surface stragglers only when the outlier is macroscopic — 3x a
    # sub-millisecond median is host jitter, not a sick device
    if stragglers and max(s[1] for s in stragglers) > 0.1:
        warnings.warn(
            f"layout: {len(stragglers)} straggler dispatch(es) — worst "
            f"{max(s[1] for s in stragglers):.3f}s vs median "
            f"{stragglers[-1][2]:.3f}s (see LayoutResult.stragglers)",
            RuntimeWarning, stacklevel=2)
    done = steps - start
    return LayoutResult(y=y, steps=done, edge_samples=done * batch,
                        steps_per_dispatch=H, dispatches=dispatches,
                        rollbacks=rollbacks, rho0_scale=rho0_scale,
                        stragglers=stragglers)


def _rank_generator(device, seed: int, rank: int, round_: int = 0):
    """The stream of one replica of the local-SGD layout."""
    mixed = ((int(seed) * 1_000_003 + rank) * 1_000_003 + round_) % 2**63
    return torch.Generator(device=device).manual_seed(mixed)


def round_step(edge_sampler, neg_sampler, *, n_negatives: int, batch: int,
               prob_fn: str = "inv_quadratic", a: float = 1.0,
               gamma: float = 7.0, clip: float = 5.0,
               layout_step: str = "auto"):
    """The step of a local-SGD round, ``step(y, generator, lr=)``: one
    ``layout_engine.sgd_edge_step`` of ``batch`` edges from the rank's
    ``edge_sampler`` and its negatives."""
    return functools.partial(
        layout_engine.sgd_edge_step, edge_sampler=edge_sampler,
        neg_sampler=neg_sampler, n_negatives=n_negatives, prob_fn=prob_fn,
        a=a, gamma=gamma, clip=clip, batch=batch, layout_step=layout_step)


def local_sgd_round(unit, y0, mesh, generator, lrs, *, split_step=None):
    """One round of the local-SGD layout on this rank: ``len(lrs)`` steps
    of ``unit`` (a ``layout_engine.StepChunks`` over the rank's replica
    ``unit.y``, one dispatch) drawing from ``generator``, then the
    replicas' sync ``y0 + sum_r (y_r - y0)`` over the mesh's ``"data"``
    ranks in rank order (``DataMesh.all_reduce_sum``), outside the
    dispatch: a sum, not a mean, so every sampled edge's update lands at
    the full lr, as in the paper's Hogwild.  ``y0`` is scratch of y's
    shape.  A data axis of one rank has nothing to add and keeps the
    replica as it is (the ranks of a ``"model"`` row hold the same
    replica, as JAX's ``psum`` over the DP axes leaves them).

    ``split_step`` (the round's step on the split route) marks the fused
    route's first dispatch, which runs through :func:`_first_fused_chunk`
    (a backend failure demotes the run to the split route).  Returns the
    unit that ran, which the next round takes."""
    y = unit.y
    y0.copy_(y)
    if split_step is not None:
        unit = _first_fused_chunk(unit, generator, lrs, split_step)
    else:
        unit.run(generator, lrs)
    if mesh.shape["data"] > 1:
        y.copy_(y0 + mesh.all_reduce_sum(y - y0, "data"))  # Hogwild sum
    return unit


def run_layout_local_sgd(generator, edge_sampler, neg_sampler, n_nodes: int,
                         cfg, mesh, *, fault=None,
                         weights=None) -> LayoutResult:
    """The data mesh's layout: local SGD, the JAX package's form of the
    paper's asynchronous SGD.

    Every rank keeps a full replica of y (the same N(0, init_scale)
    start from ``generator``) and a stream of its own.  A round is
    ``cfg.sync_every`` (H) steps on the replica, one ``StepChunks``
    dispatch (a CUDA graph replay on the card); then the replicas sync by
    a sum of their moves, ``y0 + sum_r (y_r - y0)`` (``DataMesh.
    all_reduce_sum``, outside the graph), not a mean: every sampled
    edge's update lands at the full lr, as in the paper's Hogwild.  The
    global concurrent batch ``batch * P`` is capped at about N/2 (the
    collision argument), split evenly over the replicas.

    A world of one has nothing to sync: it is :func:`run_layout` (with
    ``weights``, so its checkpoints carry the topology), on the shard's
    samplers, which are the flat ones bitwise, with every hook of the
    single-device layout (``cfg.health`` included).

    Samplers: a :class:`~repro_torch.core.sampler.ShardedEdgeSampler`
    gives rank s its shard ``local(s)`` (stratified edge sampling); a
    flat one is drawn whole by every rank.  The negative sampler is drawn
    whole (a sharded one by its two levels).

    ``cfg.checkpoint``: round-granular saves of ``{"y", "rng"}`` (every
    rank's stream state), written by rank 0 and read by every rank, with
    the topology and the committed edge samples in ``extra``.  The
    fingerprint binds the global ``weights`` (the same on every mesh).  A
    checkpoint of the same shard count resumes bitwise; one of another
    count resumes from the round boundary covering its committed samples,
    with fresh streams, and one :class:`TopologyChangeWarning`.

    ``fault`` fires ``layout_round`` and the per-shard
    ``local_sgd_round:<s>`` sites after every round (a shard fault raises
    ``ShardFailedError``, stage ``"layout"``; a callable spec may inflate
    a shard's round time, which its :class:`Watchdog` flags as
    ``(shard, round, dt, median)`` in ``result.stragglers``), and
    ``layout_saved`` after each save.  ``cfg.health`` does not apply at
    P > 1, as in the JAX package.  The first dispatch of the fused route
    demotes to the split route on a backend failure, as in
    :func:`run_layout`.
    """
    P, rank, dev = mesh.size, mesh.rank, mesh.device
    es = (edge_sampler.local(rank)
          if isinstance(edge_sampler, ShardedEdgeSampler) else edge_sampler)
    if P == 1:
        return run_layout(generator, es, neg_sampler, n_nodes, cfg,
                          device=dev, fault=fault, weights=weights)
    stage_ckpt = _layout_stage_ckpt(generator, n_nodes, cfg, edge_sampler,
                                    table=weights)
    y = torch.randn((n_nodes, cfg.out_dim), generator=generator,
                    device=dev) * cfg.init_scale
    seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=dev))
    y = mesh.broadcast(y)
    batch = max(1, _collision_capped_batch(cfg.batch_size * P, n_nodes)
                // P)
    total = int(cfg.samples_per_node) * n_nodes
    steps = max(1, total // (batch * P))
    H = max(1, int(cfg.sync_every))
    n_rounds = max(1, steps // H)
    rank_gen = _rank_generator(dev, seed, rank)
    start = 0
    if stage_ckpt is not None:
        loaded = stage_ckpt.load("layout")
        if loaded is not None:
            tree, saved_step, extra = loaded
            y = torch.as_tensor(tree["y"]).to(dev, torch.float32)
            saved = _saved_shards(extra, P)
            if saved == P:
                start = int(saved_step)
                rank_gen.set_state(torch.from_numpy(tree["rng"][rank]))
            else:
                done = int(extra.get("samples_done", 0))
                start = min(done // (H * batch * P), n_rounds)
                rank_gen = _rank_generator(dev, seed, rank, start)
                warnings.warn(TopologyChangeWarning("layout", saved, P,
                                                    start), stacklevel=2)
    start = min(start, n_rounds)
    step = round_step(es, neg_sampler, n_negatives=cfg.n_negatives,
                      prob_fn=cfg.prob_fn, a=cfg.prob_a, gamma=cfg.gamma,
                      clip=cfg.grad_clip, batch=batch,
                      layout_step=cfg.routing.layout_step)
    lrs = layout_engine.lr_table(cfg.rho0, steps, dev)
    unit = layout_engine.StepChunks(step, y, H)
    fused = (cfg.prob_fn == "inv_quadratic"
             and cfg.routing.layout_step != "split")
    y0 = torch.empty_like(y)
    ckpt_cfg = cfg.checkpoint
    keep = max(1, ckpt_cfg.keep) if ckpt_cfg is not None else 1

    def save(rounds_done: int) -> None:
        states = rank_gen.get_state()
        wire = states.to(dev) if mesh.backend == "nccl" else states
        states = torch.stack(mesh.all_gather_list(wire)).cpu()
        if rank == 0:
            stage_ckpt.save("layout", {"y": y, "rng": states},
                            step=rounds_done, keep=keep, extra={
                                "topology": _topology(P, n_nodes),
                                "samples_done": rounds_done * H * batch * P})
        mesh.barrier()
        if fault is not None:
            fault.fire("layout_saved")

    monitored = fault is not None
    watchdogs = [Watchdog() for _ in range(P)] if monitored else []
    stragglers: list = []
    r = start
    guard = _defer_signals(stage_ckpt)
    try:
        while r < n_rounds:
            chunk = lrs[r * H:(r + 1) * H]
            t0 = time.perf_counter()
            unit = local_sgd_round(
                unit, y0, mesh, rank_gen, chunk,
                split_step=functools.partial(step, layout_step="split")
                if fused and r == start else None)
            r += 1
            if monitored:
                if y.is_cuda:
                    torch.cuda.synchronize(y.device)
                fault.fire("layout_round")
                dt = time.perf_counter() - t0
                dts = fire_per_shard(fault, "local_sgd_round", P,
                                     stage="layout", payloads=[dt] * P)
                for s, wd in enumerate(watchdogs):
                    if wd.observe(r - 1, float(dts[s])):
                        _, dtv, med = wd.stragglers[-1]
                        stragglers.append((s, r - 1, dtv, med))
            saved = False
            if stage_ckpt is not None and (
                    (r - start) % max(1, ckpt_cfg.every_chunks) == 0
                    or r >= n_rounds):
                save(r)
                saved = True
            if guard is not None and guard.pending is not None:
                if not saved:
                    save(r)
                guard.finish()
    finally:
        _release_signals(guard)
    if stragglers:
        worst = max(stragglers, key=lambda t: t[2])
        warnings.warn(
            f"local-SGD: shard {worst[0]} straggling: round {worst[1]} "
            f"took {worst[2]:.3f}s vs median {worst[3]:.3f}s "
            f"({len(stragglers)} flagged round(s); see "
            f"LayoutResult.stragglers)", RuntimeWarning, stacklevel=2)
    done = n_rounds - start
    return LayoutResult(y=y, steps=done * H,
                        edge_samples=done * H * batch * P,
                        steps_per_dispatch=H, dispatches=done,
                        stragglers=stragglers)
