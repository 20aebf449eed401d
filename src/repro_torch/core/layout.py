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
from repro_torch.runtime.fault_tolerance import (DegradedModeWarning,
                                                 DivergenceWarning,
                                                 InjectedFault,
                                                 LayoutDivergedError,
                                                 PreemptionGuard, Watchdog)


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


def _layout_stage_ckpt(generator, n_nodes: int, cfg, edge_sampler=None):
    """StageCheckpointer for the layout stage, else None.

    The layout trajectory is a function of (samplers, generator, cfg,
    N), so the fingerprint binds all four: the sampler by a strided
    sample of its alias threshold table, the generator by its state at
    the layout's entry."""
    if cfg.checkpoint is None:
        return None
    table = (edge_sampler.threshold.reshape(-1, 1)
             if edge_sampler is not None else None)
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


def _first_fused_chunk(unit, generator, lrs, split_step):
    """Run the first chunk of the fused route, which runs eagerly (the
    graph recipe's warm-up), so a failure of the fused kernel (its build,
    no kernel image for the card, a launch configuration) surfaces here.
    On such a failure y and the generator go back to their state before
    the chunk, and the run continues on the split route with one
    :class:`DegradedModeWarning`.  Returns the unit that ran."""
    y = unit.y
    y_before, rng = y.to("cpu", copy=True), generator.get_state()
    try:
        unit.run(generator, lrs)
        return unit
    except InjectedFault:
        raise
    except Exception as e:          # a backend failure of the fused step
        if y.is_cuda:
            # waits for the steps queued before the failure; a sticky
            # error (an illegal address) raises again here, and nothing
            # is demoted past it
            torch.cuda.synchronize(y.device)
        warnings.warn(DegradedModeWarning("layout_step", "fused", "split", e),
                      stacklevel=3)
        y.copy_(y_before)
        generator.set_state(rng)
        unit = layout_engine.StepChunks(split_step, y, unit.H)
        unit.run(generator, lrs)
        return unit


def run_layout(generator, edge_sampler, neg_sampler, n_nodes: int, cfg, *,
               device, callback: Optional[Callable] = None, y0=None,
               start_step: int = 0, on_chunk: Optional[Callable] = None,
               fault=None) -> LayoutResult:
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
    """
    health = cfg.health
    stage_ckpt = _layout_stage_ckpt(generator, n_nodes, cfg, edge_sampler)
    rho0_scale, rollbacks = 1.0, 0
    if stage_ckpt is not None and y0 is None and start_step == 0:
        loaded = stage_ckpt.load("layout")
        if loaded is not None:
            tree, start_step, extra = loaded
            y0 = tree["y"]
            generator.set_state(torch.from_numpy(tree["rng"]))
            rho0_scale = float(extra.get("rho0_scale", 1.0))
            rollbacks = int(extra.get("rollbacks", 0))
    if y0 is None:
        y = torch.randn((n_nodes, cfg.out_dim), generator=generator,
                        device=device) * cfg.init_scale
    else:
        y = torch.as_tensor(y0).to(device=device, dtype=torch.float32,
                                   copy=True)
    total = int(cfg.samples_per_node) * n_nodes
    batch = _collision_capped_batch(cfg.batch_size, n_nodes, total)
    steps = max(1, total // batch)
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

        def extras():
            return {"rho0_scale": rho0_scale, "rollbacks": rollbacks}

        unit = layout_engine.StepChunks(step, y, H)
        fused = (cfg.prob_fn == "inv_quadratic"
                 and cfg.routing.layout_step != "split")
        last_good = None
        if health is not None:
            last_good = (y.clone(), start, generator.get_state())
        # preemption: the active guard's handler only records a signal
        # (it may land inside a capture, or beside the writer thread);
        # the loop saves at the next chunk boundary and exits by it
        guard = PreemptionGuard.active() if stage_ckpt is not None else None
        if guard is not None:
            guard.defer()
        t, chunk_i, dispatches = start, 0, 0
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
                                      extra=extras())
                    else:
                        stage_ckpt.save("layout", tree, step=t, keep=keep,
                                        extra=extras())
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
                            step=t, keep=keep, extra=extras())
                    guard.finish()
        finally:
            try:
                if writer is not None:
                    writer.close()
            finally:
                if guard is not None:
                    # a signal after the last boundary's check: that
                    # boundary was saved by the cadence, the exit is left
                    guard.defer(False)
                    if guard.pending is not None:
                        guard.finish()
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
