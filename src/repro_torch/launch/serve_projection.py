"""Continuous-batching projection server: LargeVis ``transform`` as a
serving loop.

The JAX package's ``launch/serve_projection.py`` engine.  A fixed number
of slots step in lockstep, as the LM engine's (``launch/serve.py``) do,
with "decode" replaced by the frozen-corpus edge step:

* **prefill** — a queued query gets its corpus neighborhood (one
  ``topk_sqdist`` launch over the whole admit block, padded to ``slots``
  rows), its perplexity-calibrated neighbor distribution p, and its
  p-weighted mean init, written into a free slot row of the resident
  ``[corpus; slots]`` embedding.
* **step** — one ``layout_engine.apply_edge_batch`` moves all slots:
  each slot draws one positive edge (slot -> neighbor ∝ its p) and M
  negatives from the fitted noise sampler (``transform.
  sample_query_edges``), at a **per-slot learning rate**, the entry of
  ``layout_engine.lr_table`` at the slot's age.  Corpus rows are frozen
  by ``n_frozen``: the fitted embedding keeps its bits whatever the
  traffic.
* **retire** — a slot that has taken ``steps`` updates completes its
  request with the slot row's coordinates and frees the slot.

Inactive slots loop their positive edge back onto themselves with every
negative masked, an exactly-zero update, so the step's shapes never
depend on occupancy.  On the card the step is captured once into a CUDA
graph (after one eager warm-up step) and every later step is one replay;
admit and retire write the graph's static buffers in place, outside it.
Ages have a host mirror, so an engine step reads nothing back from the
device but the coordinates that retire returns.  On the CPU
(``device="cpu"``) the same step runs eagerly through the kernels' plain
versions.

Randomness comes from one ``torch.Generator`` seeded with ``seed``; a
step's draws depend only on how many steps came before it, so two
engines given the same requests in the same order return the same bits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.largevis_default import LargeVisConfig
from repro_torch.core import layout_engine
from repro_torch.core import perplexity as perp_lib
from repro_torch.core.largevis import (as_tensor, resolve_device,
                                       seeded_generator)
from repro_torch.core.sampler import NodeSampler
from repro_torch.core.transform import (_weighted_mean_init,
                                        query_neighbors, sample_query_edges,
                                        uniform_node_sampler)
from repro_torch.runtime.fault_tolerance import InjectedFault


class QueueFullError(RuntimeError):
    """Admission backpressure: ``submit`` refused because the engine's
    queue is at ``max_queue``.  The caller sheds load or retries later."""


@dataclasses.dataclass
class ProjectRequest:
    rid: int
    x: np.ndarray                      # (d,) query point
    y: Optional[np.ndarray] = None     # (s,) result, set at retire
    t_submit: float = 0.0
    t_done: float = 0.0
    done: bool = False
    error: Optional[str] = None        # set when quarantined/retired-on-error

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


def _prefill_block(xq, x, y, *, k: int, perplexity: float, iters: int):
    """Neighborhoods and init coordinates of one admit block (A, d).

    Returns (nn_idx (A, k) int32, p (A, k), y0 (A, s))."""
    nn_idx, nn_dist = query_neighbors(xq, x, k)
    p = perp_lib.calibrate_p(nn_dist, perplexity, iters=iters)
    return nn_idx, p, _weighted_mean_init(p, nn_idx, y)


def slot_lr_table(rho0: float, steps: int, device) -> torch.Tensor:
    """(steps + 1,) f32: entry t < steps is a slot's lr at age t,
    ``layout_engine.lr_table``'s entry t; entry ``steps`` is the floor
    ``rho0 * 1e-4`` that every later age takes, as the JAX engine's
    ``rho0 * max(1 - age / steps, 1e-4)`` gives it."""
    floor = torch.full((1,), layout_engine.step_lr(rho0, 1.0),
                       dtype=torch.float32)
    return torch.cat([layout_engine.lr_table(rho0, steps, "cpu"),
                      floor]).to(device)


def slot_lr(lrs: torch.Tensor, ages: torch.Tensor) -> torch.Tensor:
    """Each slot's lr: ``lrs`` (:func:`slot_lr_table`) gathered at its
    age, ages past the table's end at its last entry.  A gather, not
    ``rho0 * (1 - ages / steps)`` in torch, whose ``float / tensor`` is
    reciprocal-then-multiply and would not give JAX's bits."""
    return lrs[ages.clamp(max=lrs.shape[0] - 1)]


def _lockstep_apply(y_full, i, j, negs, neg_mask, ages, active, lrs, *,
                    n_frozen: int, **kw):
    """The lockstep step's update, given its draws: inactive slots loop
    their positive onto themselves with every negative masked; each slot
    moves at :func:`slot_lr`; ``y_full`` and the active slots' ``ages``
    advance in place."""
    j = torch.where(active, j, i)
    neg_mask = neg_mask * active[:, None].float()
    layout_engine.apply_edge_batch(y_full, i, j, negs, neg_mask,
                                   slot_lr(lrs, ages), n_frozen=n_frozen,
                                   **kw)
    ages.add_(active.to(ages.dtype))
    return y_full


class ProjectionEngine:
    """Fixed-slot continuous-batching engine over a fitted LargeVis model.

    ``model`` is anything with the fitted-carrier fields — a
    :class:`repro_torch.LargeVisResult` or a fitted
    :class:`repro_torch.LargeVis`'s ``result_``: ``x`` (N, d) corpus,
    ``y`` (N, s) frozen layout, optional ``neg_sampler``, ``cfg``.  Its
    arrays may be tensors or numpy arrays.

    ``device`` defaults to the device of the model's tensors, or "cuda"
    when they are numpy arrays; without CUDA it raises unless it is
    "cpu".  ``cuda_graph=False`` runs every step on the card eagerly (the
    path the graph replays are held to).  The step's route is
    ``cfg.routing.layout_step``.
    """

    def __init__(self, model, *, slots: int = 256,
                 cfg: LargeVisConfig | None = None, seed: int = 0,
                 max_queue: Optional[int] = None,
                 slot_step_budget: Optional[int] = None,
                 fault=None, device=None, cuda_graph: bool = True):
        cfg = cfg or getattr(model, "cfg", None) or LargeVisConfig()
        self.cfg = cfg
        self.slots = slots
        if device is None:
            device = (model.y.device if torch.is_tensor(model.y)
                      else "cuda")
        self.device = dev = resolve_device(device)
        self.x = as_tensor(model.x, dev, torch.float32).contiguous()
        self.n = int(self.x.shape[0])
        self.k = min(cfg.n_neighbors, self.n)
        self.steps = int(cfg.transform_steps)
        ns = getattr(model, "neg_sampler", None)
        self.neg_sampler = (
            uniform_node_sampler(self.n, dev) if ns is None else NodeSampler(
                as_tensor(ns.threshold, dev, torch.float32),
                as_tensor(ns.alias, dev, torch.int32), self.n))
        y = as_tensor(model.y, dev, torch.float32)
        self.s_dim = int(y.shape[1])
        i32 = dict(dtype=torch.int32, device=dev)
        # the step's static buffers: resident [corpus; slots] embedding
        # (corpus rows frozen forever), each slot's neighbors and p, ages
        self.y_full = torch.cat(
            [y, torch.zeros((slots, self.s_dim), device=dev)])
        # p row [1, 0, ...] so an inactive slot's draw is well defined
        self.p = torch.zeros((slots, self.k), device=dev)
        self.p[:, 0] = 1.0
        self.nn_idx = torch.zeros((slots, self.k), **i32)
        self.ages = torch.zeros((slots,), **i32)
        self.active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self._i = self.n + torch.arange(slots, **i32)
        self.lrs = slot_lr_table(cfg.transform_rho0 or cfg.rho0, self.steps,
                                 dev)
        # host mirror of ages (+1 per step while occupied), so retire
        # checks never read the device
        self._host_ages = np.zeros((slots,), np.int64)
        self._occupied = np.zeros((slots,), bool)
        self.generator = seeded_generator(dev, seed)
        self.step_no = 0
        self.queue: List[ProjectRequest] = []
        self.requests: List[Optional[ProjectRequest]] = [None] * slots
        self.completed: List[ProjectRequest] = []
        # admission backpressure, the per-slot step budget (a stuck slot
        # is force-retired with an error), the quarantine list and the
        # fault injector for chaos tests
        self.max_queue = max_queue
        self.slot_step_budget = (slot_step_budget if slot_step_budget
                                 else 4 * self.steps)
        self.fault = fault
        self.quarantined: List[ProjectRequest] = []
        self.faults_retried = 0
        # engine step at which each slot was admitted (budget clock)
        self._slot_born = np.zeros((slots,), np.int64)
        # the step on the card: eager warm-up, then one graph replayed
        self._use_graph = cuda_graph and dev.type == "cuda"
        self._warm = False
        self._graph = None
        self.graph_replays = 0
        if self._use_graph:
            self._gen = torch.Generator(device=dev)

    # ------------------------------------------------------------------
    def submit(self, req: ProjectRequest) -> bool:
        """Queue a request; returns False when it was quarantined instead.

        A query row with the wrong dimensionality or any NaN/Inf never
        enters the queue (it completes at once with ``req.error`` set and
        lands in ``self.quarantined``), so faulty traffic cannot change
        the slot assignment, the draws or the results of healthy
        requests.  Raises :class:`QueueFullError` at ``max_queue``."""
        req.t_submit = req.t_submit or time.time()
        if self.fault is not None:
            req = self.fault.fire("submit", req)
        xq = np.asarray(req.x, np.float32).reshape(-1)
        d = int(self.x.shape[1])
        if xq.shape[0] != d:
            req.error = (f"query dim {xq.shape[0]} != corpus dim {d}")
        elif not np.all(np.isfinite(xq)):
            req.error = "query contains NaN/Inf"
        if req.error is not None:
            req.done, req.t_done = True, time.time()
            self.quarantined.append(req)
            return False
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise QueueFullError(
                f"queue at max_queue={self.max_queue}; retry later")
        self.queue.append(req)
        return True

    def _admit(self):
        """Fill every free slot from the queue with ONE prefill, the block
        padded to the slot count (padded rows are discarded)."""
        free = np.flatnonzero(~self._occupied)
        if not free.size or not self.queue:
            return
        n_adm = min(free.size, len(self.queue))
        batch = [self.queue.pop(0) for _ in range(n_adm)]
        xq = np.zeros((self.slots, self.x.shape[1]), np.float32)
        for b, req in enumerate(batch):
            xq[b] = req.x
        nn_idx, p, y0 = _prefill_block(
            torch.from_numpy(xq).to(self.device), self.x,
            self.y_full[:self.n], k=self.k,
            perplexity=float(min(self.cfg.perplexity, self.k)),
            iters=self.cfg.perplexity_iters)
        if self.fault is not None:
            nn_idx, p, y0 = self.fault.fire("prefill", (nn_idx, p, y0))
        slots = free[:n_adm]
        rows = torch.from_numpy(slots).to(self.device)
        self.nn_idx.index_copy_(0, rows, nn_idx[:n_adm])
        self.p.index_copy_(0, rows, p[:n_adm])
        self.y_full.index_copy_(0, self.n + rows, y0[:n_adm])
        self.ages.index_fill_(0, rows, 0)
        self.active.index_fill_(0, rows, True)
        for s, req in zip(slots, batch):
            self.requests[s] = req
        self._occupied[slots] = True
        self._host_ages[slots] = 0
        self._slot_born[slots] = self.step_no

    def _retire(self):
        """Complete finished slots; quarantine poisoned or stuck ones.

        A slot whose row holds NaN/Inf, and a slot still unfinished after
        ``slot_step_budget`` engine steps, free their slot without
        returning coordinates: their requests complete with
        ``req.error`` set, into ``self.quarantined``."""
        finished = self._occupied & (self._host_ages >= self.steps)
        stuck = (self._occupied & ~finished
                 & (self.step_no - self._slot_born >= self.slot_step_budget))
        all_rows = np.concatenate([np.flatnonzero(finished),
                                   np.flatnonzero(stuck)])
        if not all_rows.size:
            return
        rows = torch.from_numpy(all_rows).to(self.device)
        coords = self.y_full[self.n + rows].cpu().numpy()
        if self.fault is not None:
            coords = self.fault.fire("retire", coords)
        now = time.time()
        self.active.index_fill_(0, rows, False)
        self.ages.index_fill_(0, rows, 0)
        for c, s in enumerate(all_rows):
            req = self.requests[s]
            req.t_done, req.done = now, True
            if stuck[s]:
                req.error = (f"slot {s} exceeded its step budget "
                             f"({self.slot_step_budget} engine steps) "
                             f"before finishing; force-retired")
                self.quarantined.append(req)
            elif not np.all(np.isfinite(coords[c])):
                req.error = "projection diverged: non-finite coordinates"
                self.quarantined.append(req)
            else:
                req.y = coords[c]
                self.completed.append(req)
            self.requests[s] = None
        self._occupied[all_rows] = False

    def _lockstep_step(self, generator):
        """One step over all slots, drawing from ``generator``."""
        cfg = self.cfg
        j, negs, neg_mask = sample_query_edges(
            generator, self.p, self.nn_idx, self.neg_sampler,
            cfg.n_negatives)
        _lockstep_apply(self.y_full, self._i, j, negs, neg_mask, self.ages,
                        self.active, self.lrs, n_frozen=self.n,
                        prob_fn=cfg.prob_fn, a=cfg.prob_a, gamma=cfg.gamma,
                        clip=cfg.grad_clip,
                        layout_step=cfg.routing.layout_step)

    def _dispatch(self):
        """The step: eager on the CPU (or without graphs); on the card the
        first step eager on a side stream (the graph recipe's warm-up),
        then the captured graph replayed."""
        if not self._use_graph:
            self._lockstep_step(self.generator)
            return
        if not self._warm:
            layout_engine.warm_up(
                lambda: self._lockstep_step(self.generator), self.device)
            self._warm = True
            return
        if self._graph is None:
            self._graph = layout_engine.capture(
                lambda: self._lockstep_step(self._gen), self._gen)
        layout_engine.replay(*self._graph, self._gen, self.generator)
        self.graph_replays += 1

    def step(self) -> bool:
        """Admit -> one lockstep step -> retire.

        Returns False when there is nothing left to do.  The ``step``
        fault site fires before the dispatch and before any engine state
        advances, so an injected exception is retryable with zero drift
        (``run`` retries it).  A payload the site returns in place of
        ``y_full`` is copied into it: the graph reads that buffer."""
        self._admit()
        if not self._occupied.any():
            return False
        if self.fault is not None:
            y = self.fault.fire("step", self.y_full)
            if y is not self.y_full:
                self.y_full.copy_(y)
        self._dispatch()
        self.step_no += 1
        self._host_ages[self._occupied] += 1
        self._retire()
        return True

    def run(self, max_steps: int = 10_000_000) -> int:
        """Drain the queue; returns the number of engine step attempts.

        An :class:`~repro_torch.runtime.fault_tolerance.InjectedFault`
        raised by a step is caught and the step retried (counted in
        ``faults_retried``); real exceptions propagate."""
        n = 0
        while (self.queue or self._occupied.any()) and n < max_steps:
            try:
                progressed = self.step()
            except InjectedFault:
                self.faults_retried += 1
                n += 1
                continue
            if not progressed:
                break
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n
