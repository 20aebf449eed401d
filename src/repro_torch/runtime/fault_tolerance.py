"""Fault injection, the layout's health and straggler signals, and
preemption.

The JAX package's ``runtime/fault_tolerance.py``:

* :class:`FaultInjector` fires NaN corruption, exceptions, ``SIGKILL`` or
  a callable at the named sites of :data:`FAULT_SITES`: the pipeline's
  stage boundaries (``core/largevis.py``), the layout's chunks
  (``core/layout.py``) and the projection server
  (``launch/serve_projection.py``); :class:`InjectedFault` is the
  exception it raises;
* :class:`Watchdog` flags straggler dispatches;
* :class:`DegradedModeWarning` (the fused layout step demoted to the
  split route, a data mesh halved after a shard failure),
  :class:`DivergenceWarning` (a layout rollback) and
  :class:`LayoutDivergedError` (rollbacks exhausted);
* :class:`PreemptionGuard`: SIGTERM/SIGINT -> save the newest layout
  state, then exit by the signal;
* the data mesh's pieces: the per-shard sites of
  :data:`SHARDED_FAULT_SITES`, fired by :func:`fire_per_shard`, whose
  injected exceptions become :class:`ShardFailedError` for the mesh
  retry of ``largevis()``, and :class:`TopologyChangeWarning` (a layout
  checkpoint of another shard count resumed).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import signal
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Watchdog:
    """Step-time outlier detection (straggler flagging)."""
    window: int = 50
    threshold: float = 3.0          # x median
    _times: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=200), init=False)
    stragglers: list = dataclasses.field(default_factory=list, init=False)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self._times.append(dt)
        if len(self._times) < 10:
            return False
        med = sorted(self._times)[len(self._times) // 2]
        if dt > self.threshold * med:
            self.stragglers.append((step, dt, med))
            return True
        return False


class DegradedModeWarning(UserWarning):
    """A pipeline stage demoted its implementation after a failure (the
    layout's ``fused -> split`` edge step, ``mesh[P] -> mesh[P/2]`` after
    a shard failure).  Emitted exactly once per demotion with the stage,
    the route taken, and the original error."""

    def __init__(self, stage: str, from_impl: str, to_impl: str, cause):
        self.stage, self.from_impl, self.to_impl = stage, from_impl, to_impl
        self.cause = cause
        super().__init__(
            f"degraded mode: {stage} demoted {from_impl!r} -> {to_impl!r} "
            f"after {type(cause).__name__}: {cause}")


class TopologyChangeWarning(UserWarning):
    """A stage checkpoint written on another shard count resumed here.

    The graph stages hold global arrays and are bitwise the same at
    every shard count, so they resume silently; the local-SGD layout's
    trajectory depends on the shard count (a stream a replica), so a
    layout resumed on another mesh continues from the last committed
    round boundary, with the new mesh's streams, and says so once with
    this warning."""

    def __init__(self, stage: str, saved_shards: int, new_shards: int,
                 resumed_at: int):
        self.stage, self.resumed_at = stage, resumed_at
        self.saved_shards, self.new_shards = saved_shards, new_shards
        super().__init__(
            f"{stage} checkpoint written on a {saved_shards}-shard mesh "
            f"resumed on {new_shards} shard(s): continuing from the last "
            f"committed boundary (round {resumed_at}); the trajectory "
            f"from here follows the new mesh's streams")


class ShardFailedError(RuntimeError):
    """One shard of a sharded stage failed.

    Raised by the per-shard fault sites (:func:`fire_per_shard`);
    ``largevis()`` catches it, emits one :class:`DegradedModeWarning`,
    halves the mesh and re-enters from the last committed stage."""

    def __init__(self, stage: str, shard: int, cause=None):
        self.stage, self.shard, self.cause = stage, shard, cause
        super().__init__(
            f"shard {shard} failed in stage {stage!r}"
            + (f" ({type(cause).__name__}: {cause})" if cause else ""))


class DivergenceWarning(UserWarning):
    """The layout health probe detected non-finite coordinates or a norm
    blowup; the layout rolled back to the last healthy chunk with the
    learning rate backed off."""

    def __init__(self, step: int, rollback_to: int, nonfinite: int,
                 max_abs: float, rho0_scale: float):
        self.step, self.rollback_to = step, rollback_to
        self.nonfinite, self.max_abs = nonfinite, max_abs
        self.rho0_scale = rho0_scale
        super().__init__(
            f"layout diverged at step {step} (nonfinite={nonfinite}, "
            f"max|y|={max_abs:.3g}): rolled back to step {rollback_to}, "
            f"lr scale now {rho0_scale:g}")


class LayoutDivergedError(RuntimeError):
    """The layout kept diverging after ``HealthConfig.max_rollbacks``
    rollback/backoff attempts."""


class InjectedFault(RuntimeError):
    """The exception :class:`FaultInjector` raises for ``"exception"``
    specs — catchable separately from real failures."""

    def __init__(self, site: str, hit: int):
        self.site, self.hit = site, hit
        super().__init__(f"injected fault at site {site!r} (hit #{hit})")


# Every site the port fires.  A FaultInjector plan naming anything else
# raises ValueError at construction: a typo'd site would otherwise never
# fire and let a chaos test pass without testing anything.
FAULT_SITES = frozenset({
    # largevis() pipeline stage boundaries (core/largevis.py)
    "stage:graph", "stage:weights", "stage:samplers",
    # the layouts' loops (core/layout.py)
    "layout_chunk", "layout_saved", "layout_round",
    # projection server (launch/serve_projection.py)
    "submit", "prefill", "retire", "step",
})

# Per-shard sites of the sharded stages: a plan names them
# ``"<site>:<shard>"`` (e.g. ``"knn_ring_step:1"``), and they fire once a
# shard a pass through the stage (:func:`fire_per_shard`).
SHARDED_FAULT_SITES = frozenset({
    "knn_ring_step",        # core/knn_sharded.py, before the ring
    "calibrate_shard",      # core/perplexity.py calibrate_p_sharded
    "symmetrize_exchange",  # core/perplexity.py symmetrize_sharded
    "local_sgd_round",      # core/layout.py run_layout_local_sgd
})


def _valid_site(site: str) -> bool:
    if site in FAULT_SITES:
        return True
    base, _, shard = site.rpartition(":")
    return base in SHARDED_FAULT_SITES and shard.isdigit()


class FaultInjector:
    """Deterministic fault injection at named sites.

    ``plan`` maps a site name to ``{hit_index: spec}``: the spec fires on
    the ``hit_index``-th time (0-based) that site is reached.  Site names
    are checked against :data:`FAULT_SITES` and, as ``"<site>:<shard>"``,
    :data:`SHARDED_FAULT_SITES` at construction (``ValueError`` on an
    unknown name).  Specs:

    * ``"nan"``       — every float tensor or array in the site's payload
      is returned filled with NaN;
    * ``"exception"`` — raise :class:`InjectedFault`;
    * ``"kill"``      — ``SIGKILL`` the current process;
    * a callable      — ``spec(payload) -> payload`` for targeted
      corruption (e.g. NaN one row of a prefill block).

    Sites fire via ``payload = injector.fire("site", payload)``; every
    firing is recorded in ``log`` as ``(site, hit, kind)``.
    """

    def __init__(self, plan: Optional[dict] = None):
        self.plan = dict(plan or {})
        unknown = sorted(s for s in self.plan if not _valid_site(s))
        if unknown:
            raise ValueError(
                f"unknown fault site(s) {unknown}: the port fires "
                f"{sorted(FAULT_SITES)} plus per-shard "
                f"{sorted(SHARDED_FAULT_SITES)} as '<site>:<shard>'")
        self.counts: dict = {}
        self.log: list = []

    def fire(self, site: str, payload=None):
        hit = self.counts.get(site, 0)
        self.counts[site] = hit + 1
        spec = self.plan.get(site, {}).get(hit)
        if spec is None:
            return payload
        if callable(spec):
            self.log.append((site, hit, "callable"))
            return spec(payload)
        self.log.append((site, hit, spec))
        if spec == "nan":
            return _poison(payload)
        if spec == "exception":
            raise InjectedFault(site, hit)
        if spec == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise ValueError(f"unknown fault spec {spec!r} at site {site!r}")


def fire_per_shard(fault, site: str, n_shards: int, *, stage: str,
                   payloads=None):
    """Fire ``"<site>:<s>"`` for every shard ``s`` in order; an injected
    exception becomes :class:`ShardFailedError` (``stage``, ``s``).

    Every rank holds the same plan and fires every shard's site in the
    same order, so the ranks raise together and enter the mesh retry
    together.  A callable spec may transform its shard's entry of
    ``payloads`` (e.g. inflate one shard's round time to make it a
    straggler).  Returns the payload list."""
    if fault is None:
        return payloads
    out = list(payloads) if payloads is not None else [None] * n_shards
    for s in range(n_shards):
        try:
            out[s] = fault.fire(f"{site}:{s}", out[s])
        except InjectedFault as e:
            raise ShardFailedError(stage, s, e) from e
    return out


def _poison(payload):
    """The payload with every float tensor or array replaced by one
    filled with NaN, through tuples, lists and dicts; anything else is
    returned as it is."""
    if torch.is_tensor(payload):
        return (torch.full_like(payload, float("nan"))
                if payload.is_floating_point() else payload)
    if isinstance(payload, np.ndarray):
        return (np.full_like(payload, np.nan)
                if np.issubdtype(payload.dtype, np.floating) else payload)
    if isinstance(payload, (tuple, list)):
        return type(payload)(_poison(v) for v in payload)
    if isinstance(payload, dict):
        return {k: _poison(v) for k, v in payload.items()}
    return payload


class PreemptionGuard:
    """SIGTERM/SIGINT -> checkpoint-now-then-exit hook (cluster preemption).

    ``largevis()`` installs one (SIGTERM + SIGINT) whenever checkpointing
    is enabled and registers it as the process-wide *active* guard.  On a
    signal the guard runs ``save_fn`` (:meth:`set_save_fn`), restores the
    previous handlers, and — with ``exit_after_save`` — re-raises the
    signal so the process still dies by it (what a preempting scheduler
    expects).  ``restore_handlers`` on normal completion puts the prior
    handlers back untouched.

    A Python handler runs between any two bytecodes of the main thread:
    inside a CUDA graph capture, or beside a checkpoint writer thread.
    So a loop that holds state worth saving calls :meth:`defer`; a signal
    is then only recorded in :attr:`pending`, and the loop saves at its
    next chunk boundary and calls :meth:`finish`."""

    _active: Optional["PreemptionGuard"] = None

    def __init__(self, save_fn: Optional[Callable[[], None]] = None, *,
                 signals=(signal.SIGTERM,), exit_after_save: bool = False):
        self._save_fn = save_fn
        self._exit = exit_after_save
        self.triggered = False
        self.deferred = False
        self.pending: Optional[int] = None    # a signal held by defer()
        self._prev = {}
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._handle)

    @classmethod
    def active(cls) -> Optional["PreemptionGuard"]:
        return cls._active

    def activate(self):
        """Make this the guard ``active()`` returns (one per process)."""
        PreemptionGuard._active = self
        return self

    def set_save_fn(self, fn: Optional[Callable[[], None]]):
        self._save_fn = fn

    def defer(self, on: bool = True):
        """While on, a signal only sets :attr:`pending`; the deferring
        loop acts on it with :meth:`finish` at a point where it is safe
        to save."""
        self.deferred = on

    def _handle(self, signum, frame):
        self.triggered = True
        if self.deferred:
            self.pending = signum
            return
        self._act(signum)

    def finish(self):
        """Act on the pending signal: run ``save_fn``, then exit by it."""
        signum, self.pending = self.pending, None
        self._act(signum)

    def _act(self, signum):
        if self._save_fn is not None:
            self._save_fn()
        if self._exit:
            self.restore_handlers()
            os.kill(os.getpid(), signum)

    def restore_handlers(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        if PreemptionGuard._active is self:
            PreemptionGuard._active = None
