"""Deterministic fault injection at named sites.

The JAX package's ``runtime/fault_tolerance.py``, as far as the port's
projection server (``launch/serve_projection.py``) uses it:
:class:`FaultInjector` fires NaN corruption, exceptions or ``SIGKILL`` at
the sites the server fires, and :class:`InjectedFault` is the exception
it raises, which the server's ``run`` retries.

:data:`FAULT_SITES` lists only the sites the port fires.  A plan naming
any other site raises at construction, so a chaos test cannot name a site
that never fires and pass without testing anything.
"""
from __future__ import annotations

import os
import signal
from typing import Optional

import numpy as np
import torch


class InjectedFault(RuntimeError):
    """The exception :class:`FaultInjector` raises for ``"exception"``
    specs — catchable separately from real failures."""

    def __init__(self, site: str, hit: int):
        self.site, self.hit = site, hit
        super().__init__(f"injected fault at site {site!r} (hit #{hit})")


# Every site the port fires: the projection server's
# (launch/serve_projection.py).
FAULT_SITES = frozenset({"submit", "prefill", "retire", "step"})


class FaultInjector:
    """Deterministic fault injection at named sites.

    ``plan`` maps a site name to ``{hit_index: spec}``: the spec fires on
    the ``hit_index``-th time (0-based) that site is reached.  Site names
    are checked against :data:`FAULT_SITES` at construction
    (``ValueError`` on an unknown name).  Specs:

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
        unknown = sorted(s for s in self.plan if s not in FAULT_SITES)
        if unknown:
            raise ValueError(f"unknown fault site(s) {unknown}: the port "
                             f"fires {sorted(FAULT_SITES)}")
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
