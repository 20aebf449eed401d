"""Interleaved best-of-N wall-clock timing, the methodology the tuner uses.

Configurations are timed in alternation, one call of each a round, so
load drift over tens of seconds spreads over all of them and their
per-configuration minima stay comparable; back-to-back repeats of one
configuration would land inside one load regime.  ``AUTOTUNE_REPEATS``
is the pairing depth of the tuner's adopt/reject decision.

A timed region ends when its output is ready: every CUDA tensor in the
output (nested tuples, lists and dicts) has its device synchronised,
since PyTorch returns before the card finishes.  CPU output needs no
wait.
"""
from __future__ import annotations

import sys
import time

import torch

from repro_torch.runtime.fault_tolerance import Watchdog

# pairing depth of the tuner's adopt/reject decision (paired interleaved
# best-of-8)
AUTOTUNE_REPEATS = 8


def _cuda_devices(out, found: set) -> set:
    if torch.is_tensor(out):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    return found


def block_until_ready(out):
    """Wait for the devices of every CUDA tensor in ``out``; returns it."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)
    return out


def _report_stragglers(watchdog: Watchdog, label: str) -> None:
    """One stderr line when timed repeats hit load-spike outliers: the
    best-of numbers already drop them, the line makes the drop visible."""
    if watchdog.stragglers:
        worst = max(dt for _, dt, _ in watchdog.stragglers)
        med = watchdog.stragglers[-1][2]
        print(f"[timing] {label}: {len(watchdog.stragglers)} straggler "
              f"repeat(s) (worst {worst:.3f}s vs median {med:.3f}s): using "
              f"best-of, but treat this row with suspicion", file=sys.stderr)


def best_of_interleaved(fns, repeats: int):
    """Best-of-``repeats`` seconds per fn, alternating fns every round.

    Each fn gets one untimed warm-up call first (builds and first-call
    allocations never land in a number); a :class:`Watchdog` per fn
    flags outlier repeats on stderr.  Returns (outs, best_seconds), one
    entry per fn.
    """
    outs = [block_until_ready(f()) for f in fns]
    best = [float("inf")] * len(fns)
    dogs = [Watchdog() for _ in fns]
    for r in range(repeats):
        for f_i, f in enumerate(fns):
            t0 = time.perf_counter()
            outs[f_i] = block_until_ready(f())
            dt = time.perf_counter() - t0
            best[f_i] = min(best[f_i], dt)
            dogs[f_i].observe(r, dt)
    for f_i, dog in enumerate(dogs):
        _report_stragglers(dog, f"fn[{f_i}]")
    return outs, best


def timed(fn, *args, repeats: int = 1, warmup: int = 1, **kw):
    """(result, best_seconds) of ``fn(*args, **kw)``.

    ``warmup`` untimed calls run first; pass ``warmup=0`` only when the
    first call's cost is what is measured.  A :class:`Watchdog` over the
    repeats reports outliers on stderr.
    """
    out = None
    for _ in range(max(0, warmup)):
        out = block_until_ready(fn(*args, **kw))
    best = float("inf")
    dog = Watchdog()
    for r in range(repeats):
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args, **kw))
        dt = time.perf_counter() - t0
        best = min(best, dt)
        dog.observe(r, dt)
    _report_stragglers(dog, getattr(fn, "__name__", "timed"))
    return out, best
