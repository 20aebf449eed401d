"""The cost book: analytic totals of the model's looped and kernel regions,
recorded while a step runs — the JAX package's ``models/costbook.py``.

In the JAX package, ``compiled.cost_analysis()`` counts a ``lax.scan``
body once, so the modules that scan over a sequence (chunked attention,
mamba's chunk scan, the mLSTM's and sLSTM's token recurrences) record
their analytic totals at trace time and the roofline corrects the HLO's
numbers by ``total * (trips - 1) / trips``.

In the port the book has a job of its own.  The dry run
(``launch/dryrun.py``) counts a step's operations with torch's
``FlopCounterMode``, which sees every trip of the port's eager loops but
not inside the hand-written kernels: the flash forward and backward run
as one opaque call each (on the meta device, their outputs' shapes
alone).  The book's entries, the same labels, totals and trips as the
JAX package's, are what the dry run reports for those regions.  The port
records each time a region runs: every layer of the stack, where JAX's
scanned period is traced, and recorded, once; and the recompute of a
rematerialised period in a training step's backward, as the flash
forward really runs there again.

``record`` is a no-op unless a caller is inside ``recording()``; the
book is thread-local, as JAX's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

_STATE = threading.local()


@dataclasses.dataclass
class CostEntry:
    label: str
    total_flops: float      # analytic flops for ALL trips of the region
    total_bytes: float      # analytic HBM bytes for ALL trips
    trips: int

    @property
    def flops_correction(self) -> float:
        return self.total_flops * (self.trips - 1) / max(self.trips, 1)

    @property
    def bytes_correction(self) -> float:
        return self.total_bytes * (self.trips - 1) / max(self.trips, 1)


class CostBook:
    def __init__(self):
        self.entries: list = []

    def add(self, label: str, total_flops: float, total_bytes: float,
            trips: int) -> None:
        self.entries.append(CostEntry(label, float(total_flops),
                                      float(total_bytes), int(trips)))

    @property
    def flops_correction(self) -> float:
        return sum(e.flops_correction for e in self.entries)

    @property
    def bytes_correction(self) -> float:
        return sum(e.bytes_correction for e in self.entries)


@contextlib.contextmanager
def recording():
    """Collect the regions' entries while a step runs (this thread)."""
    prev = getattr(_STATE, "book", None)
    book = CostBook()
    _STATE.book = book
    try:
        yield book
    finally:
        _STATE.book = prev


def record(label: str, total_flops: float, total_bytes: float, trips: int,
           per_layer_mult: int = 1) -> None:
    """Called by the model code as a region runs; a no-op when not
    recording, and for a region of one trip, as in the JAX package."""
    book = getattr(_STATE, "book", None)
    if book is not None and trips > 1:
        book.add(label, total_flops * per_layer_mult,
                 total_bytes * per_layer_mult, trips)
