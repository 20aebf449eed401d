"""Checkpoint manager: periodic saves, auto-resume — the JAX package's
``checkpoint/manager.py`` over the port's ``checkpointer``.

Two port extensions: ``maybe_save`` takes the tree or a function that
makes it, called only on the cadence (the trainer's tree is host copies
of the whole train state, too costly to build every step); and a manager
with ``writes=False`` (a rank of a mesh whose rank 0 writes) calls the
function on the same cadence, for the collectives every rank joins, but
writes nothing and returns the path the writer commits.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Optional

from repro_torch.checkpoint import checkpointer as ckpt


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    save_every: int = 100
    keep: int = 3
    writes: bool = True
    _last_save_time: float = dataclasses.field(default=0.0, init=False)

    def maybe_save(self, step: int, tree) -> Optional[pathlib.Path]:
        """Save ``tree`` (or ``tree()`` when it is callable) as ``step``
        when ``step`` is a multiple of ``save_every``; else None."""
        if step % self.save_every != 0:
            return None
        t0 = time.time()
        path = self.save_now(step, tree)
        self._last_save_time = time.time() - t0
        return path

    def save_now(self, step: int, tree) -> pathlib.Path:
        tree = tree() if callable(tree) else tree
        if not self.writes:
            return pathlib.Path(self.directory) / f"step_{step}"
        return ckpt.save(self.directory, step, tree, keep=self.keep)

    def resume(self, *, shardings=None, like=None):
        """(tree, step) of the latest committed checkpoint, else (None, 0);
        the leaves numpy arrays, cast to ``like``'s, or each this rank's
        block of it on a mesh (``shardings``; ``checkpointer.restore``)."""
        step = ckpt.latest_step(self.directory)
        if step is None:
            return None, 0
        return ckpt.restore(self.directory, step, shardings=shardings,
                            like=like)
