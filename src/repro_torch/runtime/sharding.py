"""The row layout every stage of the distributed pipeline shares.

Each stage (the KNN ring, calibration, symmetrization, the sampler build)
shards its N rows the same way: N is padded up to a multiple of the
shard count P, and shard s owns the contiguous block of
``rows_per_shard(N, P)`` rows starting at ``s * rows_per_shard(N, P)``,
so a local row l is global row ``s * rows_per_shard + l``.  One layout
across stages means a stage's output block is the next stage's input
block, with no repartitioning between them.

Only the JAX package's row-layout helpers are here; its partition specs
for the language models wait for the LM substrate.
"""
from __future__ import annotations

import torch


def rows_per_shard(n: int, n_shards: int) -> int:
    """Rows each shard owns after padding ``n`` to a shard multiple."""
    return -(-n // max(1, n_shards))


def pad_rows(x: torch.Tensor, n_shards: int, fill=0) -> torch.Tensor:
    """``x`` with axis 0 padded to ``rows_per_shard(n, P) * P`` rows of
    ``fill``, on x's device."""
    n = x.shape[0]
    n_pad = rows_per_shard(n, n_shards) * n_shards - n
    if n_pad == 0:
        return x
    return torch.cat([x, x.new_full((n_pad,) + tuple(x.shape[1:]), fill)])


def shard_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of the GLOBAL row array ``x`` (padded with zeros
    to the mesh's layout), on the mesh's device.

    Every sharded stage takes its rows this way, and so does a resumed
    one: stage checkpoints hold global arrays, so a resuming process
    takes its block for whatever shard count its own mesh has, not only
    the one that wrote the checkpoint."""
    n_loc = rows_per_shard(x.shape[0], mesh.size)
    lo = mesh.rank * n_loc
    if lo + n_loc <= x.shape[0]:              # a block with no padding
        return x[lo:lo + n_loc].to(mesh.device)
    return pad_rows(x, mesh.size)[lo:lo + n_loc].to(mesh.device)
