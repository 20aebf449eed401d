"""NN-Descent baseline (Dong et al. 2011): neighbor exploring from a
random initial graph, with no projection forest; the "exploring alone"
arm of the paper's Fig 2.  LargeVis is the forest plus the same
exploring."""
from __future__ import annotations

import torch

from repro_torch.core.neighbor_explore import neighbor_explore


def random_knn_init(x, k: int, generator: torch.Generator | None = None,
                    *, tile: int = 8192):
    """Uniform random neighbor ids (N, k) int32 and their true squared
    distances, computed ``tile`` rows at a time."""
    n = x.shape[0]
    idx = torch.randint(0, n, (n, k), generator=generator, device=x.device,
                        dtype=torch.int32)
    dist = torch.empty((n, k), device=x.device)
    for t0 in range(0, n, tile):
        diff = (x[idx[t0:t0 + tile].long()]
                - x[t0:t0 + tile, None, :]).float()
        dist[t0:t0 + tile] = (diff * diff).sum(-1)
    return idx, dist


def nn_descent(x, k: int, *, iters: int = 4,
               generator: torch.Generator | None = None, sample: int = 0,
               init=None):
    """Random init (or ``init``, an (idx, dist) graph), then ``iters``
    exploring rounds: (idx, dist)."""
    idx, dist = init if init is not None else random_knn_init(x, k,
                                                              generator)
    return neighbor_explore(x, idx, dist, iters=iters, sample=sample,
                            generator=generator)
