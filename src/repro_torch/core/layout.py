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
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.core import layout_engine


@dataclasses.dataclass
class LayoutResult:
    y: torch.Tensor
    steps: int
    edge_samples: int
    steps_per_dispatch: int = 1      # 1: the per-step loop
    dispatches: int = 0


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


def run_layout(generator, edge_sampler, neg_sampler, n_nodes: int, cfg, *,
               device, callback: Optional[Callable] = None) -> LayoutResult:
    """Drive the layout for T = samples_per_node * N edge samples from a
    random N(0, init_scale) start; ``generator`` (on ``device``) draws the
    start and every edge and negative sample.

    With ``callback is None`` and H = ``cfg.steps_per_dispatch`` > 1 the
    steps run H a dispatch (full chunks, then the remainder).  Otherwise
    they run one by one, and ``callback(t, steps, y)`` is called every
    ``steps // 20`` steps, as in the JAX package.
    """
    y = torch.randn((n_nodes, cfg.out_dim), generator=generator,
                    device=device) * cfg.init_scale
    total = int(cfg.samples_per_node) * n_nodes
    batch = _collision_capped_batch(cfg.batch_size, n_nodes, total)
    steps = max(1, total // batch)
    step = functools.partial(
        layout_engine.sgd_edge_step, edge_sampler=edge_sampler,
        neg_sampler=neg_sampler,
        n_negatives=cfg.n_negatives, prob_fn=cfg.prob_fn, a=cfg.prob_a,
        gamma=cfg.gamma, clip=cfg.grad_clip, batch=batch,
        layout_step=cfg.routing.layout_step)
    lrs = layout_engine.lr_table(cfg.rho0, steps, device)
    H = layout_engine.dispatch_steps(int(cfg.steps_per_dispatch),
                                     n_nodes=n_nodes, batch=batch)
    if callback is None and H > 1:
        dispatches = layout_engine.StepChunks(step, y, H).run_all(generator,
                                                                  lrs)
    else:
        H, dispatches = 1, steps
        for t in range(steps):
            step(y, generator, lr=lrs[t])
            if callback is not None and t % max(1, steps // 20) == 0:
                callback(t, steps, y)
    return LayoutResult(y=y, steps=steps, edge_samples=steps * batch,
                        steps_per_dispatch=H, dispatches=dispatches)

