"""LINE first-order baseline (Tang et al. 2015) learned directly in 2-D.

The paper shows that an embedding objective is not a layout objective
(Fig 5: LINE "is very bad" as a visualizer); this baseline reproduces
that negative result.  First-order proximity: P(e_ij) = sigmoid(y_i.y_j),
with the same edge and negative samplers as LargeVis.

The JAX package takes ``jax.grad`` of the log-sigmoid loss.  Here the
per-edge forces are written in closed form and added into a zero (N, s)
gradient by ``ops.scatter_add_ordered`` in stream order (the i-rows, then
the j-rows, then the negative rows): on the card that is the ordered
scatter of ``csrc/largevis_step.cu``, so two runs are bitwise equal,
where autograd's backward of ``y[i]`` would add atomically.  The
accumulated gradient is clipped per coordinate, then
y <- y - lr * g with lr = rho0 * max(1 - t/T, 1e-4).
"""
from __future__ import annotations

import torch

from repro_torch.core import layout_engine
from repro_torch.kernels import ops


def line_update(y, i, j, negs, lr: float, *, clip: float = 5.0):
    """One LINE step of an edge batch: returns the new (N, s) y.

    i, j: (B,) edge endpoints; negs: (B, M) negatives (not masked, as in
    the JAX package).  The loss is sum_e -log sigmoid(y_i.y_j) +
    sum_{e,m} -log sigmoid(-y_i.y_n)."""
    i, j, negs = i.long(), j.long(), negs.long()
    yi, yj, yn = y[i], y[j], y[negs]                     # (B,s), (B,M,s)
    pos = torch.sigmoid(-(yi * yj).sum(-1))[:, None]     # -dloss/ds_ij
    neg = torch.sigmoid((yi[:, None, :] * yn).sum(-1))   # dloss/ds_in
    push = neg[:, :, None] * yn
    gi = -pos * yj
    for m in range(negs.shape[1]):                       # left to right
        gi = gi + push[:, m]
    gj = -pos * yi
    gneg = neg[:, :, None] * yi[:, None, :]
    idx = torch.cat([i, j, negs.reshape(-1)])
    upd = torch.cat([gi, gj, gneg.reshape(-1, y.shape[1])])
    g = ops.scatter_add_ordered(torch.zeros_like(y), idx, upd)
    return y - lr * g.clamp(-clip, clip)


def line_step(y, generator, t_frac: float, *, edge_sampler, neg_sampler,
              n_negatives: int, batch: int, rho0: float = 0.025,
              clip: float = 5.0):
    """Draw an edge batch and its negatives from ``generator``, then
    :func:`line_update` at lr ``rho0 * max(1 - t_frac, 1e-4)`` (f32)."""
    i, j = edge_sampler.sample(generator, batch)
    negs = neg_sampler.sample(generator, (batch, n_negatives))
    return line_update(y, i, j, negs, layout_engine.step_lr(rho0, t_frac),
                       clip=clip)


def line_layout(generator, edge_sampler, neg_sampler, n_nodes: int, *,
                out_dim: int = 2, samples_per_node: int = 1000,
                n_negatives: int = 5, batch: int = 4096,
                rho0: float = 0.025):
    """LINE's layout: y ~ N(0, 1e-3^2) from ``generator``, then
    ``samples_per_node * n_nodes // batch`` steps; returns (y, steps)."""
    dev = edge_sampler.src.device
    y = torch.randn((n_nodes, out_dim), generator=generator,
                    device=dev) * 1e-3
    steps = max(1, samples_per_node * n_nodes // batch)
    for t in range(steps):
        y = line_step(y, generator, t / steps, edge_sampler=edge_sampler,
                      neg_sampler=neg_sampler, n_negatives=n_negatives,
                      batch=batch, rho0=rho0)
    return y, steps
