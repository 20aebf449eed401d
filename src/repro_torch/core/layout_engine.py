"""The SGD edge step of the layout (paper §3.2).

``sgd_edge_step`` samples a batch of edges and negatives from the alias
samplers, sets the t/T learning rate and applies the batch through
``apply_edge_batch``, which routes it as the JAX package does:

* the fused route — one edge-step kernel gathers, computes the forces and
  scatters (``kernels/largevis_step.py``) — for ``layout_step`` "auto" or
  "fused" with the hand-derived ``prob_fn="inv_quadratic"``;
* the split route otherwise: gather with torch indexing, the forces from
  the ``largevis_grads`` kernel (``inv_quadratic``) or autograd
  (``core/objective.py``, any other ``prob_fn``), then the ordered
  scatter (``ops.scatter_add_ordered``).

Both routes add the updates in the canonical per-edge order, so for
``inv_quadratic`` they agree bitwise, on the CPU and on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import objective
from repro_torch.kernels import ops

LAYOUT_STEPS = ("auto", "fused", "split")


def edge_update_stream(i, j, negs, gi, gj, gneg, lr, n_frozen: int = 0):
    """The split route's update stream: rows ``idx`` (B*(2+M),) and
    updates ``-lr * g`` (B*(2+M), s) in the canonical per-edge order
    ``[i_e, j_e, negs_e,0..M-1] for e = 0..B-1``.

    ``lr`` is a scalar or a (B,) per-edge vector.  Updates to rows below
    ``n_frozen`` become -0.0, a bitwise no-op when added.
    """
    s = gi.shape[1]
    idx = torch.cat([i[:, None], j[:, None], negs], dim=1).reshape(-1)
    upd = torch.cat([gi[:, None], gj[:, None], gneg], dim=1).reshape(-1, s)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gi.device)
    if lr.dim():                         # (B,) per-edge -> per update row
        lr = lr.repeat_interleave(2 + negs.shape[1])[:, None]
    upd = -lr * upd
    if n_frozen:
        upd = torch.where((idx >= n_frozen)[:, None], upd,
                          torch.tensor(-0.0, device=gi.device))
    return idx, upd


def apply_edge_batch(y, i, j, negs, neg_mask, lr, *,
                     prob_fn: str = "inv_quadratic", a: float = 1.0,
                     gamma: float = 7.0, clip: float = 5.0,
                     layout_step: str = "auto", n_frozen: int = 0):
    """Apply one pre-sampled edge batch to the (N, s) embedding in place.

    ``lr`` is a float or a (B,) per-edge tensor.  Duplicate rows
    accumulate in the canonical per-edge order ``[i_e, j_e,
    negs_e,0..M-1]``.  Rows below ``n_frozen`` never change (the
    frozen-corpus transform).  Returns ``y``.
    """
    if layout_step not in LAYOUT_STEPS:
        raise ValueError(f"layout_step={layout_step!r}: expected one of "
                         f"{LAYOUT_STEPS}")
    if layout_step != "split" and prob_fn == "inv_quadratic":
        return ops.largevis_edge_step(y, i, j, negs, neg_mask, lr,
                                      gamma=gamma, a=a, clip=clip,
                                      n_frozen=n_frozen)
    i, j, negs = i.long(), j.long(), negs.long()
    yi, yj, yneg = y[i], y[j], y[negs]
    if prob_fn == "inv_quadratic":
        gi, gj, gneg = ops.largevis_grads(yi, yj, yneg, neg_mask,
                                          gamma=gamma, a=a, clip=clip)
    else:
        gi, gj, gneg = objective.grads_autodiff(
            yi, yj, yneg, neg_mask, prob_fn=prob_fn, a=a, gamma=gamma,
            clip=clip)
    idx, upd = edge_update_stream(i, j, negs, gi, gj, gneg, lr, n_frozen)
    return ops.scatter_add_ordered(y, idx, upd)


def step_lr(rho0: float, t_frac: float) -> float:
    """rho_t = rho0 * max(1 - t/T, 1e-4), in f32 as the JAX step has it."""
    f32 = np.float32
    return float(f32(rho0) * max(f32(1.0) - f32(t_frac), f32(1e-4)))


def sgd_edge_step(y, generator, t_frac: float, *, edge_sampler,
                  neg_sampler, n_negatives: int,
                  prob_fn: str = "inv_quadratic", a: float = 1.0,
                  gamma: float = 7.0, clip: float = 5.0, rho0: float = 1.0,
                  batch: int = 4096, layout_step: str = "auto"):
    """One SGD step over a freshly sampled edge batch; t_frac = t/T.  The
    batch is drawn before it is routed, so every route sees the same
    batch from the same generator."""
    i, j = edge_sampler.sample(generator, batch)
    negs = neg_sampler.sample(generator, (batch, n_negatives))
    # a negative that is the source or the target of its edge is masked
    neg_mask = ((negs != i[:, None]) & (negs != j[:, None])).float()
    return apply_edge_batch(y, i, j, negs, neg_mask, step_lr(rho0, t_frac),
                            prob_fn=prob_fn, a=a, gamma=gamma, clip=clip,
                            layout_step=layout_step)
