"""The SGD edge step of the layout (paper §3.2).

``sgd_edge_step`` samples a batch of edges and negatives from the alias
samplers, sets the t/T learning rate and applies the batch through
``apply_edge_batch``, whose only route in the port is the fused edge-step
kernel (``kernels/largevis_step.py``; its plain version on the CPU).  The
split gather/grad/scatter path and the autodiff ``prob_fn``s are not
ported yet: asking for them raises instead of silently taking another
route.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels import ops


def apply_edge_batch(y, i, j, negs, neg_mask, lr, *,
                     prob_fn: str = "inv_quadratic", a: float = 1.0,
                     gamma: float = 7.0, clip: float = 5.0,
                     layout_step: str = "auto"):
    """Apply one pre-sampled edge batch to the (N, s) embedding in place.

    ``lr`` is a float or a (B,) per-edge tensor.  Duplicate rows
    accumulate in the canonical per-edge order ``[i_e, j_e,
    negs_e,0..M-1]``.
    """
    if layout_step not in ("auto", "fused"):
        raise NotImplementedError(
            f"layout_step={layout_step!r}: the split path (largevis_grads) "
            "is not ported yet (ROADMAP, Queue 1: split layout path)")
    if prob_fn != "inv_quadratic":
        raise NotImplementedError(
            f"prob_fn={prob_fn!r}: autodiff probability functions are not "
            "ported yet (ROADMAP, Queue 1: split layout path)")
    return ops.largevis_edge_step(y, i, j, negs, neg_mask, lr, gamma=gamma,
                                  a=a, clip=clip)


def step_lr(rho0: float, t_frac: float) -> float:
    """rho_t = rho0 * max(1 - t/T, 1e-4), in f32 as the JAX step has it."""
    f32 = np.float32
    return float(f32(rho0) * max(f32(1.0) - f32(t_frac), f32(1e-4)))


def sgd_edge_step(y, generator, t_frac: float, *, edge_sampler,
                  neg_sampler, n_negatives: int,
                  prob_fn: str = "inv_quadratic", a: float = 1.0,
                  gamma: float = 7.0, clip: float = 5.0, rho0: float = 1.0,
                  batch: int = 4096, layout_step: str = "auto"):
    """One SGD step over a freshly sampled edge batch; t_frac = t/T."""
    i, j = edge_sampler.sample(generator, batch)
    negs = neg_sampler.sample(generator, (batch, n_negatives))
    # a negative that is the source or the target of its edge is masked
    neg_mask = ((negs != i[:, None]) & (negs != j[:, None])).float()
    return apply_edge_batch(y, i, j, negs, neg_mask, step_lr(rho0, t_frac),
                            prob_fn=prob_fn, a=a, gamma=gamma, clip=clip,
                            layout_step=layout_step)
