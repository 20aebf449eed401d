"""Probabilistic layout model (paper §3.2, Eqn 3-6).

P(e_ij = 1) = f(||y_i - y_j||).  The probability functions the paper's
Fig. 4 compares: f(x) = 1/(1 + a x^2), the long-tailed winner, and
f(x) = 1/(1 + exp(x^2)).  The winner's forces are hand-derived (the
``largevis_grads`` kernel and the fused edge step); any other ``prob_fn``
goes through autograd of the loss below, on the split layout path.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import softplus as _softplus

PROB_FNS = ("inv_quadratic", "exp_quadratic")


def log_f(d2: torch.Tensor, prob_fn: str, a: float) -> torch.Tensor:
    """log P(edge) as a function of squared distance."""
    if prob_fn == "inv_quadratic":
        return -torch.log1p(a * d2)
    if prob_fn == "exp_quadratic":                        # f = 1/(1+e^{x^2})
        return -_softplus(d2)
    raise ValueError(prob_fn)


def log_1mf(d2: torch.Tensor, prob_fn: str, a: float,
            eps: float = 0.1) -> torch.Tensor:
    """log(1 - P(edge)); eps guards the collision singularity."""
    if prob_fn == "inv_quadratic":
        return torch.log(a * d2 + eps) - torch.log1p(a * d2)
    if prob_fn == "exp_quadratic":                        # 1-f = 1/(1+e^-x^2)
        return -_softplus(-d2)
    raise ValueError(prob_fn)


def edge_batch_loss(yi, yj, yneg, neg_mask, *, prob_fn: str = "inv_quadratic",
                    a: float = 1.0, gamma: float = 7.0) -> torch.Tensor:
    """Negated Eqn (6) over a sampled batch (to minimise)."""
    d2 = ((yi - yj) ** 2).sum(-1)
    pos = -log_f(d2, prob_fn, a)
    dn2 = ((yi[:, None, :] - yneg) ** 2).sum(-1)
    neg = -gamma * log_1mf(dn2, prob_fn, a) * neg_mask
    return pos.sum() + neg.sum()


def grads_autodiff(yi, yj, yneg, neg_mask, *, prob_fn: str, a: float = 1.0,
                   gamma: float = 7.0, clip: float = 5.0):
    """(gi, gj, gneg) of :func:`edge_batch_loss` by autograd, each
    coordinate clipped to +-clip."""
    leaves = [t.detach().float().requires_grad_(True) for t in (yi, yj, yneg)]
    with torch.enable_grad():
        loss = edge_batch_loss(*leaves, neg_mask.float(), prob_fn=prob_fn,
                               a=a, gamma=gamma)
        grads = torch.autograd.grad(loss, leaves)
    return tuple(g.clamp(-clip, clip) for g in grads)
