"""Kernel routing by tensor device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain version in ``kernels/ref.py``.  Nothing
falls back from one to the other.  The tile constants are the JAX
package's ``AUTOTUNE=off`` defaults; the port has no autotuner yet.
"""
from __future__ import annotations

from repro_torch.kernels import knn_topk, largevis_grad, largevis_step, ref

# the JAX package's legacy (autotune "off") tiles; results do not depend
# on them, only memory and speed do
SYMMETRIZE_TILE = 4096
EXPLORE_TILE = 1024


def _route(t) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def pairwise_sqdist(a, b):
    """(M, N) squared distances between the rows of a and b, f32."""
    if _route(a):
        return knn_topk.pairwise_sqdist(a, b)
    return ref.pairwise_sqdist_ref(a, b)


def topk_sqdist(a, b, k, **kw):
    """Streaming distance -> top-k; see ``ref.topk_sqdist_ref``."""
    if _route(a):
        return knn_topk.topk_sqdist(a, b, k, **kw)
    return ref.topk_sqdist_ref(a, b, k, **kw)


def largevis_edge_step(y, i, j, negs, neg_mask, lr, *, gamma=7.0, a=1.0,
                       clip=5.0, eps=0.1, n_frozen: int = 0):
    """One fused SGD edge step on ``y``, in place; returns ``y``."""
    if _route(y):
        return largevis_step.fused_edge_step(
            y, i, j, negs, neg_mask, lr, gamma=gamma, a=a, clip=clip,
            eps=eps, n_frozen=n_frozen)
    return ref.fused_edge_step_ref(y, i, j, negs, neg_mask, lr, gamma=gamma,
                                   a=a, clip=clip, eps=eps, n_frozen=n_frozen)


def largevis_grads(yi, yj, yneg, neg_mask, *, gamma=7.0, a=1.0, clip=5.0,
                   eps=0.1):
    """The Eqn-6 forces (gi, gj, gneg) of gathered edge coordinates."""
    if _route(yi):
        return largevis_grad.largevis_grads(yi, yj, yneg, neg_mask,
                                            gamma=gamma, a=a, clip=clip,
                                            eps=eps)
    return ref.largevis_grads_ref(yi, yj, yneg, gamma=gamma, a=a, clip=clip,
                                  eps=eps, neg_mask=neg_mask)


def scatter_add_ordered(y, idx, upd):
    """``y[idx] += upd`` in place, duplicates in stream order; returns y."""
    if _route(y):
        return largevis_step.scatter_add_ordered(y, idx, upd)
    return ref.scatter_add_ordered_ref(y, idx, upd)


_LAUNCHERS = {
    "topk_sqdist": knn_topk.topk_sqdist,
    "fused_edge_step": largevis_step.fused_edge_step,
    "pairwise_sqdist": knn_topk.pairwise_sqdist,
    "largevis_grads": largevis_grad.largevis_grads,
    "scatter_add_ordered": largevis_step.scatter_add_ordered,
}


def launch_counts() -> dict:
    """Kernel launches so far, by kernel."""
    return {name: fn.launches for name, fn in _LAUNCHERS.items()}


def reset_launch_counts() -> None:
    for fn in _LAUNCHERS.values():
        fn.launches = 0
