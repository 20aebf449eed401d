"""Kernel routing by tensor device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain version in ``kernels/ref.py``.  Nothing
falls back from one to the other.  A tensor on the meta device (the dry
run's, ``launch/dryrun.py``) gets the kernel's outputs as shapes and
dtypes alone, on the meta device: the edge step, the scatter and the
flash kernels, which the dry run's steps reach.  The kernels choose their
own tiles; the tuned tiles of the plain stages are
``runtime/autotune.py``'s.

Inside :func:`recording_work` a flash call that goes to the kernel or, on
the meta device, to its shapes records its work (operations, bytes),
which no operation counter sees (``launch/hlo_analysis.py`` adds it to
its counts); on the CPU the plain version's ops are counted like any
other.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.kernels import (flash_attention as flash, knn_topk,
                                 largevis_grad, largevis_step, ref)

_WORK = threading.local()


def _route(t, shapes: bool = False):
    """True for the kernel (CUDA), False for the plain version (CPU); None
    for the meta device where the caller gives its outputs' ``shapes``."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    if shapes and t.device.type == "meta":
        return None
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
    route = _route(y, shapes=True)
    if route is None:
        return y
    if route:
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


def largevis_grads_stream(y, i, j, negs, neg_mask, lr, n_frozen: int = 0,
                          *, gamma=7.0, a=1.0, clip=5.0, eps=0.1):
    """The split route's update stream ``(idx, upd)`` of an edge batch,
    forces from y read at the batch's rows; see
    ``ref.largevis_grads_stream_ref``."""
    kw = dict(gamma=gamma, a=a, clip=clip, eps=eps)
    route = _route(y, shapes=True)
    if route is None:
        U = i.shape[0] * (2 + negs.shape[1])
        return (y.new_empty((U,), dtype=torch.int32),
                y.new_empty((U, y.shape[1])))
    if route:
        return largevis_grad.largevis_grads_stream(y, i, j, negs, neg_mask,
                                                   lr, n_frozen, **kw)
    return ref.largevis_grads_stream_ref(y, i, j, negs, neg_mask, lr,
                                         n_frozen, **kw)


def scatter_add_ordered(y, idx, upd):
    """``y[idx] += upd`` in place, duplicates in stream order; returns y."""
    route = _route(y, shapes=True)
    if route is None:
        return y
    if route:
        return largevis_step.scatter_add_ordered(y, idx, upd)
    return ref.scatter_add_ordered_ref(y, idx, upd)


@contextlib.contextmanager
def recording_work():
    """Yields a list that collects ``(label, operations, bytes)`` of each
    flash call in the block that goes to the kernel or to its shapes
    (thread-local)."""
    prev = getattr(_WORK, "log", None)
    _WORK.log = log = []
    try:
        yield log
    finally:
        _WORK.log = prev


def _flash_work(label, q, k, causal, window, backward=False) -> None:
    log = getattr(_WORK, "log", None)
    if log is not None:
        log.append((label, *flash.work(q, k, causal=causal, window=window,
                                       backward=backward)))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Forward attention, heads pre-broadcast, top-left causal mask and
    an optional sliding window; see ``ref.flash_attention_ref``."""
    route = _route(q, shapes=True)
    if route is not False:
        _flash_work("flash_attention", q, k, causal, window)
    if route is None:
        return torch.empty_like(q)
    if route:
        return flash.flash_attention(q, k, v, causal=causal, window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0):
    """The training forward: (out, lse), lse (B, H, S) f32; see
    ``ref.flash_attention_fwd_ref``.  On the card the forward kernel,
    counted as ``flash_attention``."""
    route = _route(q, shapes=True)
    if route is not False:
        _flash_work("flash_attention", q, k, causal, window)
    if route is None:
        B, S, H, _ = q.shape
        return torch.empty_like(q), q.new_empty((B, H, S),
                                                dtype=torch.float32)
    if route:
        return flash.flash_attention(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    return ref.flash_attention_fwd_ref(q, k, v, causal=causal, window=window)


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of the forward from its ``out`` and ``lse``; see
    ``ref.flash_attention_bwd_ref``."""
    route = _route(q, shapes=True)
    if route is not False:
        _flash_work("flash_attention_bwd", q, k, causal, window, True)
    if route is None:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if route:
        return flash.flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=causal, window=window)
    return ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                       causal=causal, window=window)


_LAUNCHERS = {
    "topk_sqdist": knn_topk.topk_sqdist,
    "fused_edge_step": largevis_step.fused_edge_step,
    "pairwise_sqdist": knn_topk.pairwise_sqdist,
    "largevis_grads": largevis_grad.largevis_grads,
    "scatter_add_ordered": largevis_step.scatter_add_ordered,
    "flash_attention": flash.flash_attention,
    "flash_attention_bwd": flash.flash_attention_bwd,
}


def launch_counts() -> dict:
    """Kernel launches so far, by kernel."""
    return {name: fn.launches for name, fn in _LAUNCHERS.items()}


def reset_launch_counts() -> None:
    for fn in _LAUNCHERS.values():
        fn.launches = 0


def capture_launches(record) -> dict:
    """Run ``record``, a CUDA graph capture, and return the launches its
    wrappers counted, by kernel.  A capture launches nothing, so those
    counts are taken back off; each replay of the graph then adds them
    with :func:`add_launches`."""
    before = launch_counts()
    try:
        record()
        after = launch_counts()
    finally:
        for name, c in before.items():
            _LAUNCHERS[name].launches = c
    return {name: c - before[name] for name, c in after.items()
            if c != before[name]}


def add_launches(made: dict) -> None:
    """Count the launches of one graph replay (from
    :func:`capture_launches`)."""
    for name, c in made.items():
        _LAUNCHERS[name].launches += c
