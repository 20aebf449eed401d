"""Launcher for the fused edge step in ``csrc/largevis_step.cu``.

One in-place SGD update of the (N, s) embedding over a batch of sampled
edges, in one cooperative launch and without a sort: phase 0 computes
and stages every update row and links it into its destination row's
list (an ``atomicExch`` on a per-row head); after a grid-wide sync,
phase 1 lets one owner a row add the row's updates in ascending stream
position, which is the canonical per-edge order ``[i_e, j_e,
negs_e,0..M-1]``; a row with more than a few updates is left to phase
2, after a second sync, where a block gathers its updates in that order
by one scan of the destinations.  Bitwise equal to
``ref.fused_edge_step_ref`` run on the CPU.

The same launch without the forces is :func:`scatter_add_ordered`: the
split path's scatter of a staged update stream, with duplicates added in
stream order as the JAX split path's ``y.at[idx].add(upd)`` adds them on
the CPU (``index_add_`` on CUDA uses atomics, whose order varies from run
to run).  Its size rule: a stream of at most ``LINK_MAX_U`` updates
(every layout and transform step) takes the linked lists, one launch; a
longer one (the negative sampler's in-degree sum, U = N*K, whose rows
hold thousands of updates: a scan of all U updates for each of them
would not pay) takes a stable ``torch.sort`` of the destinations and one
thread a row segment.  The rule is on U alone; both paths are bitwise
equal.

The lists' heads (N int32, -1 between calls: each owner resets its row),
links, staged rows and destinations live in scratch that the launchers
keep across calls, keyed by device and shape: a call allocates nothing
and never synchronises with the host, so the step can be captured in a
CUDA graph.  Calls that share a key must run on one stream.

CUDA tensors only; each launcher counts its calls in
``<function>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_S = 4
# streams longer than this scatter through the sort (module docstring)
LINK_MAX_U = 1 << 17

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "edge_step_launch": ([_P, _I] + [_P] * 5 + [_I, _F, _I, _I]
                         + [_F] * 5 + [_I] + [_P] * 7),
    "scatter_link_launch": [_P, _I] + [_P] * 6 + [_I, _P],
    "edge_accumulate_launch": [_P, _I, _P, _P, _P, _I, _P],
}

# scratch kept across calls: {key: {name: tensor}}
_scratch: dict = {}


def _lib() -> ctypes.CDLL:
    return _build.load("largevis_step", _ARGTYPES)


def _buffers(key, dev, n_rows: int, U: int, s: int = 0) -> dict:
    """The lists' heads (n_rows, -1), links (U,), the count and list of
    rows with a long list, and, with ``s``, the staged rows (U, s) and
    their destinations (U,) for ``key``."""
    buf = _scratch.get(key)
    if buf is None:
        i32 = dict(dtype=torch.int32, device=dev)
        buf = dict(head=torch.full((n_rows,), -1, **i32),
                   next=torch.empty((U,), **i32),
                   n_long=torch.zeros((1,), **i32),
                   long_rows=torch.empty((U,), **i32))
        if s:
            buf.update(upd=torch.empty((U, s), dtype=torch.float32,
                                       device=dev),
                       dst=torch.empty((U,), **i32))
        _scratch[key] = buf
    return buf


def fused_edge_step(y, i, j, negs, neg_mask, lr, *, gamma: float = 7.0,
                    a: float = 1.0, clip: float = 5.0, eps: float = 0.1,
                    n_frozen: int = 0, y_tile: int = 0):
    """Update ``y`` (N, s) f32 on the card in place and return it.

    i/j: (B,) edge endpoints; negs: (B, M) negatives; neg_mask: (B, M)
    1.0 valid / 0.0 collision; lr: a float (a kernel argument), a 0-d
    tensor (read on the device, as a captured step needs) or a (B,)
    tensor.  Rows below ``n_frozen`` never change.  ``y_tile`` (the TPU
    kernel's VMEM slab size) is accepted and ignored: the card holds y in
    device memory.
    Indices must lie in [0, N): the kernel reads and writes those rows
    unchecked (checking would cost a device-to-host read per step).
    int32 indices and f32 mask and lr are used in place; other types are
    converted first.
    """
    del y_tile
    dev = y.device
    if dev.type != "cuda" or y.dtype != torch.float32 or \
            not y.is_contiguous():
        raise ValueError("fused_edge_step: y must be a contiguous f32 CUDA "
                         f"tensor, got {y.dtype} on {dev}")
    N, s = y.shape
    B, M = negs.shape
    if not 1 <= s <= MAX_S:
        raise ValueError(f"fused_edge_step: out_dim {s} outside [1, {MAX_S}]")
    for t in (i, j, negs, neg_mask):
        if t.device != dev:
            raise ValueError(f"fused_edge_step: {t.device} beside {dev}")
    i = i.to(torch.int32).contiguous()
    j = j.to(torch.int32).contiguous()
    negs = negs.to(torch.int32).contiguous()
    neg_mask = neg_mask.to(torch.float32).contiguous()
    lr_vec, lr_stride = None, 0
    if torch.is_tensor(lr):
        if lr.dim() and tuple(lr.shape) != (B,):
            raise ValueError(f"fused_edge_step: lr of shape "
                             f"{tuple(lr.shape)} for {B} edges")
        lr_vec = lr.to(device=dev, dtype=torch.float32).contiguous()
        lr_stride, lr = (1 if lr.dim() else 0), 0.0
    buf = _buffers(("step", dev, N, B, M, s), dev, N, B * (2 + M), s)
    p = _build.ptr
    rc = _lib().edge_step_launch(
        p(y), s, p(i), p(j), p(negs), p(neg_mask), p(lr_vec), lr_stride,
        float(lr), B, M, 2.0 * a, a, -2.0 * gamma, eps, clip, int(n_frozen),
        p(buf["upd"]), p(buf["dst"]), p(buf["next"]), p(buf["head"]),
        p(buf["n_long"]), p(buf["long_rows"]), _build.stream(dev))
    _build.check(rc, "fused_edge_step")
    fused_edge_step.launches += 1
    return y


fused_edge_step.launches = 0


def scatter_add_ordered(y, idx, upd):
    """``y[idx[u]] += upd[u]`` for u = 0..U-1 on the card, in place, with
    the updates to one row added in stream order; returns ``y``.

    y: (N, s) contiguous f32; idx: (U,) rows in [0, N), unchecked as in
    :func:`fused_edge_step`; upd: (U, s).  U <= ``LINK_MAX_U``: one
    launch through the linked lists; above it, a stable sort of idx and
    one launch a row segment (module docstring).
    """
    dev = y.device
    if dev.type != "cuda" or y.dtype != torch.float32 or \
            not y.is_contiguous():
        raise ValueError("scatter_add_ordered: y must be a contiguous f32 "
                         f"CUDA tensor, got {y.dtype} on {dev}")
    N, s = y.shape
    U = idx.shape[0]
    if not 1 <= s <= MAX_S:
        raise ValueError(f"scatter_add_ordered: out_dim {s} outside "
                         f"[1, {MAX_S}]")
    if tuple(upd.shape) != (U, s):
        raise ValueError(f"scatter_add_ordered: {U} rows beside updates of "
                         f"shape {tuple(upd.shape)}")
    for t in (idx, upd):
        if t.device != dev:
            raise ValueError(f"scatter_add_ordered: {t.device} beside {dev}")
    idx = idx.to(torch.int32).contiguous()
    upd = upd.to(torch.float32).contiguous()
    p, stream = _build.ptr, _build.stream(dev)
    if U <= LINK_MAX_U:
        buf = _buffers(("scatter", dev, N, U), dev, N, U)
        rc = _lib().scatter_link_launch(
            p(y), s, p(upd), p(idx), p(buf["next"]), p(buf["head"]),
            p(buf["n_long"]), p(buf["long_rows"]), U, stream)
    else:
        dst_sorted, perm = torch.sort(idx, stable=True)
        rc = _lib().edge_accumulate_launch(p(y), s, p(upd), p(dst_sorted),
                                           p(perm), U, stream)
    _build.check(rc, "scatter_add_ordered")
    scatter_add_ordered.launches += 1
    return y


scatter_add_ordered.launches = 0
