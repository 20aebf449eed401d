"""Launchers for the Eqn-6 force kernels in ``csrc/largevis_grad.cu``.

The split layout path's force stage, in two forms:

* :func:`largevis_grads`, the JAX contract: from gathered coordinates
  yi, yj (B, s) and yneg (B, M, s) and the (B, M) mask of valid
  negatives, the clipped forces (gi, gj, gneg), with no gather and no
  scatter;
* :func:`largevis_grads_stream`, what the split route runs: y read in
  place through the sampler's int32 indices, and the update stream
  ``(idx, upd)`` that ``scatter_add_ordered`` takes written directly, in
  the canonical per-edge order, one launch.

Both run the fused edge step's own force arithmetic, so on the card the
first is bitwise ``ref.largevis_grads_ref`` run on the CPU and the second
bitwise ``ref.largevis_grads_stream_ref``.  CUDA tensors only; both
count their launches in ``largevis_grads.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_S = 4

# 2 + M update rows of an edge share one block of 256 threads
MAX_M = 254

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "largevis_grads_launch": [_P] * 4 + [_I] * 3 + [_F] * 5 + [_P] * 4,
    "grads_stream_launch": ([_P, _I] + [_P] * 5 + [_I, _F, _I, _I]
                            + [_F] * 5 + [_I, _P, _P, _P]),
}

# the stream's outputs kept across calls: {key: (idx, upd)}
_scratch: dict = {}


def _lib() -> ctypes.CDLL:
    return _build.load("largevis_grad", _ARGTYPES)


def largevis_grads(yi, yj, yneg, neg_mask, *, gamma: float = 7.0,
                   a: float = 1.0, clip: float = 5.0, eps: float = 0.1,
                   tile: int | None = None):
    """yi/yj (B, s), yneg (B, M, s), neg_mask (B, M) 1.0 valid / 0.0 skip,
    all on one CUDA device -> (gi (B, s), gj (B, s), gneg (B, M, s)) f32.

    Any B, 0 included.  ``tile`` (the TPU kernel's edge tile) is accepted
    and ignored: the grid covers any B.
    """
    del tile
    dev = yi.device
    for t in (yi, yj, yneg, neg_mask):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError("largevis_grads: tensors on one CUDA device, "
                             f"got {t.device} beside {dev}")
    B, s = yi.shape
    M = yneg.shape[1]
    if not 1 <= s <= MAX_S:
        raise ValueError(f"largevis_grads: out_dim {s} outside [1, {MAX_S}]")
    if tuple(yj.shape) != (B, s) or tuple(yneg.shape) != (B, M, s) or \
            tuple(neg_mask.shape) != (B, M):
        raise ValueError(
            f"largevis_grads: shapes {tuple(yi.shape)}, {tuple(yj.shape)}, "
            f"{tuple(yneg.shape)}, {tuple(neg_mask.shape)} do not pair")
    yi, yj, yneg, neg_mask = (t.to(torch.float32).contiguous()
                              for t in (yi, yj, yneg, neg_mask))
    gi = torch.empty((B, s), dtype=torch.float32, device=dev)
    gj = torch.empty((B, s), dtype=torch.float32, device=dev)
    gneg = torch.empty((B, M, s), dtype=torch.float32, device=dev)
    p = _build.ptr
    rc = _lib().largevis_grads_launch(
        p(yi), p(yj), p(yneg), p(neg_mask), B, M, s, 2.0 * a, a,
        -2.0 * gamma, eps, clip, p(gi), p(gj), p(gneg), _build.stream(dev))
    _build.check(rc, "largevis_grads")
    largevis_grads.launches += 1
    return gi, gj, gneg


largevis_grads.launches = 0


def largevis_grads_stream(y, i, j, negs, neg_mask, lr, n_frozen: int = 0,
                          *, gamma: float = 7.0, a: float = 1.0,
                          clip: float = 5.0, eps: float = 0.1):
    """The split route's update stream of one edge batch, on the card.

    y (N, s) f32; i/j (B,) and negs (B, M) rows of y; neg_mask (B, M) 1.0
    valid / 0.0 collision; lr a float (a kernel argument), a 0-d tensor
    (read on the device, as a captured step needs) or a (B,) per-edge
    tensor.  Returns ``(idx (B*(2+M),) int32, upd (B*(2+M), s) f32)``:
    rows ``[i_e, j_e, negs_e,0..M-1]`` for e = 0..B-1 and their updates
    ``g * -lr``, -0.0 for rows below ``n_frozen``.

    The outputs are scratch kept across calls and keyed by device and
    shape: a call allocates nothing and does not synchronise, so it can be
    captured in a CUDA graph, and the next call with the same key
    overwrites them.  Calls sharing a key must run on one stream.
    Indices must lie in [0, N): the kernel reads those rows unchecked.
    int32 indices and f32 mask and lr are used in place; other types are
    converted first.
    """
    dev = y.device
    if dev.type != "cuda" or y.dtype != torch.float32 or \
            not y.is_contiguous():
        raise ValueError("largevis_grads_stream: y must be a contiguous f32 "
                         f"CUDA tensor, got {y.dtype} on {dev}")
    s = y.shape[1]
    B, M = negs.shape
    if not 1 <= s <= MAX_S:
        raise ValueError(f"largevis_grads_stream: out_dim {s} outside "
                         f"[1, {MAX_S}]")
    if not 0 <= M <= MAX_M:
        raise ValueError(f"largevis_grads_stream: {M} negatives outside "
                         f"[0, {MAX_M}]")
    if tuple(i.shape) != (B,) or tuple(j.shape) != (B,) or \
            tuple(neg_mask.shape) != (B, M):
        raise ValueError(
            f"largevis_grads_stream: shapes {tuple(i.shape)}, "
            f"{tuple(j.shape)}, {tuple(negs.shape)}, "
            f"{tuple(neg_mask.shape)} do not pair")
    for t in (i, j, negs, neg_mask):
        if t.device != dev:
            raise ValueError(f"largevis_grads_stream: {t.device} beside "
                             f"{dev}")
    i = i.to(torch.int32).contiguous()
    j = j.to(torch.int32).contiguous()
    negs = negs.to(torch.int32).contiguous()
    neg_mask = neg_mask.to(torch.float32).contiguous()
    lr_vec, lr_stride = None, 0
    if torch.is_tensor(lr):
        if lr.dim() and tuple(lr.shape) != (B,):
            raise ValueError(f"largevis_grads_stream: lr of shape "
                             f"{tuple(lr.shape)} for {B} edges")
        lr_vec = lr.to(device=dev, dtype=torch.float32).contiguous()
        lr_stride, lr = (1 if lr.dim() else 0), 0.0
    key = ("stream", dev, B, M, s)
    if key not in _scratch:
        U = B * (2 + M)
        _scratch[key] = (torch.empty((U,), dtype=torch.int32, device=dev),
                         torch.empty((U, s), dtype=torch.float32,
                                     device=dev))
    idx, upd = _scratch[key]
    p = _build.ptr
    rc = _lib().grads_stream_launch(
        p(y), s, p(i), p(j), p(negs), p(neg_mask), p(lr_vec), lr_stride,
        float(lr), B, M, 2.0 * a, a, -2.0 * gamma, eps, clip, int(n_frozen),
        p(idx), p(upd), _build.stream(dev))
    _build.check(rc, "largevis_grads_stream")
    largevis_grads.launches += 1
    return idx, upd


# The JAX package's any-B name: the TPU kernel pads B to a whole tile, the
# card needs no padding, so it is the same launch.
largevis_grads_chunked = largevis_grads
