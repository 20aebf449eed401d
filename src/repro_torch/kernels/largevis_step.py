"""Launcher for the fused edge step in ``csrc/largevis_step.cu``.

One in-place SGD update of the (N, s) embedding over a batch of sampled
edges: phase 0 computes and stages every update row, a stable sort of
the destination rows orders them, phase 1 adds each row's updates in the
canonical per-edge order ``[i_e, j_e, negs_e,0..M-1]``.  Bitwise equal
to ``ref.fused_edge_step_ref`` run on the CPU.

Phase 1 alone, the sort and the accumulation, is also
:func:`scatter_add_ordered`: the split path's scatter of a staged update
stream, with duplicates added in stream order as the JAX split path's
``y.at[idx].add(upd)`` adds them on the CPU (``index_add_`` on CUDA uses
atomics, whose order varies from run to run).

CUDA tensors only; each launcher counts its calls in
``<function>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_S = 4

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "edge_forces_launch": ([_P, _I] + [_P] * 5 + [_F, _I, _I] + [_F] * 5
                           + [_I, _P, _P, _P]),
    "edge_accumulate_launch": [_P, _I, _P, _P, _P, _I, _P],
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("largevis_step")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def fused_edge_step(y, i, j, negs, neg_mask, lr, *, gamma: float = 7.0,
                    a: float = 1.0, clip: float = 5.0, eps: float = 0.1,
                    n_frozen: int = 0, y_tile: int = 0):
    """Update ``y`` (N, s) f32 on the card in place and return it.

    i/j: (B,) edge endpoints; negs: (B, M) negatives; neg_mask: (B, M)
    1.0 valid / 0.0 collision; lr: a float or a (B,) tensor.  Rows below
    ``n_frozen`` never change.  ``y_tile`` (the TPU kernel's VMEM slab
    size) is accepted and ignored: the card holds y in device memory.
    Indices must lie in [0, N): the kernel reads and writes those rows
    unchecked (checking would cost a device-to-host read per step).
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
    lr_vec = None
    if torch.is_tensor(lr) and lr.dim():
        lr_vec = lr.to(device=dev, dtype=torch.float32).contiguous()
        lr = 0.0
    lr = float(lr)
    U = B * (2 + M)
    upd = torch.empty((U, s), dtype=torch.float32, device=dev)
    dst = torch.empty((U,), dtype=torch.int32, device=dev)
    lib = _lib()
    stream = _build.stream(dev)
    p = _build.ptr
    rc = lib.edge_forces_launch(
        p(y), s, p(i), p(j), p(negs), p(neg_mask), p(lr_vec), lr, B, M,
        2.0 * a, a, -2.0 * gamma, eps, clip, int(n_frozen), p(upd), p(dst),
        stream)
    _build.check(rc, "fused_edge_step (phase 0)")
    _accumulate(lib, y, dst, upd, stream, "fused_edge_step (phase 1)")
    fused_edge_step.launches += 1
    return y


fused_edge_step.launches = 0


def _accumulate(lib, y, dst, upd, stream, what: str) -> None:
    """Phase 1: stable-sort the destination rows, then add each row's
    updates in stream order."""
    dst_sorted, perm = torch.sort(dst, stable=True)
    rc = lib.edge_accumulate_launch(_build.ptr(y), y.shape[1],
                                    _build.ptr(upd), _build.ptr(dst_sorted),
                                    _build.ptr(perm), dst.shape[0], stream)
    _build.check(rc, what)


def scatter_add_ordered(y, idx, upd):
    """``y[idx[u]] += upd[u]`` for u = 0..U-1 on the card, in place, with
    the updates to one row added in stream order; returns ``y``.

    y: (N, s) contiguous f32; idx: (U,) rows in [0, N), unchecked as in
    :func:`fused_edge_step`; upd: (U, s).
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
    _accumulate(_lib(), y, idx.to(torch.int32).contiguous(),
                upd.to(torch.float32).contiguous(), _build.stream(dev),
                "scatter_add_ordered")
    scatter_add_ordered.launches += 1
    return y


scatter_add_ordered.launches = 0
