"""Launcher for the Eqn-6 force kernel in ``csrc/largevis_grad.cu``.

The split layout path's force stage: from gathered coordinates yi, yj
(B, s) and yneg (B, M, s) and the (B, M) mask of valid negatives, the
clipped forces (gi, gj, gneg), with no gather and no scatter.  The kernel
runs the fused edge step's own force arithmetic, so on the card it is
bitwise ``ref.largevis_grads_ref`` run on the CPU.  CUDA tensors only;
the launcher counts its calls in ``largevis_grads.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_S = 4

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 3 + [_F] * 5 + [_P] * 4


def _lib() -> ctypes.CDLL:
    lib = _build.load("largevis_grad")
    lib.largevis_grads_launch.argtypes = _ARGTYPES
    lib.largevis_grads_launch.restype = ctypes.c_int
    return lib


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

# The JAX package's any-B name: the TPU kernel pads B to a whole tile, the
# card needs no padding, so it is the same launch.
largevis_grads_chunked = largevis_grads
