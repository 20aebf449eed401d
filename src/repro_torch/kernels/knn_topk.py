"""Launchers for the KNN kernels in ``csrc/knn_topk.cu``.

``topk_sqdist`` — streaming distance -> top-k over a leading group
dimension (the forest's window blocks of one tree are one launch);
``pairwise_sqdist`` — the blocked (M, N) squared-distance matrix.

The kernels sum the row norms |a|^2 and |b|^2 themselves, in the order
of ``ref.sq_norms``, and their dot products in feature order, as cuBLAS's
f32 GEMM does.  So on the card a kernel's distances, and the top-k ids
that follow from them, are bitwise its plain version's.

Both take CUDA tensors only and launch their kernel or raise; the
routing by device, and the plain versions the CPU runs, are in
``kernels/ops.py`` and ``kernels/ref.py``.  Each launcher counts its
launches in ``<function>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_K = 256
# Blocks of one launch: a linear grid index, at most 2^31 - 1.  A block
# of topk_sqdist owns 32 rows of one group, one of pairwise_sqdist a
# 64 x 64 output tile.
MAX_BLOCKS = 2**31 - 1

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "topk_sqdist_launch": [_P] * 6 + [_I] + [_P] * 4 + [_I] * 7 + [_P],
    "pairwise_sqdist_launch": [_P] * 3 + [_I] * 3 + [_P],
}


def _check_blocks(what: str, blocks: int) -> None:
    if blocks > MAX_BLOCKS:
        raise ValueError(f"{what}: {blocks} thread blocks exceed one "
                         f"launch's limit of {MAX_BLOCKS}")


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn_topk")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def _on_card(*ts) -> torch.device:
    dev = ts[0].device
    for t in ts:
        if t is not None and (t.device.type != "cuda" or t.device != dev):
            raise ValueError("the CUDA kernels take tensors on one CUDA "
                             f"device, got {t.device} beside {dev}")
    return dev


def topk_sqdist(a, b, k: int, *, a_ids=None, b_ids=None, codes_a=None,
                codes_b=None, init_ids=None, init_dists=None,
                dedup: bool = False, bn: int | None = None):
    """Same contract as ``ref.topk_sqdist_ref``: a (M, d) or (G, M, d),
    b (N, d) or (G, N, d) -> (ids int32, sqdists f32) of shape
    (..., M, k), distances ascending.  ``bn`` is the column-tile width of
    the dedup semantics (the kernel's own tiles are internal)."""
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
        a_ids, b_ids, codes_a, codes_b, init_ids, init_dists = (
            None if t is None else t[None]
            for t in (a_ids, b_ids, codes_a, codes_b, init_ids, init_dists))
    dev = _on_card(a, b, a_ids, b_ids, codes_a, codes_b, init_ids,
                   init_dists)
    G, M, d = a.shape
    N = b.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_sqdist: k={k} outside [1, {MAX_K}]")
    if d < 1 or b.shape[0] != G or b.shape[2] != d:
        raise ValueError(f"topk_sqdist: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not pair")
    if (codes_a is None) != (codes_b is None) or \
            (init_ids is None) != (init_dists is None):
        raise ValueError("topk_sqdist: codes_a/codes_b and init_ids/"
                         "init_dists come in pairs")
    _check_blocks("topk_sqdist", G * -(-M // 32))
    bn = bn or ref.dedup_tile(N)

    def i32(t, shape):
        return t.to(torch.int32).expand(shape).contiguous()

    a = a.float().contiguous()
    b = b.float().contiguous()
    a_ids = (torch.full((G, M), -1, dtype=torch.int32, device=dev)
             if a_ids is None else i32(a_ids, (G, M)))
    b_ids = (torch.arange(N, dtype=torch.int32, device=dev).expand(G, N)
             .contiguous() if b_ids is None else i32(b_ids, (G, N)))
    T = 0
    if codes_a is not None:
        T = codes_a.shape[-1]
        codes_a, codes_b = i32(codes_a, (G, M, T)), i32(codes_b, (G, N, T))
    if init_ids is not None:
        init_ids = i32(init_ids, (G, M, k))
        init_dists = init_dists.float().expand(G, M, k).contiguous()
    out_ids = torch.empty((G, M, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((G, M, k), dtype=torch.float32, device=dev)
    p = _build.ptr
    rc = _lib().topk_sqdist_launch(
        p(a), p(b), p(a_ids), p(b_ids), p(codes_a), p(codes_b), T,
        p(init_ids), p(init_dists), p(out_ids), p(out_d), G, M, N, d, k,
        int(min(bn, max(N, 1))), int(bool(dedup)), _build.stream(dev))
    _build.check(rc, "topk_sqdist")
    topk_sqdist.launches += 1
    if squeeze:
        return out_ids[0], out_d[0]
    return out_ids, out_d


topk_sqdist.launches = 0


def pairwise_sqdist(a, b):
    """a (M, d), b (N, d) on the card -> (M, N) squared distances, f32."""
    dev = _on_card(a, b)
    M, d = a.shape
    N = b.shape[0]
    if b.shape[1] != d:
        raise ValueError(f"pairwise_sqdist: widths {d} and {b.shape[1]}")
    _check_blocks("pairwise_sqdist", -(-M // 64) * -(-N // 64))
    a = a.float().contiguous()
    b = b.float().contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    p = _build.ptr
    rc = _lib().pairwise_sqdist_launch(p(a), p(b), p(out), M, N, d,
                                       _build.stream(dev))
    _build.check(rc, "pairwise_sqdist")
    pairwise_sqdist.launches += 1
    return out


pairwise_sqdist.launches = 0
