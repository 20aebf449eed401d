"""Launchers for the KNN kernels in ``csrc/knn_topk.cu``.

``topk_sqdist`` — streaming distance -> top-k over a leading group
dimension (the forest's window blocks of one tree are one launch): a
register-tiled f32 product, a threshold filter against each row's k-th
similarity, and a batched merge of the survivors (bitonic sort, then
merge-path ranks) into the running state.  It reads a and b in place,
as blocks or as a base matrix with row indices (``a_idx``, ``b_idx``).
``pairwise_sqdist`` — the blocked (M, N) squared-distance matrix.

The kernels sum the row norms |a|^2 and |b|^2 themselves, in the order
of ``ref.sq_norms``, and their dot products in feature order, as cuBLAS's
f32 GEMM does; the top-k selection is exact.  So on the card a kernel's
distances, and the top-k ids that follow from them, are bitwise its
plain version's.

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
# 128 x 128 output tile.
MAX_BLOCKS = 2**31 - 1
BM = 32
PT = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "topk_sqdist_launch": [_P] * 8 + [_I] + [_P] * 4 + [_I] * 7 + [_P],
    "pairwise_sqdist_launch": [_P] * 3 + [_I] * 3 + [_P],
}


def _check_blocks(what: str, blocks: int) -> None:
    if blocks > MAX_BLOCKS:
        raise ValueError(f"{what}: {blocks} thread blocks exceed one "
                         f"launch's limit of {MAX_BLOCKS}")


def _lib() -> ctypes.CDLL:
    return _build.load("knn_topk", _ARGTYPES)


def _on_card(*ts) -> torch.device:
    dev = ts[0].device
    for t in ts:
        if t is not None and (t.device.type != "cuda" or t.device != dev):
            raise ValueError("the CUDA kernels take tensors on one CUDA "
                             f"device, got {t.device} beside {dev}")
    return dev


def topk_sqdist(a, b, k: int, *, a_idx=None, b_idx=None, a_ids=None,
                b_ids=None, codes_a=None, codes_b=None, init_ids=None,
                init_dists=None, dedup: bool = False, bn: int | None = None):
    """Same contract as ``ref.topk_sqdist_ref``: a (M, d) or (G, M, d),
    b (N, d) or (G, N, d) -> (ids int32, sqdists f32) of shape
    (..., M, k), distances ascending.  With ``a_idx`` (M,) or (G, M)
    int32 ``a`` is a base matrix read in place at those rows (-1 a zero
    row), and likewise ``b_idx`` for ``b``.  ``bn`` is the column-tile
    width of the dedup semantics (the kernel's own tiles are internal)."""
    squeeze = (a[..., 0] if a_idx is None else a_idx).dim() == 1
    if squeeze:
        a_idx, b_idx, a_ids, b_ids, codes_a, codes_b, init_ids, \
            init_dists = (None if t is None else t[None] for t in (
                a_idx, b_idx, a_ids, b_ids, codes_a, codes_b, init_ids,
                init_dists))
        if a_idx is None:
            a = a[None]
        if b_idx is None:
            b = b[None]
    dev = _on_card(a, b, a_idx, b_idx, a_ids, b_ids, codes_a, codes_b,
                   init_ids, init_dists)
    G, M = a.shape[:2] if a_idx is None else a_idx.shape
    G2, N = b.shape[:2] if b_idx is None else b_idx.shape
    d = a.shape[-1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_sqdist: k={k} outside [1, {MAX_K}]")
    if a.dim() != (2 if a_idx is not None else 3) or \
            b.dim() != (2 if b_idx is not None else 3):
        raise ValueError("topk_sqdist: with row indices a and b are base "
                         "matrices (rows, d), else blocks (G, rows, d)")
    if d < 1 or G2 != G or b.shape[-1] != d:
        raise ValueError(f"topk_sqdist: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not pair")
    if (codes_a is None) != (codes_b is None) or \
            (init_ids is None) != (init_dists is None):
        raise ValueError("topk_sqdist: codes_a/codes_b and init_ids/"
                         "init_dists come in pairs")
    _check_blocks("topk_sqdist", G * -(-M // BM))
    bn = bn or ref.dedup_tile(N)

    def i32(t, shape):
        return None if t is None else \
            t.to(torch.int32).expand(shape).contiguous()

    a = a.float().contiguous()
    b = b.float().contiguous()
    a_idx, a_ids = i32(a_idx, (G, M)), i32(a_ids, (G, M))
    b_idx, b_ids = i32(b_idx, (G, N)), i32(b_ids, (G, N))
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
        p(a), p(a_idx), p(b), p(b_idx), p(a_ids), p(b_ids), p(codes_a),
        p(codes_b), T, p(init_ids), p(init_dists), p(out_ids), p(out_d), G,
        M, N, d, k, int(min(bn, max(N, 1))), int(bool(dedup)),
        _build.stream(dev))
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
    _check_blocks("pairwise_sqdist", -(-M // PT) * -(-N // PT))
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
