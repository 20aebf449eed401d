"""Launchers for the flash-attention kernels: the forward in
``csrc/flash_attention.cu`` and the backward in
``csrc/flash_attention_bwd.cu``.

q (B, S, H, hd), k and v (B, T, H, hd) with the heads already broadcast
(GQA callers repeat the kv heads first); the causal mask is top-left
(``kpos <= qpos``), as the JAX package's Pallas kernel has it, and a
``window`` W > 0 keeps only the keys with ``qpos - W < kpos``, the JAX
package's sliding-window mask.  bf16 inputs go to the wgmma kernel (128
query rows by key tiles of 128 rows at hd <= 64 and 64 at hd 128 and 256,
read by TMA), f32 inputs to the f32 FMA kernel (64 by 64); the tiles
change no result.  With ``return_lse`` the forward also writes each
row's log-sum-exp (B, H, S) f32, the backward's input; without it (every
serving call) it writes none.  :func:`flash_attention_bwd` takes the
forward's contract and returns (dq, dk, dv): under bf16 a delta kernel
and one pass on wgmma (a block a key tile, dq added across key tiles in a
fixed order), under f32 a delta kernel and two FMA kernels.  CUDA tensors
only; each launcher counts its calls in ``<launcher>.launches``.  The
plain versions are ``ref.flash_attention_ref``,
``ref.flash_attention_fwd_ref`` and ``ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128, 256)   # reduced configs .. gemma3
MAX_BH = 65535              # B * H rides on grid.y (f32)
MAX_LEN = 2**31 - 1         # S and T are C ints
BQ_BF16 = 128               # query rows of a bf16 block
MAX_BLOCKS = 2**31 - 1      # bf16: ceil(S / BQ_BF16) * B * H on grid.x
BQ_BWD = 64                 # query rows of a tile of the bf16 backward
MAX_INT = 2**31 - 1         # bf16 backward: B * H * S padded, as C ints

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 5 + [_I] * 8 + [_F, _P]
_BWD_ARGTYPES = [_P] * 12 + [_I] * 8 + [_F, _P]


def pairs(S: int, T: int, *, causal: bool = True, window: int = 0) -> int:
    """(query, key) pairs under the mask of S query rows and T keys, each
    at its index (top-left causal: row i sees keys 0..i, and with a
    window W > 0 the last W of those)."""
    if not causal:
        return S * T
    L = min(T, window) if window > 0 else T
    if S <= L:
        return S * (S + 1) // 2
    return L * (L + 1) // 2 + (S - L) * L


def work(q, k, *, causal: bool, window: int, backward: bool = False):
    """(operations, bytes) of one forward (``backward``: one backward)
    call: 2 hd operations a product a pair under the mask, two products
    forward and five backward; q, k, v and out (and dout, dq, dk, dv and
    the lse backward) read or written once."""
    B, S, H, hd = q.shape
    n = pairs(S, k.shape[1], causal=causal, window=window)
    size = q.element_size()
    if backward:
        return (10.0 * B * H * n * hd,
                float(4 * q.numel() + 4 * k.numel()) * size + B * H * S * 4)
    return 4.0 * B * H * n * hd, float(2 * q.numel() + 2 * k.numel()) * size


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", {"flash_attention_launch": _ARGTYPES})


def _lib_bwd() -> ctypes.CDLL:
    return _build.load("flash_attention_bwd",
                       {"flash_attention_bwd_launch": _BWD_ARGTYPES})


def _check(what: str, q, k, v, *more, causal: bool, window: int) -> int:
    """The contract both kernels take: one CUDA device, one dtype (bf16 or
    f32), contiguous, (B, S, H, hd) and (B, T, H, hd) with the heads
    pre-broadcast (``more`` shaped as q), hd in HEAD_DIMS, B * H within
    grid.y; returns the window."""
    dev = q.device
    for t in (q, k, v) + more:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: tensors on one CUDA device, "
                             f"got {t.device} beside {dev}")
        if t.dtype != q.dtype or t.dtype not in (torch.bfloat16,
                                                  torch.float32):
            raise ValueError(f"{what}: q, k and v all bf16 or all "
                             f"f32, got {q.dtype}, {k.dtype}, {v.dtype}"
                             + "".join(f", {t.dtype}" for t in more))
        if not t.is_contiguous():
            raise ValueError(f"{what}: q, k and v must be contiguous")
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape) \
            or tuple(k.shape[::2]) != tuple(q.shape[::2]) \
            or k.shape[3] != q.shape[3] \
            or any(tuple(t.shape) != tuple(q.shape) for t in more):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} are not "
                         "(B, S, H, hd), (B, T, H, hd), (B, T, H, hd) with "
                         "the heads pre-broadcast")
    B, S, H, hd = q.shape
    T = k.shape[1]
    window = ref.check_window(S, T, causal, window)
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {hd} not in {HEAD_DIMS}")
    if not (1 <= S <= MAX_LEN and 1 <= T <= MAX_LEN):
        raise ValueError(f"{what}: sequence lengths S={S}, T={T} "
                         f"outside [1, {MAX_LEN}]")
    if not 1 <= B * H <= MAX_BH:
        raise ValueError(f"{what}: B*H = {B * H} outside the "
                         f"grid's limit [1, {MAX_BH}]")
    return window


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """softmax(q k^T / sqrt(hd) + mask) v on the card, scores and
    accumulation in f32, the output in q's dtype (bf16 or f32).  With
    ``return_lse``, (out, lse) with lse (B, H, S) f32, each row's
    ``m + log(l)`` of its scaled scores."""
    window = _check("flash_attention", q, k, v, causal=causal, window=window)
    B, S, H, hd = q.shape
    T = k.shape[1]
    if q.dtype == torch.bfloat16:
        if -(-S // BQ_BF16) * B * H > MAX_BLOCKS:
            raise ValueError(f"flash_attention: ceil(S/{BQ_BF16})*B*H "
                             f"blocks above the grid's limit {MAX_BLOCKS}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention: bf16 q, k and v must be "
                             "16-byte aligned (TMA)")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    p = _build.ptr
    rc = _lib().flash_attention_launch(
        p(q), p(k), p(v), p(out), p(lse), B, S, T, H, hd,
        int(q.dtype == torch.bfloat16), int(bool(causal)), window,
        1.0 / math.sqrt(hd), _build.stream(q.device))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of ``flash_attention`` on the card, in q's dtype: the
    forward's ``out`` and ``lse`` and the incoming ``dout`` (shaped as
    q) in; no atomic adds on the gradients, so two calls give the same
    bits.

    bf16 launches a delta kernel and one pass on wgmma, one block a key
    tile.  Its scratch, with the rows padded to S64 = ceil(S / 64) * 64:
    lse log2(e) and delta (2, B, H, S64) f32, written by the delta kernel;
    a dq accumulator (B, H, S64, hd) f32, into which the key tiles that
    see a query tile of 64 rows add their partials in ascending order (the
    first writes, the last rounds the sum into dq); and B * H * S64 / 64
    counters that admit them in that order, plus the work counter of the
    persistent grid, all zeroed by the delta kernel.  f32 launches a delta
    kernel and two FMA kernels (dk and dv by key tiles, dq by query
    tiles)."""
    window = _check("flash_attention_bwd", q, k, v, out, dout,
                    causal=causal, window=window)
    B, S, H, hd = q.shape
    T = k.shape[1]
    if lse.device != q.device or lse.dtype != torch.float32 \
            or tuple(lse.shape) != (B, H, S) or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be (B, H, S) = "
                         f"{(B, H, S)} f32, contiguous on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("flash_attention_bwd: q, k, v, out and dout must "
                         "be 16-byte aligned (TMA and vector loads)")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    f32 = dict(dtype=torch.float32, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        s64 = -(-S // BQ_BWD) * BQ_BWD
        if B * H * s64 > MAX_INT:
            raise ValueError(f"flash_attention_bwd: B*H*S = {B * H * S} "
                             f"(rows padded to {BQ_BWD}) above {MAX_INT}")
        delta = torch.empty((2, B, H, s64), **f32)    # lse log2(e), delta
        acc = torch.empty((B, H, s64, hd), **f32)
        counters = torch.empty(B * H * s64 // BQ_BWD + 1, dtype=torch.int32,
                               device=q.device)
    else:
        delta = torch.empty((B, H, S), **f32)
        acc = counters = None
    p = _build.ptr
    rc = _lib_bwd().flash_attention_bwd_launch(
        p(q), p(k), p(v), p(out), p(dout), p(lse), p(delta), p(dq), p(dk),
        p(dv), p(acc), p(counters), B, S, T, H, hd, int(bf16),
        int(bool(causal)), window, 1.0 / math.sqrt(hd),
        _build.stream(q.device))
    _build.check(rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
