"""Launcher for the forward flash-attention kernel in
``csrc/flash_attention.cu``.

q (B, S, H, hd), k and v (B, T, H, hd) with the heads already broadcast
(GQA callers repeat the kv heads first); the causal mask is top-left
(``kpos <= qpos``), as the JAX package's Pallas kernel has it.  bf16
inputs go to the wgmma kernel (128 query rows by 128 key rows, read by
TMA), f32 inputs to the f32 FMA kernel (64 by 64); the tiles change no
result.  CUDA tensors only; the launcher counts its calls in
``flash_attention.launches``.  The plain version is
``ref.flash_attention_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64)   # reduced configs, tests, qwen1.5-0.5b
MAX_BH = 65535              # B * H rides on grid.y (f32)
MAX_LEN = 2**31 - 1         # S and T are C ints
BQ_BF16 = 128               # query rows of a bf16 block
MAX_BLOCKS = 2**31 - 1      # bf16: ceil(S / BQ_BF16) * B * H on grid.x

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 7 + [_F, _P]


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", {"flash_attention_launch": _ARGTYPES})


def flash_attention(q, k, v, *, causal: bool = True):
    """softmax(q k^T / sqrt(hd) + mask) v on the card, scores and
    accumulation in f32, the output in q's dtype (bf16 or f32)."""
    dev = q.device
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError("flash_attention: tensors on one CUDA device, "
                             f"got {t.device} beside {dev}")
        if t.dtype != q.dtype or t.dtype not in (torch.bfloat16,
                                                  torch.float32):
            raise ValueError("flash_attention: q, k and v all bf16 or all "
                             f"f32, got {q.dtype}, {k.dtype}, {v.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash_attention: q, k and v must be "
                             "contiguous")
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape) \
            or tuple(k.shape[::2]) != tuple(q.shape[::2]) \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} are not "
                         "(B, S, H, hd), (B, T, H, hd), (B, T, H, hd) with "
                         "the heads pre-broadcast")
    B, S, H, hd = q.shape
    T = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if not (1 <= S <= MAX_LEN and 1 <= T <= MAX_LEN):
        raise ValueError(f"flash_attention: sequence lengths S={S}, T={T} "
                         f"outside [1, {MAX_LEN}]")
    if not 1 <= B * H <= MAX_BH:
        raise ValueError(f"flash_attention: B*H = {B * H} outside the "
                         f"grid's limit [1, {MAX_BH}]")
    if q.dtype == torch.bfloat16:
        if -(-S // BQ_BF16) * B * H > MAX_BLOCKS:
            raise ValueError(f"flash_attention: ceil(S/{BQ_BF16})*B*H "
                             f"blocks above the grid's limit {MAX_BLOCKS}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention: bf16 q, k and v must be "
                             "16-byte aligned (TMA)")
    out = torch.empty_like(q)
    p = _build.ptr
    rc = _lib().flash_attention_launch(
        p(q), p(k), p(v), p(out), B, S, T, H, hd,
        int(q.dtype == torch.bfloat16), int(bool(causal)),
        1.0 / math.sqrt(hd), _build.stream(dev))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
