"""Attention: GQA, RoPE, sliding-window / local:global, QK-norm, KV cache
— the JAX package's ``models/attention.py`` for serving.

Two paths for a whole sequence (prefill and the training forward),
chosen by ``attend`` with the JAX package's rule:
  * ``full``    — one einsum + masked softmax (short sequences); autograd
                  differentiates it as it stands;
  * ``chunked`` — the flash kernels, through ``ops``: the hand-written
                  CUDA kernels on the card, their plain versions on the
                  CPU, with the sliding window in the kernels.  In the JAX
                  package this path is the ``lax.scan`` flash algorithm
                  with its flash ``custom_vjp`` (its Pallas kernel is the
                  forward's drop-in for the unwindowed case).  Under
                  autograd it is :class:`FlashAttention`: the forward
                  kernel also writes the rows' log-sum-exp, and the
                  backward kernel recomputes the scores from it; without
                  gradients (every serving call) the forward writes none.
Decode is one new token against the filled cache, a plain softmax as in
the JAX package: a global layer's cache is indexed by position, a local
layer's by position mod W when it holds the window's W slots (the ring
buffer ``attention_prefill`` leaves behind).  KV heads may be replicated
(``kv_repeat``) and the cache stored in int8 with per-(token, head)
scales (``kv_quant``); decode infers both from the cache it is given.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense_init,
                                       init_rmsnorm, rmsnorm)

NEG_INF = -1e30
# mha_chunked's blocks in the JAX package: its shape contract (results
# do not depend on them; the flash kernel has its own tiles)
Q_BLOCK, KV_BLOCK = 2048, 1024


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_attention(generator, cfg) -> dict:
    hd = cfg.resolved_head_dim
    dev = generator.device
    p = {
        "wq": dense_init(generator, (cfg.d_model, cfg.n_heads, hd)),
        "wk": dense_init(generator, (cfg.d_model, cfg.n_kv_heads, hd)),
        "wv": dense_init(generator, (cfg.d_model, cfg.n_kv_heads, hd)),
        "wo": dense_init(generator, (cfg.n_heads, hd, cfg.d_model),
                         scale=1.0 / math.sqrt(cfg.n_heads * hd)),
    }
    if cfg.attn_bias:
        for name, heads in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((heads, hd), dtype=torch.float32,
                                  device=dev)
    if cfg.qk_norm:
        p["qnorm"] = init_rmsnorm(hd, dev)
        p["knorm"] = init_rmsnorm(hd, dev)
    return p


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(params, x, cfg, positions, theta: float):
    dtype = x.dtype
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.attn_bias:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    if cfg.qk_norm:
        q = rmsnorm(params["qnorm"], q, cfg.norm_eps)
        k = rmsnorm(params["knorm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v


def _out_proj(o, wo):
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = wo.shape
    return o.flatten(-2) @ wo.to(o.dtype).reshape(h * k, d)


def _theta_for(cfg, kind: str) -> float:
    # gemma3: local layers use the short-range 10k base, globals the long base
    if kind == "local" and cfg.rope_theta > 10_000.0 and \
            len(set(cfg.block_pattern)) > 1:
        return 10_000.0
    return cfg.rope_theta


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """(q, k) additive bias; window>0 limits lookback (sliding window)."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= dk <= dq
    if window > 0:
        ok &= dk > dq - window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


# ---------------------------------------------------------------------------
# Core attention (full / chunked)
# ---------------------------------------------------------------------------

def mha_full(q, k, v, q_pos, k_pos, *, causal=True, window=0):
    """q: (B,Sq,H,hd); k/v: (B,Sk,KVH,hd). Returns (B,Sq,H,hd).

    Scores in f32 (the f32 product of upcast inputs is the f32 sum of
    their exact products, as JAX's ``preferred_element_type``), the
    probabilities cast to q's dtype before P.V, as in the JAX package."""
    B, Sq, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    s = s / math.sqrt(hd) + _mask_bias(q_pos, k_pos, causal, window)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(B, Sq, H, hd)


class FlashAttention(torch.autograd.Function):
    """The flash path under autograd (the JAX package's
    ``_mha_chunked_core`` custom VJP): the forward saves q, k, v, out and
    the rows' log-sum-exp; the backward is ``ops.flash_attention_bwd``, the
    backward kernel on the card.  q (B, S, H, hd), k and v (B, T, H, hd)
    with the heads broadcast."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ops.flash_attention_bwd(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def mha_chunked(q, k, v, *, causal=True, window=0):
    """The flash path: the flash kernels on kv heads broadcast to the
    query heads (query head h reads kv head h // G, so
    ``repeat_interleave``, outside the kernels: autograd sums the G query
    heads' dk and dv into their kv head).  q: (B,Sq,H,hd); k/v:
    (B,Sk,KVH,hd).

    The kernel's causal mask is top-left: the rows sit at positions
    0..Sq-1 and 0..Sk-1, as every prefill's do, so it takes no positions;
    ``window`` > 0 (with ``causal``) is the sliding window, in the kernel.
    The JAX package's shape contract holds: Sq a multiple of min(2048, Sq)
    and Sk of min(1024, Sk).  With gradients on and an input that takes
    them, :class:`FlashAttention`; otherwise ``ops.flash_attention``
    alone (no log-sum-exp written)."""
    B, Sq, H, hd = q.shape
    KVH, Sk = k.shape[2], k.shape[1]
    if Sq % min(Q_BLOCK, Sq) or Sk % min(KV_BLOCK, Sk):
        raise ValueError(f"mha_chunked: Sq={Sq} must be a multiple of "
                         f"min({Q_BLOCK}, Sq) and Sk={Sk} of "
                         f"min({KV_BLOCK}, Sk)")
    G = H // KVH
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, int(window))
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def attend(q, k, v, *, causal=True, window=0, impl="auto"):
    """Attention over a whole sequence (prefill or the training forward),
    the query and key rows at positions 0..Sq-1 and 0..Sk-1; ``impl``
    picks the path with the JAX package's rule."""
    Sq, Sk = q.shape[1], k.shape[1]
    if impl == "auto":
        impl = "chunked" if Sq * Sk > (1 << 22) and Sq >= 2048 else "full"
    if impl == "full":
        return mha_full(q, k, v, torch.arange(Sq, device=q.device),
                        torch.arange(Sk, device=k.device), causal=causal,
                        window=window)
    if impl == "chunked":
        return mha_chunked(q, k, v, causal=causal, window=window)
    raise ValueError(f"attend: impl {impl!r}, expected auto|full|chunked")


# ---------------------------------------------------------------------------
# KV-cache storage: head replication and int8
# ---------------------------------------------------------------------------

def kv_tp_repeat(cfg, model_axis: int) -> int:
    """KV-head replication factor for a tensor-parallel degree
    ``model_axis``: pad the KV heads to it when the group structure
    allows, so a head-sharded decode cache splits evenly; 1 when not
    applicable (e.g. phi3's kv=10)."""
    kvh, h = cfg.n_kv_heads, cfg.n_heads
    if model_axis % kvh != 0:
        return 1
    r = model_axis // kvh
    if r <= 1 or (kvh * r) > h or h % (kvh * r) != 0:
        return 1
    return r


def quantize_kv(t):
    """Per-(token, head) symmetric int8 quantization.  t: (B,T,KVH,hd) ->
    (int8 values, f32 scales (B,T,KVH,1)); ``round`` is half to even, and
    every division has a tensor numerator, as in the JAX package."""
    tf = t.float()
    scale = tf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-8)
    q = torch.round(tf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale).to(dtype)


# ---------------------------------------------------------------------------
# Block-level entry points
# ---------------------------------------------------------------------------

def _window_for(cfg, kind: str) -> int:
    return cfg.sliding_window if kind == "local" else 0


def attention_fwd(params, x, cfg, *, kind="attn", causal=True, impl="auto"):
    """Self-attention over a whole sequence, no cache (the
    encoder-decoder's encoder runs it non-causal, ``impl="full"``).
    x: (B,S,d) -> (B,S,d)."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions, _theta_for(cfg, kind))
    o = attend(q, k, v, causal=causal, window=_window_for(cfg, kind),
               impl=impl)
    return _out_proj(o, params["wo"])


def attention_prefill(params, x, cfg, *, kind="attn", impl="auto",
                      kv_repeat: int = 1, kv_quant: bool = False):
    """Prefill: returns (out, cache_entry) — the cache holds the roped K
    and V, (B, S, KVH * kv_repeat, hd), int8 with f32 ``k_scale`` and
    ``v_scale`` (B, S, KVH * kv_repeat, 1) under ``kv_quant``.  A local
    layer with S >= W keeps the last W positions as a ring buffer, rolled
    so that slot = position mod W."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    theta = _theta_for(cfg, kind)
    q, k, v = _project_qkv(params, x, cfg, positions, theta)
    window = _window_for(cfg, kind)
    o = attend(q, k, v, causal=True, window=window, impl=impl)
    out = _out_proj(o, params["wo"])
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=2)
        v = v.repeat_interleave(kv_repeat, dim=2)
    if window and S >= window:
        start = S - window
        shift = start % window
        k = torch.roll(k[:, start:], shift, dims=1)
        v = torch.roll(v[:, start:], shift, dims=1)
    if kv_quant:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return out, {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return out, {"k": k, "v": v}


def attention_decode(params, x, cfg, cache, position, *, kind="attn"):
    """One-token decode.  x: (B,1,d); cache k/v: (B,T,KVH*r,hd); position:
    (B,) index of the NEW token.  The replication factor r and int8
    storage (``k_scale`` in the cache) are inferred from the cache.  A
    local layer whose cache holds exactly its window's W slots is a ring
    buffer (slot = position mod W), as in the JAX package.  Writes the new
    K and V (quantized under int8) into the cache in place (the JAX
    package returns an updated copy) and returns (out, cache).  In a
    position-indexed cache a position at or past T writes nothing, as
    JAX's out-of-range scatter drops the update; the engine's retired
    slots decode there."""
    B = x.shape[0]
    theta = _theta_for(cfg, kind)
    q, k, v = _project_qkv(params, x, cfg, position[:, None], theta)
    T = cache["k"].shape[1]
    rep = cache["k"].shape[2] // cfg.n_kv_heads
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    window = _window_for(cfg, kind)
    ring = bool(window) and T == window
    slot = position % window if ring else position
    quant = "k_scale" in cache
    if quant:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    bidx = torch.arange(B, device=x.device)
    at = slot.clamp(0, T - 1)
    inside = (slot < T)[:, None, None]
    for name, t in new.items():
        c = cache[name]
        c[bidx, at] = torch.where(inside, t[:, 0], c[bidx, at])
    if quant:
        ck = dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        cv = dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        ck, cv = cache["k"], cache["v"]

    KVH, hd = ck.shape[2], ck.shape[3]
    H = q.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, hd)
    s = torch.einsum("bhgk,bthk->bhgt", qg.float(), ck.float()) / \
        math.sqrt(hd)
    # validity: a position-indexed slot at or before the position; a ring
    # slot whose reconstructed position is >= 0
    tpos = torch.arange(T, device=x.device)[None, :]
    if ring:
        recon = position[:, None] - ((position[:, None] - tpos) % window)
        valid = recon >= 0
    else:
        valid = tpos <= position[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bhgt,bthk->bhgk", p, cv).reshape(B, 1, H, hd)
    return _out_proj(o, params["wo"]), cache
