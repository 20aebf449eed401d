"""Attention: GQA, RoPE, QK-norm, KV cache — the JAX package's
``models/attention.py`` for the global (full-length) cache.

Two prefill paths, chosen by ``attend`` with the JAX package's rule:
  * ``full``    — one einsum + masked softmax (short prompts);
  * ``chunked`` — the forward flash kernel, ``ops.flash_attention``: the
                  hand-written CUDA kernel on the card, its plain version
                  on the CPU.  In the JAX package this path is the
                  ``lax.scan`` flash algorithm, for which its Pallas
                  kernel is the drop-in.
Decode is one new token against the filled cache, a plain softmax as in
the JAX package.

Not ported yet (each raises, ROADMAP Queue 1): sliding-window and
local:global attention (the ring-buffer cache, and a window in the flash
kernel, which the Pallas kernel lacks too), KV-head replication
(``kv_repeat``), int8 KV caches (``kv_quant``), and the chunked path's
backward (training).
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
_TODO = "not ported yet (ROADMAP Queue 1)"


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


def mha_chunked(q, k, v, *, causal=True, window=0):
    """The flash path: ``ops.flash_attention`` on kv heads broadcast to
    the query heads (query head h reads kv head h // G, so
    ``repeat_interleave``).  q: (B,Sq,H,hd); k/v: (B,Sk,KVH,hd).

    The kernel's causal mask is top-left: the rows sit at positions
    0..Sq-1 and 0..Sk-1, as every prefill's do, so it takes no positions.
    The JAX package's shape contract holds: Sq a multiple of min(2048, Sq)
    and Sk of min(1024, Sk).  Forward only."""
    if window > 0:
        raise NotImplementedError(
            f"mha_chunked: sliding window {window} {_TODO}; the flash "
            "kernel, like the Pallas one, has no window")
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
    return ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal)


def attend(q, k, v, *, causal=True, window=0, impl="auto"):
    """Prefill attention, the query and key rows at positions 0..Sq-1 and
    0..Sk-1; ``impl`` picks the path with the JAX package's rule."""
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
# Block-level entry points
# ---------------------------------------------------------------------------

def _check_kind(cfg, kind: str) -> None:
    if kind == "local" and cfg.sliding_window:
        raise NotImplementedError(f"sliding-window attention {_TODO}")


def attention_prefill(params, x, cfg, *, kind="attn", impl="auto",
                      kv_repeat: int = 1, kv_quant: bool = False):
    """Prefill: returns (out, cache_entry) — the cache holds the roped K
    and V, (B, S, KVH, hd)."""
    if kv_repeat > 1 or kv_quant:
        raise NotImplementedError(f"kv_repeat and kv_quant {_TODO}")
    _check_kind(cfg, kind)
    positions = torch.arange(x.shape[1], device=x.device)
    theta = _theta_for(cfg, kind)
    q, k, v = _project_qkv(params, x, cfg, positions, theta)
    o = attend(q, k, v, causal=True, impl=impl)
    return _out_proj(o, params["wo"]), {"k": k, "v": v}


def attention_decode(params, x, cfg, cache, position, *, kind="attn"):
    """One-token decode.  x: (B,1,d); cache k/v: (B,T,KVH,hd); position:
    (B,) index of the NEW token.  Writes the new K and V into the cache in
    place (the JAX package returns an updated copy) and returns
    (out, cache).  A position at or past T writes nothing, as JAX's
    out-of-range scatter drops the update; the engine's retired slots
    decode there."""
    _check_kind(cfg, kind)
    B = x.shape[0]
    theta = _theta_for(cfg, kind)
    q, k, v = _project_qkv(params, x, cfg, position[:, None], theta)
    ck, cv = cache["k"], cache["v"]
    T, KVH, hd = ck.shape[1], ck.shape[2], ck.shape[3]
    if KVH != cfg.n_kv_heads:
        raise NotImplementedError(f"a replicated KV cache {_TODO}")
    bidx = torch.arange(B, device=x.device)
    slot = position.clamp(0, T - 1)
    inside = (position < T)[:, None, None]
    ck[bidx, slot] = torch.where(inside, k[:, 0], ck[bidx, slot])
    cv[bidx, slot] = torch.where(inside, v[:, 0], cv[bidx, slot])

    H = q.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, hd)
    s = torch.einsum("bhgk,bthk->bhgt", qg.float(), ck.float()) / \
        math.sqrt(hd)
    valid = torch.arange(T, device=x.device)[None, :] <= position[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bhgt,bthk->bhgk", p, cv).reshape(B, 1, H, hd)
    return _out_proj(o, params["wo"]), cache
