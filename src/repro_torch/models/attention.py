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
With a ``(data, model)`` mesh (``mesh=``) the prefill and decode run on
a rank's heads and its block of JAX's sharded cache layouts, and the
training forward (``attention_fwd``) on its heads under autograd; with
``mesh=None`` they run on one device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.launch.mesh import model_copy, model_sum
from repro_torch.models import costbook
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

def _gqa_scores_flops(B, Sq, Sk, H, hd):
    return 4.0 * B * H * Sq * Sk * hd  # qk^T + pv


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
    # JAX's entry: its blocks' trips, and q, k, v read and out written once
    costbook.record(
        "mha_chunked", total_flops=_gqa_scores_flops(B, Sq, Sk, H, hd),
        total_bytes=float((2 * q.numel() + k.numel() + v.numel())
                          * q.element_size()),
        trips=(Sq // min(Q_BLOCK, Sq)) * (Sk // min(KV_BLOCK, Sk)))
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


def _stored(k, v, kv_quant: bool) -> dict:
    """A cache entry's leaves of K and V: as they are, or int8 with their
    f32 scales."""
    if not kv_quant:
        return {"k": k, "v": v}
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _ring(t, window: int):
    """A prefill's K or V (B, S, ...) as a local layer's cache: the last W
    positions, rolled so that slot = position mod W, once S >= W."""
    S = t.shape[1]
    if not window or S < window:
        return t
    start = S - window
    return torch.roll(t[:, start:], start % window, dims=1)


# ---------------------------------------------------------------------------
# Block-level entry points
# ---------------------------------------------------------------------------

def _window_for(cfg, kind: str) -> int:
    return cfg.sliding_window if kind == "local" else 0


def attention_fwd(params, x, cfg, *, kind="attn", causal=True, impl="auto",
                  mesh=None):
    """Self-attention over a whole sequence, no cache (the
    encoder-decoder's encoder runs it non-causal, ``impl="full"``).
    x: (B,S,d) -> (B,S,d).

    On a rank of a ``(data, model)`` ``mesh`` (the training forward, the
    weights the rank's training blocks gathered over ``"data"``): the
    rank's query heads attend over the kv heads they read, its own where
    the kv heads shard over ``"model"``, picked by global index from the
    whole kv projection where they do not (:func:`attention_prefill`'s
    rule); the flash kernels run on those heads.  ``x``, and each weight
    every rank holds whole but uses only for its own heads (the whole
    ``wk``/``wv``/``bk``/``bv``, the QK-norm scales), take their
    gradients summed over ``"model"`` (``model_copy``); ``wo`` is
    row-parallel, followed by the ``"model"`` sum.  Query heads that do not
    divide the model axis stay whole on every rank (:func:`heads_whole`):
    every rank computes all heads as one device does, and the weights'
    gradients are whole on every rank, not summed over ``"model"``."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    M, m = _model_rank(mesh)
    window = _window_for(cfg, kind)
    if M == 1 or heads_whole(params, cfg):
        q, k, v = _project_qkv(params, x, cfg, positions,
                               _theta_for(cfg, kind))
        o = attend(q, k, v, causal=causal, window=window, impl=impl)
        return _out_proj(o, params["wo"])
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    check_mesh_heads(cfg, M)
    kv_local = params["wk"].shape[1] < KVH
    p = dict(params)
    for name in ("wk", "wv", "bk", "bv"):
        if name in p and not kv_local:
            p[name] = model_copy(mesh, p[name])
    for name in ("qnorm", "knorm"):
        if name in p:
            p[name] = {"scale": model_copy(mesh, p[name]["scale"])}
    q, k, v = _project_qkv(p, model_copy(mesh, x), cfg, positions,
                           _theta_for(cfg, kind))
    n_q = q.shape[2]
    if not kv_local:
        k = _kv_for_heads(k, m * n_q, n_q, H // KVH)
        v = _kv_for_heads(v, m * n_q, n_q, H // KVH)
    o = attend(q, k, v, causal=causal, window=window, impl=impl)
    return model_sum(mesh, _out_proj(o, params["wo"]))


def check_mesh_heads(cfg, model_axis: int) -> None:
    """The sharded attention splits the head dimension of a cache whose
    heads do not divide the model axis over ``"model"`` (JAX's
    ``_cache_pspec``): it must divide it (every attention architecture's
    does at ``model`` 16).  Query heads that do not divide stay whole on
    every rank (:func:`heads_whole`)."""
    hd = cfg.resolved_head_dim
    if hd % model_axis:
        raise ValueError(f"{cfg.name}: the head dimension {hd} does not "
                         f"divide over model={model_axis}")


def heads_whole(params, cfg) -> bool:
    """Whether a rank holds every query head (``wq`` whole): JAX's rule
    for ``attn/w[qkv]`` cuts the heads over ``"model"`` only where they
    divide it (``_guard``), else leaves ``wq``/``wk``/``wv``/``wo`` whole,
    and the attention is replicated: every rank computes all heads, and no
    ``"model"`` collective runs (whisper-tiny's 6 heads and phi3-medium's
    40 at ``model`` 16)."""
    return params["wq"].shape[1] == cfg.n_heads


def _model_rank(mesh):
    """(size of ``"model"``, the rank's index on it); (1, 0) without a
    mesh."""
    if mesh is None:
        return 1, 0
    return mesh.shape["model"], mesh.axis_index("model")


def _kv_for_heads(k, q_lo: int, n_q: int, group: int):
    """The kv heads of the query heads ``[q_lo, q_lo + n_q)`` (query head
    h reads kv head h // group): a slice of whole groups, else one kv head
    a query head (phi3's 10 kv heads at model 4 split groups)."""
    if n_q % group == 0 and q_lo % group == 0:
        return k[:, :, q_lo // group:(q_lo + n_q) // group]
    idx = torch.arange(q_lo, q_lo + n_q, device=k.device) // group
    return k[:, :, idx]


def _seq_block(mesh, T_glob: int):
    """(first position, length) of the rank's block of a cache sequence of
    ``T_glob`` slots sharded over ``"data"`` (SP), or the whole sequence
    when it does not divide."""
    D = mesh.shape["data"]
    if T_glob % D or T_glob < D:
        return 0, T_glob
    T = T_glob // D
    return mesh.axis_index("data") * T, T


def attention_prefill(params, x, cfg, *, kind="attn", impl="auto",
                      kv_repeat: int = 1, kv_quant: bool = False, mesh=None,
                      seq_parallel: bool = False):
    """Prefill: returns (out, cache_entry) — the cache holds the roped K
    and V, (B, S, KVH * kv_repeat, hd), int8 with f32 ``k_scale`` and
    ``v_scale`` (B, S, KVH * kv_repeat, 1) under ``kv_quant``.  A local
    layer with S >= W keeps the last W positions as a ring buffer, rolled
    so that slot = position mod W.

    On a rank of a ``(data, model)`` ``mesh``, x is the rank's rows (all
    rows under ``seq_parallel``) and the weights its blocks.  The rank
    attends with its query heads and the kv heads they read (its own where
    the kv heads shard over ``"model"``, picked by global index from the
    whole kv projection where they do not); the flash kernel runs on those
    heads past 2048 tokens.  ``wo`` is row-parallel, followed by the
    ``"model"`` sum.  The cache entry is the rank's block of JAX's leaf
    (``sharding._cache_pspec``): its heads, or its slice of the head
    dimension when the cache heads do not divide the model axis; under
    ``seq_parallel`` its block of the sequence over ``"data"``; int8
    values are quantized over the whole head dimension first, as JAX's,
    and their scales cut by heads only."""
    S = x.shape[1]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    M, m = _model_rank(mesh)
    check_mesh_heads(cfg, M)
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions, _theta_for(cfg, kind))
    n_q = q.shape[2]
    q_lo = m * n_q if n_q < H else 0
    kv_local = k.shape[2] < KVH
    if kv_local or n_q == H:
        ka, va = k, v
    else:
        ka = _kv_for_heads(k, q_lo, n_q, H // KVH)
        va = _kv_for_heads(v, q_lo, n_q, H // KVH)
    window = _window_for(cfg, kind)
    o = attend(q, ka, va, causal=True, window=window, impl=impl)
    out = _out_proj(o, params["wo"])
    if params["wo"].shape[0] < H:
        out = model_sum(mesh, out)
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=2)
        v = v.repeat_interleave(kv_repeat, dim=2)
    k, v = _ring(k, window), _ring(v, window)
    kvh_c = KVH * kv_repeat
    heads = kvh_c % M == 0
    if heads and not kv_local and M > 1:
        b = kvh_c // M
        k, v = k[:, :, m * b:(m + 1) * b], v[:, :, m * b:(m + 1) * b]
    if seq_parallel:
        t0, T = _seq_block(mesh, k.shape[1])
        k, v = k[:, t0:t0 + T], v[:, t0:t0 + T]
    entry = _stored(k, v, kv_quant)
    if not heads:
        b = hd // M
        for name in ("k", "v"):
            entry[name] = entry[name][..., m * b:(m + 1) * b].contiguous()
    return out, entry


def attention_decode(params, x, cfg, cache, position, *, kind="attn",
                     mesh=None, sp_len=None):
    """One-token decode.  x: (B,1,d); cache k/v: (B,T,KVH*r,hd); position:
    (B,) index of the NEW token.  The replication factor r and int8
    storage (``k_scale`` in the cache) are inferred from the cache.  A
    local layer whose cache holds exactly its window's W slots is a ring
    buffer (slot = position mod W), as in the JAX package.  Writes the new
    K and V (quantized under int8) into the cache in place (the JAX
    package returns an updated copy) and returns (out, cache).  In a
    position-indexed cache a position at or past T writes nothing, as
    JAX's out-of-range scatter drops the update; the engine's retired
    slots decode there.

    On a rank of a ``(data, model)`` ``mesh`` the cache is the rank's
    block of JAX's layout, read off the block: a head dimension shorter
    than the config's is the hd-over-``"model"`` cache (then the cache
    holds every kv head), otherwise the cache holds the rank's heads.  The
    new token's K/V, repeated as the cache's heads are, go into the rank's
    heads or its hd slice.  With heads, the rank's query heads attend over
    them as on one device.  With hd slices, the query heads are gathered
    over ``"model"``, each rank scores every head on its slice, the
    partial scores are summed over ``"model"`` in rank order, and the
    rank's slice of every head's output is gathered back before its own
    heads take ``wo`` (row-parallel, then the ``"model"`` sum).

    ``sp_len`` (the global length of a position-indexed cache) marks a
    sequence-parallel decode: every rank holds all rows, and each
    attention leaf whose slots (``sp_len``, or the window W of a local
    layer's ring) divide over ``"data"`` holds the rank's block of them.
    The new token is written by the rank that owns its slot; each rank
    attends over its block and the partial (max, sum, out) are combined
    across ``"data"`` in rank order, the flash-decoding combine XLA
    inserts for JAX."""
    B = x.shape[0]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    M, m = _model_rank(mesh)
    check_mesh_heads(cfg, M)
    q, k, v = _project_qkv(params, x, cfg, position[:, None],
                           _theta_for(cfg, kind))
    n_q = q.shape[2]
    q_lo = m * n_q if n_q < H else 0
    c_h, c_d = cache["k"].shape[2], cache["k"].shape[3]
    hd_split = c_d < hd
    kvh_c = c_h if hd_split else c_h * M
    rep = kvh_c // KVH
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if not hd_split and k.shape[2] > c_h:        # whole kv: the rank's
        k, v = k[:, :, m * c_h:(m + 1) * c_h], v[:, :, m * c_h:(m + 1) * c_h]
    quant = "k_scale" in cache
    new = _stored(k, v, quant)
    if hd_split:
        for name in ("k", "v"):
            new[name] = new[name][..., m * c_d:(m + 1) * c_d]

    # the rank's slots of the sequence, and where the new token goes
    T = cache["k"].shape[1]
    window = _window_for(cfg, kind)
    if sp_len is None:
        T_glob, t0 = T, 0
    else:
        T_glob = window if window and sp_len >= window else sp_len
        t0, T_blk = _seq_block(mesh, T_glob)
        if T_blk != T:
            raise ValueError(f"attention_decode: a cache block of {T} "
                             f"slots, expected {T_blk} of {T_glob}")
    sp = T < T_glob
    ring = bool(window) and T_glob == window
    slot = position % window if ring else position
    at = slot - t0
    bidx = torch.arange(B, device=x.device)
    inside = ((at >= 0) & (at < T))[:, None, None]
    at = at.clamp(0, T - 1)
    for name, t in new.items():
        c = cache[name]
        c[bidx, at] = torch.where(inside, t[:, 0], c[bidx, at])
    if quant:
        ck = dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        cv = dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        ck, cv = cache["k"], cache["v"]

    if hd_split:
        qa = mesh.all_gather(q, "model", dim=2) if n_q < H else q
        G = H // kvh_c
        qg = qa[..., m * c_d:(m + 1) * c_d].reshape(B, kvh_c, G, c_d)
        s = torch.einsum("bhgk,bthk->bhgt", qg.float(), ck.float())
        s = mesh.all_reduce_sum(s, "model") / math.sqrt(hd)
    else:
        G = n_q // c_h
        qg = q.reshape(B, c_h, G, hd)
        s = torch.einsum("bhgk,bthk->bhgt", qg.float(), ck.float()) / \
            math.sqrt(hd)
    # validity: a position-indexed slot at or before the position; a ring
    # slot whose reconstructed position is >= 0
    tpos = t0 + torch.arange(T, device=x.device)[None, :]
    if ring:
        recon = position[:, None] - ((position[:, None] - tpos) % window)
        valid = recon >= 0
    else:
        valid = tpos <= position[:, None]
    valid = valid[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    if sp:
        mx = s.amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - mx), 0.0)
        part = torch.cat([mx, p.sum(-1, keepdim=True),
                          torch.einsum("bhgt,bthk->bhgk", p, cv.float())],
                         dim=-1)
        parts = mesh.all_gather_list(part, "data")
        top = parts[0][..., :1]
        for pt in parts[1:]:
            top = torch.maximum(top, pt[..., :1])
        acc = None
        for pt in parts:                       # in rank order
            w = torch.exp(pt[..., :1] - top)
            term = pt[..., 1:] * w
            acc = term if acc is None else acc + term
        o = (acc[..., 1:] / acc[..., :1]).to(x.dtype)
    else:
        p = torch.softmax(s, dim=-1).to(x.dtype)
        o = torch.einsum("bhgt,bthk->bhgk", p, cv)
    if hd_split:
        o = mesh.all_gather(o, "model", dim=-1).reshape(B, H, hd)
        o = o[:, q_lo:q_lo + n_q]
    out = _out_proj(o.reshape(B, 1, n_q, hd), params["wo"])
    if params["wo"].shape[0] < H:
        out = mesh.all_reduce_sum(out, "model")
    return out, cache


def attention_flops(cfg, B, Sq, Sk, *, train: bool) -> float:
    """JAX's analytic flops of an attention layer: the q, k, v and out
    products and the scores (three times that for a training step)."""
    hd = cfg.resolved_head_dim
    proj = 2.0 * B * Sq * cfg.d_model * hd * (2 * cfg.n_heads +
                                              2 * cfg.n_kv_heads)
    core = _gqa_scores_flops(B, Sq, Sk, cfg.n_heads, hd)
    total = proj + core
    return total * (3.0 if train else 1.0)
