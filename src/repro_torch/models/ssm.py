"""Mamba (S6) selective state-space layer — the JAX package's
``models/ssm.py``.  Training differentiates ``mamba_fwd`` with autograd as
it stands (the doubling scan's ``cat`` and products save their inputs;
nothing here writes in place into a saved tensor).

Diagonal linear recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t with
input-dependent (selective) dt/B/C, run as a chunked scan: within a chunk
a log-depth scan of the combine (a1 a2, a2 b1 + b2) in torch ops, the
chunks chained with the f32 state carried.  The JAX package scans a chunk
with ``lax.associative_scan``, whose odd/even recursion multiplies in
another order, so the two agree within f32 rounding, not bitwise.  Decode
is one token's state update against the cache.

The chunk contract: a sequence longer than ``CHUNK`` tokens must be a
multiple of it (the JAX package's reshape refuses the rest);
:func:`check_chunks` raises.  The conv tail that prefill keeps for decode
is the last K-1 raw inputs, left-padded with zeros below K-1 tokens: the
context ``_causal_conv`` assumes without ``prev`` (the JAX package keeps
fewer rows there, ROADMAP Queue 3).

No Pallas kernel sits behind this layer; the JAX package computes it in
jnp.  ``mamba_flops`` and its cost-book record wait for
``models/costbook.py`` (ROADMAP Queue 1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, softplus

CHUNK = 256


def check_chunks(S: int, chunk: int = CHUNK) -> None:
    """Raise unless a sequence of ``S`` tokens fits the chunked scan:
    ``S <= chunk`` or a multiple of it."""
    if S > chunk and S % chunk:
        raise ValueError(
            f"mamba: a sequence of {S} tokens; the chunked scan takes at "
            f"most {chunk} tokens or a multiple of {chunk} (the JAX "
            "package's chunk contract)")


def init_mamba(generator, cfg) -> dict:
    d = cfg.d_model
    inner = d * cfg.ssm_expand
    state = cfg.ssm_state
    dt_rank = max(8, math.ceil(d / 16))
    dev = generator.device
    # S4-style A init: -(1..state) per channel
    a = torch.arange(1, state + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(inner, 1)
    # softplus^-1 of U(1e-3, 1e-1)
    u = torch.rand((inner,), generator=generator, device=dev) * \
        (1e-1 - 1e-3) + 1e-3
    return {
        "w_in": dense_init(generator, (d, 2 * inner)),
        "conv_w": dense_init(generator, (cfg.ssm_conv, inner), scale=0.2),
        "conv_b": torch.zeros((inner,), dtype=torch.float32, device=dev),
        "w_b": dense_init(generator, (inner, state)),
        "w_c": dense_init(generator, (inner, state)),
        "w_dt_down": dense_init(generator, (inner, dt_rank)),
        "w_dt_up": dense_init(generator, (dt_rank, inner)),
        "dt_bias": torch.log(torch.expm1(u)),
        "a_log": torch.log(a),
        "d_skip": torch.ones((inner,), dtype=torch.float32, device=dev),
        "w_out": dense_init(generator, (inner, d)),
    }


def _causal_conv(u, w, b, prev=None):
    """Depthwise causal conv.  u: (B,S,inner); w: (K,inner); prev:
    (B,K-1,inner) carried context for decode (None = zeros)."""
    K, S = w.shape[0], u.shape[1]
    if prev is None:
        prev = u.new_zeros((u.shape[0], K - 1, u.shape[2]))
    up = torch.cat([prev, u], dim=1)                        # (B,S+K-1,in)
    out = sum(up[:, i:i + S] * w[i].to(u.dtype) for i in range(K))
    return out + b.to(u.dtype)


def _ssm_params(params, u, cfg):
    """Selective dt/B/C from the (conv'd, silu'd) input u: (B,L,inner), in
    f32 on the f32 matrices."""
    uf = u.float()
    dt = uf @ params["w_dt_down"] @ params["w_dt_up"]
    dt = softplus(dt + params["dt_bias"])                  # (B,L,inner)
    bm = uf @ params["w_b"]                                 # (B,L,state)
    cm = uf @ params["w_c"]                                 # (B,L,state)
    a = -torch.exp(params["a_log"])                         # (inner,state)
    da = torch.exp(dt[..., None] * a)                       # (B,L,in,st)
    dbu = (dt * uf)[..., None] * bm[:, :, None, :]          # (B,L,in,st)
    return da, dbu, cm, dt


def _chunk_scan(da, dbu, h0):
    """Inclusive scan of h_t = da_t h_{t-1} + dbu_t over axis 1 from h0,
    in log2(L) doubling steps (Hillis-Steele): at offset o, element t takes
    the combine of element t - o with itself.  da/dbu: (B,L,inner,state);
    h0: (B,inner,state).  Returns (h_all, h_last)."""
    a, b = da, dbu
    off = 1
    while off < a.shape[1]:
        b = torch.cat([b[:, :off],
                       torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    h = a * h0[:, None] + b
    return h, h[:, -1]


def _mamba(params, x, cfg, chunk: int):
    """The chunked forward: (out, raw conv input u, final state)."""
    B, S, d = x.shape
    check_chunks(S, chunk)
    dtype = x.dtype
    inner = d * cfg.ssm_expand
    u_raw, z = (x @ params["w_in"].to(dtype)).chunk(2, dim=-1)
    u = F.silu(_causal_conv(u_raw, params["conv_w"], params["conv_b"]))
    L = min(chunk, S)
    h = torch.zeros((B, inner, cfg.ssm_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c in range(S // L):
        da, dbu, cm, _ = _ssm_params(params, u[:, c * L:(c + 1) * L], cfg)
        h_all, h = _chunk_scan(da, dbu, h)
        ys.append(torch.einsum("blis,bls->bli", h_all, cm).to(dtype))
        del da, dbu, h_all
    y = torch.cat(ys, dim=1)
    y = (y + u * params["d_skip"].to(dtype)) * F.silu(z)
    return y @ params["w_out"].to(dtype), u_raw, h


def mamba_fwd(params, x, cfg, chunk: int = CHUNK):
    """Full-sequence forward.  x: (B,S,d) -> (B,S,d)."""
    return _mamba(params, x, cfg, chunk)[0]


def mamba_prefill(params, x, cfg, chunk: int = CHUNK):
    """Returns (out, cache): the final f32 state ``ssm`` (B,inner,state)
    and the conv tail ``conv`` (B,K-1,inner), zero rows first when the
    sequence is shorter than K-1."""
    out, u_raw, h = _mamba(params, x, cfg, chunk)
    K1 = cfg.ssm_conv - 1
    tail = u_raw[:, max(x.shape[1] - K1, 0):]
    tail = F.pad(tail, (0, 0, K1 - tail.shape[1], 0))
    return out, {"ssm": h, "conv": tail}


def mamba_decode(params, x, cfg, cache):
    """One token.  x: (B,1,d); cache: {ssm: (B,inner,state), conv:
    (B,K-1,inner)}.  Returns (out, new cache)."""
    dtype = x.dtype
    u_raw, z = (x @ params["w_in"].to(dtype)).chunk(2, dim=-1)  # (B,1,in)
    new_conv = torch.cat([cache["conv"], u_raw], dim=1)[:, 1:]
    u = F.silu(_causal_conv(u_raw, params["conv_w"], params["conv_b"],
                            prev=cache["conv"].to(dtype)))
    da, dbu, cm, _ = _ssm_params(params, u, cfg)             # (B,1,...)
    h = cache["ssm"] * da[:, 0] + dbu[:, 0]                  # (B,in,st)
    y = torch.einsum("bis,bs->bi", h, cm[:, 0])[:, None, :].to(dtype)
    y = (y + u * params["d_skip"].to(dtype)) * F.silu(z)
    return y @ params["w_out"].to(dtype), {"ssm": h, "conv": new_conv}
