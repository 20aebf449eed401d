"""Whisper-style encoder-decoder backbone (audio frontend stubbed) — the
JAX package's ``models/encdec.py`` for serving.

The conv frontend is a stub: ``encoder_frames`` (precomputed (B, F, d)
frame embeddings) arrive as an input.  The encoder is bidirectional
self-attention (``mha_full``); the decoder interleaves causal
self-attention (through the flash kernel past 2048 tokens, as every
decoder's prefill), cross-attention to the encoder output (``mha_full``)
and a biased GELU MLP, with layer norms.  Learned absolute positions, no
RoPE.

The parameters are JAX's tree with ``enc_layers`` and ``dec_layers`` as
``nn.ModuleList``s in layer order, where JAX stacks them over the layers
(``convert.py`` carries one into the other).  The cache is JAX's tree:
``{"self": {"k", "v"} (n_layers, B, T, KVH, hd), "encoder_out": (B, F,
d)}``; decode writes the new token's K and V in place.  ``encdec_loss``
waits for training (ROADMAP Queue 1).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed, init_embedding,
                                       init_layernorm, init_mlp, layernorm,
                                       mlp, unembed)
from repro_torch.models.lm import as_module


def init_cross_attention(generator, cfg) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_init(generator, (cfg.d_model, cfg.n_heads, hd)),
        "wk": dense_init(generator, (cfg.d_model, cfg.n_kv_heads, hd)),
        "wv": dense_init(generator, (cfg.d_model, cfg.n_kv_heads, hd)),
        "wo": dense_init(generator, (cfg.n_heads, hd, cfg.d_model),
                         scale=1.0 / math.sqrt(cfg.n_heads * hd)),
    }


def cross_attention(params, x, enc_out, cfg):
    """x: (B,Sq,d) queries; enc_out: (B,F,d)."""
    q = attn._proj(x, params["wq"])
    k = attn._proj(enc_out, params["wk"])
    v = attn._proj(enc_out, params["wv"])
    o = attn.mha_full(q, k, v, torch.arange(q.shape[1], device=x.device),
                      torch.arange(k.shape[1], device=x.device),
                      causal=False)
    return attn._out_proj(o, params["wo"])


def init_enc_layer(generator, cfg) -> dict:
    dev = generator.device
    return {"ln1": init_layernorm(cfg.d_model, dev),
            "attn": attn.init_attention(generator, cfg),
            "ln2": init_layernorm(cfg.d_model, dev),
            "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, "gelu",
                            bias=True)}


def init_dec_layer(generator, cfg) -> dict:
    dev = generator.device
    return {"ln1": init_layernorm(cfg.d_model, dev),
            "attn": attn.init_attention(generator, cfg),
            "ln_x": init_layernorm(cfg.d_model, dev),
            "xattn": init_cross_attention(generator, cfg),
            "ln2": init_layernorm(cfg.d_model, dev),
            "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, "gelu",
                            bias=True)}


def init_encdec(generator: torch.Generator, cfg):
    """Random f32 master weights on ``generator.device``, with the JAX
    init's distributions (not its numbers: the generators differ)."""
    dev = generator.device
    d = cfg.d_model
    return as_module({
        "enc_pos": torch.randn((cfg.enc_positions, d), generator=generator,
                               device=dev) * 0.02,
        "enc_layers": [init_enc_layer(generator, cfg)
                       for _ in range(cfg.n_enc_layers)],
        "enc_norm": init_layernorm(d, dev),
        "embed": init_embedding(generator, cfg.vocab_size, d),
        "dec_pos": torch.randn((cfg.max_position, d), generator=generator,
                               device=dev) * 0.02,
        "dec_layers": [init_dec_layer(generator, cfg)
                       for _ in range(cfg.n_layers)],
        "dec_norm": init_layernorm(d, dev),
    })


def encode(params, cfg, frames):
    """frames: (B,F,d) stub conv output -> (B,F,d)."""
    x = frames + params["enc_pos"].to(frames.dtype)[None]
    for lp in params["enc_layers"]:
        h = layernorm(lp["ln1"], x, cfg.norm_eps)
        x = x + attn.attention_fwd(lp["attn"], h, cfg, causal=False,
                                   impl="full")
        h = layernorm(lp["ln2"], x, cfg.norm_eps)
        x = x + mlp(lp["mlp"], h, "gelu")
    return layernorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_layer(cfg, lp, x, enc_out, *, mode, cache=None, position=None,
               attn_impl: str = "auto"):
    h = layernorm(lp["ln1"], x, cfg.norm_eps)
    if mode == "prefill":
        a, new_cache = attn.attention_prefill(lp["attn"], h, cfg,
                                              impl=attn_impl)
    elif mode == "decode":
        a, new_cache = attn.attention_decode(lp["attn"], h, cfg, cache,
                                             position)
    else:
        raise ValueError(f"_dec_layer: mode {mode!r}, expected prefill|"
                         "decode (training waits)")
    x = x + a
    h = layernorm(lp["ln_x"], x, cfg.norm_eps)
    x = x + cross_attention(lp["xattn"], h, enc_out, cfg)
    h = layernorm(lp["ln2"], x, cfg.norm_eps)
    return x + mlp(lp["mlp"], h, "gelu"), new_cache


def _dec_positions(params, positions, dtype):
    """The learned positions' rows, clamped into the table as the JAX
    package's gather clamps (an idle engine slot decodes past it)."""
    table = params["dec_pos"]
    return table[positions.clamp(0, table.shape[0] - 1)].to(dtype)


def _logits(params, cfg, x):
    x = layernorm(params["dec_norm"], x, cfg.norm_eps)
    return unembed({}, x, table=params["embed"]["table"])


@torch.no_grad()
def encdec_prefill(params, cfg, tokens, encoder_frames, *,
                   attn_impl: str = "auto"):
    """tokens (B, S), encoder_frames (B, F, d) -> (last-position logits
    (B, V) f32, cache)."""
    enc_out = encode(params, cfg, encoder_frames)
    S = tokens.shape[1]
    x = embed(params["embed"], tokens, cfg.dtype) + _dec_positions(
        params, torch.arange(S, device=tokens.device), cfg.dtype)[None]
    entries = []
    for lp in params["dec_layers"]:
        x, c = _dec_layer(cfg, lp, x, enc_out, mode="prefill",
                          attn_impl=attn_impl)
        entries.append(c)
    self_cache = {name: torch.stack([c[name] for c in entries])
                  for name in entries[0]}
    return _logits(params, cfg, x[:, -1]), {"self": self_cache,
                                            "encoder_out": enc_out}


@torch.no_grad()
def encdec_decode(params, cfg, tokens, cache, position):
    """tokens (B, 1); position (B,) index of the new token.  Writes the
    new token's K and V into ``cache["self"]`` in place; returns (logits
    (B, V), cache)."""
    enc_out = cache["encoder_out"]
    x = embed(params["embed"], tokens, cfg.dtype) + _dec_positions(
        params, position, cfg.dtype)[:, None, :]
    for li, lp in enumerate(params["dec_layers"]):
        layer = {name: t[li] for name, t in cache["self"].items()}
        x, _ = _dec_layer(cfg, lp, x, enc_out, mode="decode", cache=layer,
                          position=position)
    return _logits(params, cfg, x[:, -1]), cache
