"""Model factory: uniform (init, loss, prefill, decode) per architecture.

    init_fn(generator)                                  -> params
    loss_fn(params, batch)                              -> 0-d f32 loss
    prefill_fn(params, tokens[, encoder_frames], attn_impl="auto")
                                                        -> (logits, cache)
    decode_fn(params, tokens, cache, position)          -> (logits, cache)

The JAX package's ``models/factory.py``: decoder-only models through
``models/lm.py``, the encoder-decoder through ``models/encdec.py`` (its
prefill takes the encoder frames).  ``batch`` is JAX's dict: ``tokens``
and ``labels`` (B, S), and ``encoder_frames`` (B, F, d) for the
encoder-decoder.  ``make_model(cfg, kv_repeat=,
kv_quant=)`` fixes a decoder's prefill cache storage, as JAX's does (the
encoder-decoder's prefill takes neither, as in JAX).  Its
``cache_specs`` (shapes by ``eval_shape`` of the prefill) becomes
:func:`init_cache`, a direct allocation of the same tree, and
``param_specs(inference=True)`` becomes :func:`cast_for_inference`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import encdec, lm

# matrices the JAX package reads at f32 (never through ``.astype(dtype)``),
# so they stay f32 under cast_for_inference: the embedding tables, the MoE
# routers, mamba's selective and state matrices, the mLSTM's gate and the
# sLSTM's input and recurrent matrices
F32_MATRICES = ("table", "router", "a_log", "w_b", "w_c", "w_dt_down",
                "w_dt_up", "w_i", "w_f", "w_x", "r")


def make_model(cfg, *, kv_repeat: int = 1, kv_quant: bool = False) -> dict:
    lm.check_supported(cfg)
    if cfg.is_encoder_decoder:
        return {"init": functools.partial(encdec.init_encdec, cfg=cfg),
                "loss": functools.partial(_encdec_loss, cfg=cfg),
                "prefill": functools.partial(_encdec_prefill, cfg=cfg),
                "decode": functools.partial(_encdec_decode, cfg=cfg)}
    return {"init": functools.partial(_init, cfg=cfg),
            "loss": functools.partial(_loss, cfg=cfg),
            "prefill": functools.partial(_prefill, cfg=cfg,
                                         kv_repeat=kv_repeat,
                                         kv_quant=kv_quant),
            "decode": functools.partial(_decode, cfg=cfg)}


def _init(generator, *, cfg):
    return lm.init_lm(generator, cfg)


def _loss(params, batch, *, cfg):
    return lm.lm_loss(params, cfg, batch["tokens"], batch["labels"])


def _encdec_loss(params, batch, *, cfg):
    return encdec.encdec_loss(params, cfg, batch["tokens"], batch["labels"],
                              batch["encoder_frames"])


def _prefill(params, tokens, *, cfg, attn_impl: str = "auto",
             kv_repeat: int = 1, kv_quant: bool = False):
    return lm.lm_prefill(params, cfg, tokens, attn_impl=attn_impl,
                         kv_repeat=kv_repeat, kv_quant=kv_quant)


def _decode(params, tokens, cache, position, *, cfg):
    return lm.lm_decode(params, cfg, tokens, cache, position)


def _encdec_prefill(params, tokens, encoder_frames, *, cfg,
                    attn_impl: str = "auto"):
    return encdec.encdec_prefill(params, cfg, tokens, encoder_frames,
                                 attn_impl=attn_impl)


def _encdec_decode(params, tokens, cache, position, *, cfg):
    return encdec.encdec_decode(params, cfg, tokens, cache, position)


def cast_for_inference(params, cfg):
    """Cast the matrix weights (ndim >= 2) to the compute dtype once, in
    place; returns ``params``.  Every use of a cast matrix casts it to
    that dtype anyway (``.to(dtype)``), so the values are the ones the
    JAX package computes with.  Norm scales and biases stay f32, and so do
    the matrices of :data:`F32_MATRICES`, which the JAX package reads in
    f32: the embedding tables (the unembedding reads them in f32, and the
    embedding's gather-then-cast gives the same rows as a cast table), the
    MoE routers (a bf16 router would change which experts are chosen) and
    the recurrent blocks' f32 products."""
    for name, p in params.named_parameters():
        if p.dim() >= 2 and name.rsplit(".", 1)[-1] not in F32_MATRICES:
            p.data = p.data.to(cfg.dtype)
    return params


def init_cache(cfg, batch: int, max_len: int, device, *, kv_repeat: int = 1,
               kv_quant: bool = False) -> dict:
    """Zeroed caches in the tree the prefill returns and the decode reads,
    for sequences up to ``max_len`` (the shapes and dtypes of JAX's
    ``cache_specs``).  A decoder: ``{"pos{p}": {...}}`` with attention
    ``"k"``/``"v"`` (n_periods, batch, T_p, KVH * kv_repeat, hd) in the
    compute dtype, where T_p is the window W of a local position once
    ``max_len`` >= W (the ring buffer) and ``max_len`` otherwise (int8
    values with f32 ``k_scale``/``v_scale`` (..., 1) under ``kv_quant``);
    mamba ``"ssm"`` (n_periods, batch, inner, state) f32 and ``"conv"``
    (n_periods, batch, K-1, inner) in the compute dtype; mLSTM ``"C"``
    (..., nh, dh, dh), ``"n"`` (..., nh, dh), ``"m"`` (..., nh) and sLSTM
    ``"h"``, ``"c"``, ``"n"``, ``"m"`` (..., nh, dh), f32.  The
    encoder-decoder: ``{"self": {"k", "v"} (n_layers, batch, max_len,
    KVH, hd), "encoder_out": (batch, enc_positions, d)}`` in the compute
    dtype."""
    hd = cfg.resolved_head_dim

    def zeros(shape, dtype=cfg.dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.is_encoder_decoder:
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
        return {"self": {"k": zeros(shape), "v": zeros(shape)},
                "encoder_out": zeros((batch, cfg.enc_positions,
                                      cfg.d_model))}
    f32 = torch.float32
    lead = (cfg.n_periods, batch)
    cache = {}
    for p, kind in enumerate(cfg.block_pattern):
        if kind == "mamba":
            inner = cfg.d_model * cfg.ssm_expand
            entry = {"ssm": zeros(lead + (inner, cfg.ssm_state), f32),
                     "conv": zeros(lead + (cfg.ssm_conv - 1, inner))}
        elif kind == "mlstm":
            nh = cfg.n_heads
            dh = 2 * cfg.d_model // nh
            entry = {"C": zeros(lead + (nh, dh, dh), f32),
                     "n": zeros(lead + (nh, dh), f32),
                     "m": zeros(lead + (nh,), f32)}
        elif kind == "slstm":
            nh = cfg.n_heads
            entry = {name: zeros(lead + (nh, cfg.d_model // nh), f32)
                     for name in ("h", "c", "n", "m")}
        else:
            window = cfg.sliding_window if kind == "local" else 0
            T = window if window and max_len >= window else max_len
            shape = lead + (T, cfg.n_kv_heads * kv_repeat, hd)
            if kv_quant:
                entry = {name: zeros(shape, torch.int8) for name in ("k", "v")}
                entry.update({name: zeros(shape[:-1] + (1,), f32)
                              for name in ("k_scale", "v_scale")})
            else:
                entry = {name: zeros(shape) for name in ("k", "v")}
        cache[f"pos{p}"] = entry
    return cache
