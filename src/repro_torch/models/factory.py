"""Model factory: uniform (init, prefill, decode) per architecture.

    init_fn(generator)                              -> params
    prefill_fn(params, tokens, attn_impl="auto")    -> (logits, cache)
    decode_fn(params, tokens, cache, position)      -> (logits, cache)

The JAX package's ``models/factory.py`` for decoder-only models; the loss
(training) and the encoder-decoder wait (ROADMAP Queue 1).
``make_model(cfg, kv_repeat=, kv_quant=)`` fixes the prefill's cache
storage, as JAX's does.  Its ``cache_specs`` (shapes by ``eval_shape`` of
the prefill) becomes :func:`init_cache`, a direct allocation of the same
tree, and ``param_specs(inference=True)`` becomes
:func:`cast_for_inference`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import lm


def make_model(cfg, *, kv_repeat: int = 1, kv_quant: bool = False) -> dict:
    lm.check_supported(cfg)
    return {"init": functools.partial(_init, cfg=cfg),
            "prefill": functools.partial(_prefill, cfg=cfg,
                                         kv_repeat=kv_repeat,
                                         kv_quant=kv_quant),
            "decode": functools.partial(_decode, cfg=cfg)}


def _init(generator, *, cfg):
    return lm.init_lm(generator, cfg)


def _prefill(params, tokens, *, cfg, attn_impl: str = "auto",
             kv_repeat: int = 1, kv_quant: bool = False):
    return lm.lm_prefill(params, cfg, tokens, attn_impl=attn_impl,
                         kv_repeat=kv_repeat, kv_quant=kv_quant)


def _decode(params, tokens, cache, position, *, cfg):
    return lm.lm_decode(params, cfg, tokens, cache, position)


def cast_for_inference(params, cfg):
    """Cast the matrix weights (ndim >= 2) to the compute dtype once, in
    place; returns ``params``.  Every use casts them to that dtype anyway
    (``.to(dtype)``), so the values are the ones the JAX package computes
    with.  Norm scales stay f32, and so do the embedding tables (the
    unembedding reads them in f32, and the embedding's gather-then-cast
    gives the same rows as a cast table) and the MoE routers (the router
    product is f32 on the f32 weights, ``xf.astype(f32) @ router``: a
    bf16 router would change which experts are chosen)."""
    keep = {id(m[name]) for m in params.modules()
            if isinstance(m, torch.nn.ParameterDict)
            for name in ("table", "router") if name in m}
    for p in params.parameters():
        if p.dim() >= 2 and id(p) not in keep:
            p.data = p.data.to(cfg.dtype)
    return params


def init_cache(cfg, batch: int, max_len: int, device, *, kv_repeat: int = 1,
               kv_quant: bool = False) -> dict:
    """Zeroed caches in the tree ``lm_prefill`` returns and ``lm_decode``
    reads, for sequences up to ``max_len``: ``{"pos{p}": {"k", "v"}}``,
    each (n_periods, batch, T_p, KVH * kv_repeat, hd) in the compute
    dtype, where T_p is the window W of a local position once ``max_len``
    >= W (the ring buffer) and ``max_len`` otherwise; int8 values with
    f32 ``k_scale``/``v_scale`` (..., 1) under ``kv_quant``."""
    kvh, hd = cfg.n_kv_heads * kv_repeat, cfg.resolved_head_dim
    cache = {}
    for p, kind in enumerate(cfg.block_pattern):
        window = cfg.sliding_window if kind == "local" else 0
        T = window if window and max_len >= window else max_len
        shape = (cfg.n_periods, batch, T, kvh, hd)
        if kv_quant:
            entry = {name: torch.zeros(shape, dtype=torch.int8,
                                       device=device) for name in ("k", "v")}
            entry.update({name: torch.zeros(shape[:-1] + (1,),
                                            dtype=torch.float32,
                                            device=device)
                          for name in ("k_scale", "v_scale")})
        else:
            entry = {name: torch.zeros(shape, dtype=cfg.dtype, device=device)
                     for name in ("k", "v")}
        cache[f"pos{p}"] = entry
    return cache
