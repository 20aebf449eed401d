"""Model factory: uniform (init, prefill, decode) per architecture.

    init_fn(generator)                              -> params
    prefill_fn(params, tokens, attn_impl="auto")    -> (logits, cache)
    decode_fn(params, tokens, cache, position)      -> (logits, cache)

The JAX package's ``models/factory.py`` for decoder-only models; the loss
(training) and the encoder-decoder wait (ROADMAP Queue 1).  Its
``cache_specs`` (shapes by ``eval_shape``) becomes :func:`init_cache`, a
direct allocation, and ``param_specs(inference=True)`` becomes
:func:`cast_for_inference`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import lm


def make_model(cfg) -> dict:
    lm.check_supported(cfg)
    return {"init": functools.partial(_init, cfg=cfg),
            "prefill": functools.partial(_prefill, cfg=cfg),
            "decode": functools.partial(_decode, cfg=cfg)}


def _init(generator, *, cfg):
    return lm.init_lm(generator, cfg)


def _prefill(params, tokens, *, cfg, attn_impl: str = "auto"):
    return lm.lm_prefill(params, cfg, tokens, attn_impl=attn_impl)


def _decode(params, tokens, cache, position, *, cfg):
    return lm.lm_decode(params, cfg, tokens, cache, position)


def cast_for_inference(params, cfg):
    """Cast the matrix weights (ndim >= 2) to the compute dtype once, in
    place; returns ``params``.  Every use casts them to that dtype anyway
    (``.to(dtype)``), so the values are the ones the JAX package computes
    with.  Norm scales stay f32, and so do the embedding tables: the
    unembedding reads them in f32, and the embedding's gather-then-cast
    gives the same rows as a cast table."""
    tables = {id(m["table"]) for m in params.modules()
              if isinstance(m, torch.nn.ParameterDict) and "table" in m}
    for p in params.parameters():
        if p.dim() >= 2 and id(p) not in tables:
            p.data = p.data.to(cfg.dtype)
    return params


def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    """Zeroed k/v caches, each (n_layers, batch, max_len, KVH, hd) in the
    compute dtype: the layout ``lm_prefill`` returns and ``lm_decode``
    reads."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {name: torch.zeros(shape, dtype=cfg.dtype, device=device)
            for name in ("k", "v")}
