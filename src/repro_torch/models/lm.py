"""Decoder-only LM assembly: embed -> blocks -> norm -> head.

The JAX package's ``models/lm.py`` for serving.  The parameters are an
``nn.ModuleDict`` tree that mirrors the JAX pytree (``embed``,
``final_norm``, ``blocks``, ``lm_head`` when untied), except that
``blocks`` is an ``nn.ModuleList`` of the ``n_layers`` blocks in order
where JAX stacks each block position of the pattern over the periods
(``convert.py`` carries one into the other).  No gradients: training
(``lm_loss``/``lm_backbone``) waits, as do MoE, mamba, xLSTM and the
encoder-decoder (ROADMAP Queue 1); each raises.

Modes: ``lm_prefill`` (full sequence -> last logits + cache) and
``lm_decode`` (one token per row against the cache, updated in place).
The cache is ``{"k", "v"}``, each (n_layers, B, T, KVH, hd).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed, init_embedding, init_mlp,
                                       init_rmsnorm, mlp, rmsnorm, unembed)

ATTN_KINDS = ("attn", "local", "global")
_TODO = "not ported yet (ROADMAP Queue 1)"


def check_supported(cfg) -> None:
    """Raise for what the port cannot run yet."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"encoder-decoder models {_TODO}")
    if cfg.n_experts:
        raise NotImplementedError(f"MoE layers {_TODO}")
    for kind in cfg.block_pattern:
        if kind not in ATTN_KINDS:
            raise NotImplementedError(f"{kind!r} blocks {_TODO}")


def as_module(tree) -> nn.Module:
    """A nested dict of tensors as modules: a dict of tensors becomes an
    ``nn.ParameterDict``, any other dict an ``nn.ModuleDict`` and a list
    an ``nn.ModuleList``.  The parameters take no gradients."""
    if isinstance(tree, list):
        return nn.ModuleList([as_module(t) for t in tree])
    if all(torch.is_tensor(v) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: as_module(v) for k, v in tree.items()})


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_block(generator, cfg) -> dict:
    dev = generator.device
    return {"ln1": init_rmsnorm(cfg.d_model, dev),
            "attn": attn.init_attention(generator, cfg),
            "ln2": init_rmsnorm(cfg.d_model, dev),
            "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_type)}


def init_lm(generator: torch.Generator, cfg) -> nn.ModuleDict:
    """Random f32 master weights on ``generator.device``, with the JAX
    init's distributions (not its numbers: the generators differ)."""
    check_supported(cfg)
    tree = {"embed": init_embedding(generator, cfg.vocab_size, cfg.d_model),
            "final_norm": init_rmsnorm(cfg.d_model, generator.device),
            "blocks": [init_block(generator, cfg)
                       for _ in range(cfg.n_layers)]}
    if not cfg.tie_embeddings:
        tree["lm_head"] = init_embedding(generator, cfg.vocab_size,
                                         cfg.d_model)
    return as_module(tree)


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------

def apply_block(cfg, p: int, params, x, *, mode: str, cache=None,
                position=None, attn_impl: str = "auto"):
    """Block position ``p`` of the pattern; returns (x, cache entry)."""
    kind = cfg.block_pattern[p]
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if mode == "prefill":
        a, new_cache = attn.attention_prefill(
            params["attn"], h, cfg, kind=kind, impl=attn_impl)
    elif mode == "decode":
        a, new_cache = attn.attention_decode(params["attn"], h, cfg, cache,
                                             position, kind=kind)
    else:
        raise ValueError(f"apply_block: mode {mode!r}, expected prefill|"
                         "decode (training waits)")
    x = x + a
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + mlp(params["mlp"], h, cfg.mlp_type), new_cache


# ---------------------------------------------------------------------------
# Full stacks
# ---------------------------------------------------------------------------

def _embed_in(params, cfg, tokens):
    x = embed(params["embed"], tokens, cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                             device=x.device)
    return x


def _logits(params, cfg, x):
    table = params["embed"]["table"] if cfg.tie_embeddings else \
        params["lm_head"]["table"]
    return unembed({}, x, table=table)


@torch.no_grad()
def lm_prefill(params, cfg, tokens, *, attn_impl: str = "auto"):
    """tokens (B, S) -> (last-position logits (B, V) f32, cache with
    k/v of shape (n_layers, B, S, KVH, hd))."""
    check_supported(cfg)
    x = _embed_in(params, cfg, tokens)
    P = len(cfg.block_pattern)
    ks, vs = [], []
    for li, block in enumerate(params["blocks"]):
        x, c = apply_block(cfg, li % P, block, x, mode="prefill",
                           attn_impl=attn_impl)
        ks.append(c["k"])
        vs.append(c["v"])
    x = rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps)
    return _logits(params, cfg, x), {"k": torch.stack(ks),
                                     "v": torch.stack(vs)}


@torch.no_grad()
def lm_decode(params, cfg, tokens, cache, position):
    """tokens (B, 1); position (B,) index of the new token.  Writes the
    new token's K and V into ``cache`` in place; returns (logits (B, V),
    cache)."""
    check_supported(cfg)
    x = _embed_in(params, cfg, tokens)
    P = len(cfg.block_pattern)
    for li, block in enumerate(params["blocks"]):
        layer = {"k": cache["k"][li], "v": cache["v"][li]}
        x, _ = apply_block(cfg, li % P, block, x, mode="decode",
                           cache=layer, position=position)
    x = rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps)
    return _logits(params, cfg, x), cache
