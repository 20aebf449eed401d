"""Decoder-only LM assembly: embed -> blocks -> norm -> head.

The JAX package's ``models/lm.py`` for serving.  The parameters are an
``nn.Module`` tree that mirrors the JAX pytree (``embed``,
``final_norm``, ``blocks``, ``lm_head`` when untied), except that
``blocks`` is an ``nn.ModuleList`` of the ``n_layers`` blocks in order
where JAX stacks each block position of the pattern over the periods
(``convert.py`` carries one into the other).  A block holds an ``mlp``
or, at the pattern's MoE positions, a ``moe``.  No gradients: training
(``lm_loss``/``lm_backbone``) waits, as do the mamba and xLSTM blocks and
the encoder-decoder (ROADMAP Queue 1); each raises.

Modes: ``lm_prefill`` (full sequence -> last logits + cache) and
``lm_decode`` (one token per row against the cache, updated in place).
The cache is JAX's: ``{"pos{p}": {"k", "v"[, "k_scale", "v_scale"]}}``
for each block position p of the pattern, each leaf (n_periods, B, T_p,
KVH * kv_repeat, hd) (scales (..., 1)); layer ``li`` is period ``li //
P`` of position ``li % P``.  A local layer's T_p is its window once the
sequence reaches it.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (embed, init_embedding, init_mlp,
                                       init_rmsnorm, mlp, rmsnorm, unembed)

ATTN_KINDS = ("attn", "local", "global")
_TODO = "not ported yet (ROADMAP Queue 1)"


def check_supported(cfg) -> None:
    """Raise for what the port cannot run yet."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"encoder-decoder models {_TODO}")
    for kind in cfg.block_pattern:
        if kind not in ATTN_KINDS:
            raise NotImplementedError(f"{kind!r} blocks {_TODO}")


def _position_is_moe(cfg, p: int) -> bool:
    if cfg.n_experts == 0:
        return False
    if len(cfg.block_pattern) % cfg.moe_every:
        raise ValueError(f"{cfg.name}: moe_every={cfg.moe_every} does not "
                         f"divide the period {len(cfg.block_pattern)}")
    return p % cfg.moe_every == (cfg.moe_every - 1)


class ParamTree(nn.Module):
    """A dict of tensors and sub-dicts as one module (the attention
    parameters beside their ``qnorm``/``knorm`` norms): tensors are
    parameters, dicts submodules, and it reads like a dict."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if torch.is_tensor(v):
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(k, as_module(v))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._keys

    def keys(self):
        return list(self._keys)

    def items(self):
        return [(k, self[k]) for k in self._keys]


def as_module(tree) -> nn.Module:
    """A nested dict of tensors as modules: a dict of tensors becomes an
    ``nn.ParameterDict``, a dict of dicts an ``nn.ModuleDict``, a dict of
    both a :class:`ParamTree`, and a list an ``nn.ModuleList``.  The
    parameters take no gradients."""
    if isinstance(tree, list):
        return nn.ModuleList([as_module(t) for t in tree])
    tensors = [torch.is_tensor(v) for v in tree.values()]
    if all(tensors):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    if any(tensors):
        return ParamTree(tree)
    return nn.ModuleDict({k: as_module(v) for k, v in tree.items()})


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_block(generator, cfg, p: int) -> dict:
    """Block position ``p`` of the pattern: attention, then an MLP or,
    at the MoE positions, a mixture of experts."""
    dev = generator.device
    params = {"ln1": init_rmsnorm(cfg.d_model, dev),
              "attn": attn.init_attention(generator, cfg),
              "ln2": init_rmsnorm(cfg.d_model, dev)}
    if _position_is_moe(cfg, p):
        params["moe"] = moe_lib.init_moe(generator, cfg)
    else:
        params["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff,
                                 cfg.mlp_type)
    return params


def init_lm(generator: torch.Generator, cfg) -> nn.ModuleDict:
    """Random f32 master weights on ``generator.device``, with the JAX
    init's distributions (not its numbers: the generators differ)."""
    check_supported(cfg)
    P = len(cfg.block_pattern)
    tree = {"embed": init_embedding(generator, cfg.vocab_size, cfg.d_model),
            "final_norm": init_rmsnorm(cfg.d_model, generator.device),
            "blocks": [init_block(generator, cfg, li % P)
                       for li in range(cfg.n_layers)]}
    if not cfg.tie_embeddings:
        tree["lm_head"] = init_embedding(generator, cfg.vocab_size,
                                         cfg.d_model)
    return as_module(tree)


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------

def apply_block(cfg, p: int, params, x, *, mode: str, cache=None,
                position=None, attn_impl: str = "auto", kv_repeat: int = 1,
                kv_quant: bool = False):
    """Block position ``p`` of the pattern; returns (x, cache entry)."""
    kind = cfg.block_pattern[p]
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if mode == "prefill":
        a, new_cache = attn.attention_prefill(
            params["attn"], h, cfg, kind=kind, impl=attn_impl,
            kv_repeat=kv_repeat, kv_quant=kv_quant)
    elif mode == "decode":
        a, new_cache = attn.attention_decode(params["attn"], h, cfg, cache,
                                             position, kind=kind)
    else:
        raise ValueError(f"apply_block: mode {mode!r}, expected prefill|"
                         "decode (training waits)")
    x = x + a
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    if "moe" in params:
        m, _ = moe_lib.moe_apply(params["moe"], h, cfg)
    else:
        m = mlp(params["mlp"], h, cfg.mlp_type)
    return x + m, new_cache


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
def lm_prefill(params, cfg, tokens, *, attn_impl: str = "auto",
               kv_repeat: int = 1, kv_quant: bool = False):
    """tokens (B, S) -> (last-position logits (B, V) f32, cache)."""
    check_supported(cfg)
    x = _embed_in(params, cfg, tokens)
    P = len(cfg.block_pattern)
    entries = [[] for _ in range(P)]
    for li, block in enumerate(params["blocks"]):
        x, c = apply_block(cfg, li % P, block, x, mode="prefill",
                           attn_impl=attn_impl, kv_repeat=kv_repeat,
                           kv_quant=kv_quant)
        entries[li % P].append(c)
    x = rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps)
    cache = {f"pos{p}": {name: torch.stack([c[name] for c in cs])
                         for name in cs[0]}
             for p, cs in enumerate(entries)}
    return _logits(params, cfg, x), cache


@torch.no_grad()
def lm_decode(params, cfg, tokens, cache, position):
    """tokens (B, 1); position (B,) index of the new token.  Writes the
    new token's K and V into ``cache`` in place; returns (logits (B, V),
    cache)."""
    check_supported(cfg)
    x = _embed_in(params, cfg, tokens)
    P = len(cfg.block_pattern)
    for li, block in enumerate(params["blocks"]):
        layer = {name: t[li // P]
                 for name, t in cache[f"pos{li % P}"].items()}
        x, _ = apply_block(cfg, li % P, block, x, mode="decode",
                           cache=layer, position=position)
    x = rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps)
    return _logits(params, cfg, x), cache
