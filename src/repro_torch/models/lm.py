"""Decoder-only LM assembly: embed -> blocks -> norm -> head.

The JAX package's ``models/lm.py`` for serving.  The parameters are an
``nn.Module`` tree that mirrors the JAX pytree (``embed``,
``final_norm``, ``blocks``, ``lm_head`` when untied), except that
``blocks`` is an ``nn.ModuleList`` of the ``n_layers`` blocks in order
where JAX stacks each block position of the pattern over the periods
(``convert.py`` carries one into the other).  A block is attention
(``attn``), a mamba layer (``mamba``), each followed by ``ln2`` and an
``mlp`` or, at the pattern's MoE positions, a ``moe``; or an mLSTM or
sLSTM ``core``, which carries its own projections and has no ``ln2`` and
no MLP.  No gradients: training (``lm_loss``/``lm_backbone``) waits
(ROADMAP Queue 1).  The encoder-decoder is ``models/encdec.py``.

Modes: ``lm_prefill`` (full sequence -> last logits + cache) and
``lm_decode`` (one token per row against the cache, updated in place).
The cache is JAX's: ``{"pos{p}": {...}}`` for each block position p of
the pattern, each leaf stacked over the periods (layer ``li`` is period
``li // P`` of position ``li % P``): attention ``"k", "v"[, "k_scale",
"v_scale"]`` (n_periods, B, T_p, KVH * kv_repeat, hd) (scales (..., 1)),
a local layer's T_p its window once the sequence reaches it; mamba
``"ssm"`` (n_periods, B, inner, state) f32 and ``"conv"`` (n_periods, B,
K-1, inner); mLSTM ``"C"``, ``"n"``, ``"m"`` and sLSTM ``"h"``, ``"c"``,
``"n"``, ``"m"`` in f32.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm, xlstm
from repro_torch.models.layers import (embed, init_embedding, init_mlp,
                                       init_rmsnorm, mlp, rmsnorm, unembed)

ATTN_KINDS = ("attn", "local", "global")
# the recurrent cores: (prefill, decode), each returning (out, state)
RECURRENT = {"mlstm": (xlstm.mlstm_prefill, xlstm.mlstm_decode),
             "slstm": (xlstm.slstm_prefill, xlstm.slstm_decode)}
BLOCK_KINDS = ATTN_KINDS + ("mamba",) + tuple(RECURRENT)


def check_supported(cfg) -> None:
    """Raise for a block kind the model code does not know (every kind of
    the JAX package's architectures serves)."""
    for kind in cfg.block_pattern:
        if kind not in BLOCK_KINDS:
            raise ValueError(f"{cfg.name}: block kind {kind!r}, expected "
                             f"one of {BLOCK_KINDS}")


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
    """Block position ``p`` of the pattern: attention or mamba, then an
    MLP or, at the MoE positions, a mixture of experts; or an mLSTM or
    sLSTM core alone."""
    kind = cfg.block_pattern[p]
    dev = generator.device
    params = {"ln1": init_rmsnorm(cfg.d_model, dev)}
    if kind == "mlstm":
        params["core"] = xlstm.init_mlstm(generator, cfg)
        return params
    if kind == "slstm":
        params["core"] = xlstm.init_slstm(generator, cfg)
        return params
    if kind == "mamba":
        params["mamba"] = ssm.init_mamba(generator, cfg)
    else:
        params["attn"] = attn.init_attention(generator, cfg)
    params["ln2"] = init_rmsnorm(cfg.d_model, dev)
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
    """Block position ``p`` of the pattern; returns (x, cache entry).  An
    attention decode writes the cache in place and returns it; a
    recurrent decode returns new states (``lm_decode`` copies them in)."""
    kind = cfg.block_pattern[p]
    if mode not in ("prefill", "decode"):
        raise ValueError(f"apply_block: mode {mode!r}, expected prefill|"
                         "decode (training waits)")
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if kind in RECURRENT:
        prefill, decode = RECURRENT[kind]
        a, new_cache = (prefill(params["core"], h, cfg) if mode == "prefill"
                        else decode(params["core"], h, cfg, cache))
        return x + a, new_cache
    if kind == "mamba":
        a, new_cache = (ssm.mamba_prefill(params["mamba"], h, cfg)
                        if mode == "prefill" else
                        ssm.mamba_decode(params["mamba"], h, cfg, cache))
    elif mode == "prefill":
        a, new_cache = attn.attention_prefill(
            params["attn"], h, cfg, kind=kind, impl=attn_impl,
            kv_repeat=kv_repeat, kv_quant=kv_quant)
    else:
        a, new_cache = attn.attention_decode(params["attn"], h, cfg, cache,
                                             position, kind=kind)
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
    """tokens (B, 1); position (B,) index of the new token.  Updates
    ``cache`` in place (the new token's K and V, each recurrent layer's
    states); returns (logits (B, V), cache)."""
    check_supported(cfg)
    x = _embed_in(params, cfg, tokens)
    P = len(cfg.block_pattern)
    for li, block in enumerate(params["blocks"]):
        layer = {name: t[li // P]
                 for name, t in cache[f"pos{li % P}"].items()}
        x, new = apply_block(cfg, li % P, block, x, mode="decode",
                             cache=layer, position=position)
        for name, t in new.items():
            if t is not layer[name]:
                layer[name].copy_(t)
    x = rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps)
    return _logits(params, cfg, x), cache
