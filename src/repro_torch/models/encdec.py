"""Whisper-style encoder-decoder backbone (audio frontend stubbed) — the
JAX package's ``models/encdec.py``.

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
is the training loss (no recomputation, as in the JAX package).

On a ``(data, model)`` mesh (``mesh=``) a rank holds JAX's blocks of the
weights (:func:`init_encdec` or ``convert.lm_params_from_numpy`` with the
mesh): the encoder's attention, the decoder's self- and cross-attention
run on the rank's heads (``wo`` row-parallel, then the ``"model"`` sum),
the biased GELU MLPs on its ff slice (``layers.mlp_sharded``); the layer
norms and the positions are whole.  The table is vocab-parallel where the
vocab divides the model axis (the lookup summed over ``"model"``, the
logits the rank's vocab shard, the vocab-parallel loss); where it does
not (whisper-tiny's 51,865), JAX leaves the table whole, so every rank
looks up and unembeds the whole vocab, the loss is the whole-logits
``cross_entropy``, and the table's gradient is every rank's own (the
same on each, never summed over ``"model"``).  The cache is the rank's
block of JAX's: the self-attention K/V by ``_cache_pspec`` (its heads or
head-dimension slice; under ``seq_parallel``, a batch that does not
cover ``"data"``, its block of the sequence over ``"data"`` and all rows),
``encoder_out`` its rows (all rows, whole, when sequence-parallel).
"""
from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import model_copy, model_split, model_sum
from repro_torch.models import attention as attn
from repro_torch.models.layers import (cross_entropy, cross_entropy_sharded,
                                       dense_init, embed, embed_sharded,
                                       init_embedding, init_layernorm,
                                       init_mlp, layernorm, mlp, mlp_sharded,
                                       unembed)
from repro_torch.models.lm import as_module, cast_tree
from repro_torch.runtime import sharding as sh


def init_cross_attention(generator, cfg) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_init(generator, (cfg.d_model, cfg.n_heads, hd)),
        "wk": dense_init(generator, (cfg.d_model, cfg.n_kv_heads, hd)),
        "wv": dense_init(generator, (cfg.d_model, cfg.n_kv_heads, hd)),
        "wo": dense_init(generator, (cfg.n_heads, hd, cfg.d_model),
                         scale=1.0 / math.sqrt(cfg.n_heads * hd)),
    }


def cross_attention(params, x, enc_out, cfg, mesh=None):
    """x: (B,Sq,d) queries; enc_out: (B,F,d).  On a mesh, the rank's
    query heads over the kv heads they read (its own where the kv heads
    shard over ``"model"``, picked by index from the whole projection
    where they do not, as ``attention.attention_fwd``); ``wo``
    row-parallel, then the ``"model"`` sum.  Heads that do not divide the
    model axis are whole on every rank and attend as on one device
    (``attention.heads_whole``)."""
    M, m = attn._model_rank(mesh)
    if M > 1 and attn.heads_whole(params, cfg):
        M = 1
    p = dict(params)
    kv_whole = M > 1 and params["wk"].shape[1] == cfg.n_kv_heads
    if M > 1:
        x, enc_out = model_copy(mesh, x), model_copy(mesh, enc_out)
        if kv_whole:
            p["wk"], p["wv"] = (model_copy(mesh, p["wk"]),
                                model_copy(mesh, p["wv"]))
    q = attn._proj(x, p["wq"])
    k = attn._proj(enc_out, p["wk"])
    v = attn._proj(enc_out, p["wv"])
    if kv_whole:
        n_q = q.shape[2]
        G = cfg.n_heads // cfg.n_kv_heads
        k = attn._kv_for_heads(k, m * n_q, n_q, G)
        v = attn._kv_for_heads(v, m * n_q, n_q, G)
    o = attn.mha_full(q, k, v, torch.arange(q.shape[1], device=x.device),
                      torch.arange(k.shape[1], device=x.device),
                      causal=False)
    out = attn._out_proj(o, params["wo"])
    return model_sum(mesh, out) if M > 1 else out


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


def init_encdec(generator: torch.Generator, cfg, mesh=None, *,
                train: bool = False, inference: bool = False):
    """Random f32 master weights on ``generator.device``, with the JAX
    init's distributions (not its numbers: the generators differ).  With
    a ``mesh``, the rank's blocks of the same weights (JAX's inference
    rules, or its training rules under ``train``), each cut as soon as it
    is drawn; ``inference`` casts each as ``lm.init_lm`` does."""
    dev = generator.device
    d = cfg.d_model

    def cut(tree, prefix):
        if mesh is not None:
            tree = sh.blocks_of(tree, mesh, prefix, stacked=False,
                                train=train)
        return cast_tree(tree, cfg) if inference else tree

    def pos(n):
        return torch.randn((n, d), generator=generator, device=dev) * 0.02

    return as_module({
        "enc_pos": cut({"enc_pos": pos(cfg.enc_positions)}, "")["enc_pos"],
        "enc_layers": [cut(init_enc_layer(generator, cfg), "enc_layers")
                       for _ in range(cfg.n_enc_layers)],
        "enc_norm": init_layernorm(d, dev),
        "embed": cut(init_embedding(generator, cfg.vocab_size, d), "embed"),
        "dec_pos": cut({"dec_pos": pos(cfg.max_position)}, "")["dec_pos"],
        "dec_layers": [cut(init_dec_layer(generator, cfg), "dec_layers")
                       for _ in range(cfg.n_layers)],
        "dec_norm": init_layernorm(d, dev),
    })


def _mlp(params, h, cfg, mesh):
    if mesh is None:
        return mlp(params, h, "gelu")
    return mlp_sharded(params, h, "gelu", cfg.d_ff, mesh)


def encode(params, cfg, frames, mesh=None):
    """frames: (B,F,d) stub conv output -> (B,F,d) (on a mesh, the same
    on every rank of ``"model"``)."""
    x = frames + params["enc_pos"].to(frames.dtype)[None]
    for lp in params["enc_layers"]:
        h = layernorm(lp["ln1"], x, cfg.norm_eps)
        x = x + attn.attention_fwd(lp["attn"], h, cfg, causal=False,
                                   impl="full", mesh=mesh)
        h = layernorm(lp["ln2"], x, cfg.norm_eps)
        x = x + _mlp(lp["mlp"], h, cfg, mesh)
    return layernorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_layer(cfg, lp, x, enc_out, *, mode, cache=None, position=None,
               attn_impl: str = "auto", mesh=None, sp_len=None):
    h = layernorm(lp["ln1"], x, cfg.norm_eps)
    new_cache = None
    if mode == "fwd":
        a = attn.attention_fwd(lp["attn"], h, cfg, impl=attn_impl,
                               mesh=mesh)
    elif mode == "prefill":
        a, new_cache = attn.attention_prefill(
            lp["attn"], h, cfg, impl=attn_impl, mesh=mesh,
            seq_parallel=sp_len is not None)
    elif mode == "decode":
        a, new_cache = attn.attention_decode(lp["attn"], h, cfg, cache,
                                             position, mesh=mesh,
                                             sp_len=sp_len)
    else:
        raise ValueError(f"_dec_layer: mode {mode!r}, expected fwd|"
                         "prefill|decode")
    x = x + a
    h = layernorm(lp["ln_x"], x, cfg.norm_eps)
    x = x + cross_attention(lp["xattn"], h, enc_out, cfg, mesh)
    h = layernorm(lp["ln2"], x, cfg.norm_eps)
    return x + _mlp(lp["mlp"], h, cfg, mesh), new_cache


def _dec_positions(params, positions, dtype):
    """The learned positions' rows, clamped into the table as the JAX
    package's gather clamps (an idle engine slot decodes past it)."""
    table = params["dec_pos"]
    return table[positions.clamp(0, table.shape[0] - 1)].to(dtype)


def _embed_in(params, cfg, tokens, positions, mesh):
    """The tokens' embedding (vocab-parallel on a mesh whose model axis
    cuts the table) plus their positions' rows."""
    if model_split(mesh):
        x = embed_sharded(params["embed"], tokens, cfg.dtype,
                          cfg.vocab_size, mesh)
    else:
        x = embed(params["embed"], tokens, cfg.dtype)
    return x + _dec_positions(params, positions, cfg.dtype)


def _logits(params, cfg, x):
    """f32 logits (the rank's vocab shard of a vocab-parallel table)."""
    x = layernorm(params["dec_norm"], x, cfg.norm_eps)
    return unembed({}, x, table=params["embed"]["table"])


def encdec_loss(params, cfg, tokens, labels, encoder_frames, *,
                attn_impl: str = "auto", mesh=None):
    """Mean token cross-entropy (with z-loss) of the decoder's next-token
    labels given the encoder frames, as the JAX package's
    ``encdec_loss``; a 0-d f32 tensor.  On a mesh, of the rank's rows
    (its blocks of the weights gathered over ``"data"`` by the caller):
    the vocab-parallel loss where the table is cut over ``"model"``, the
    whole-logits loss where it is whole."""
    enc_out = encode(params, cfg, encoder_frames, mesh)
    S = tokens.shape[1]
    x = _embed_in(params, cfg, tokens,
                  torch.arange(S, device=tokens.device)[None], mesh)
    for lp in params["dec_layers"]:
        x, _ = _dec_layer(cfg, lp, x, enc_out, mode="fwd",
                          attn_impl=attn_impl, mesh=mesh)
    x = layernorm(params["dec_norm"], x, cfg.norm_eps)
    table = params["embed"]["table"]
    if mesh is not None and table.shape[0] < cfg.vocab_size:
        return cross_entropy_sharded(
            unembed({}, model_copy(mesh, x), table=table), labels, mesh)
    return cross_entropy(unembed({}, x, table=table), labels)


@torch.no_grad()
def encdec_prefill(params, cfg, tokens, encoder_frames, *,
                   attn_impl: str = "auto", mesh=None,
                   seq_parallel: bool = False):
    """tokens (B, S), encoder_frames (B, F, d) -> (last-position logits
    (B, V) f32, cache).  With a ``mesh``: the rank's rows (all rows under
    ``seq_parallel``) and blocks; returns its vocab shard of the logits
    (the whole logits where the table is whole) and its blocks of the
    cache."""
    enc_out = encode(params, cfg, encoder_frames, mesh)
    S = tokens.shape[1]
    sp_len = S if mesh is not None and seq_parallel else None
    x = _embed_in(params, cfg, tokens,
                  torch.arange(S, device=tokens.device)[None], mesh)
    entries = []
    for lp in params["dec_layers"]:
        x, c = _dec_layer(cfg, lp, x, enc_out, mode="prefill",
                          attn_impl=attn_impl, mesh=mesh, sp_len=sp_len)
        entries.append(c)
    self_cache = {name: torch.stack([c[name] for c in entries])
                  for name in entries[0]}
    return _logits(params, cfg, x[:, -1]), {"self": self_cache,
                                            "encoder_out": enc_out}


@torch.no_grad()
def encdec_decode(params, cfg, tokens, cache, position, *, mesh=None,
                  sp_len=None):
    """tokens (B, 1); position (B,) index of the new token.  Writes the
    new token's K and V into ``cache["self"]`` in place; returns (logits
    (B, V), cache).  With a ``mesh``, as :func:`encdec_prefill`;
    ``sp_len``, the global length of the self-attention cache, marks a
    sequence-parallel decode (``attention.attention_decode``)."""
    enc_out = cache["encoder_out"]
    x = _embed_in(params, cfg, tokens, position[:, None], mesh)
    for li, lp in enumerate(params["dec_layers"]):
        layer = {name: t[li] for name, t in cache["self"].items()}
        x, _ = _dec_layer(cfg, lp, x, enc_out, mode="decode", cache=layer,
                          position=position, mesh=mesh, sp_len=sp_len)
    return _logits(params, cfg, x[:, -1]), cache
