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
encoder-decoder's prefill takes neither, as in JAX).  JAX's
``cache_specs`` (shapes by ``eval_shape`` of the prefill) is
:func:`cache_specs`, :func:`init_cache` on the meta device, a direct
allocation of the same tree; ``param_specs`` is :func:`param_specs`, the
tree on the meta device (:func:`param_shapes` the same with fake
tensors, cached), and its ``inference=True`` cast is
:func:`cast_for_inference`.

``make_model(cfg, mesh=)`` and ``init_cache(..., mesh=)`` are a rank's
share of a ``(data, model)`` mesh (``launch/mesh.py``): its blocks of the
weights, its rows and its blocks of the cache (``models/lm.py``).  The
prefill then takes ``seq_parallel`` and the decode ``sp_len`` for a
batch that does not cover ``"data"``.  Its ``loss`` is the sharded loss,
on the rank's rows and its training blocks (``init(generator,
train=True)``, JAX's training rules): a decoder's gathers a period at a
time (``lm.lm_loss(mesh=)``), the encoder-decoder's gathers its whole
tree over ``"data"`` once, and both run tensor-parallel over
``"model"``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import encdec, lm
from repro_torch.runtime import sharding as sh

# matrices the JAX package reads at f32 (never through ``.astype(dtype)``),
# so they stay f32 under cast_for_inference: the embedding tables, the MoE
# routers, mamba's selective and state matrices, the mLSTM's gate and the
# sLSTM's input and recurrent matrices
F32_MATRICES = ("table", "router", "a_log", "w_b", "w_c", "w_dt_down",
                "w_dt_up", "w_i", "w_f", "w_x", "r")


def make_model(cfg, *, kv_repeat: int = 1, kv_quant: bool = False,
               mesh=None) -> dict:
    lm.check_supported(cfg)
    lm.check_mesh(cfg, mesh)
    if mesh is not None:
        if cfg.is_encoder_decoder:
            return {"init": functools.partial(encdec.init_encdec, cfg=cfg,
                                              mesh=mesh),
                    "loss": functools.partial(_encdec_loss, cfg=cfg,
                                              mesh=mesh),
                    "prefill": functools.partial(_encdec_prefill, cfg=cfg,
                                                 mesh=mesh),
                    "decode": functools.partial(_encdec_decode, cfg=cfg,
                                                mesh=mesh)}
        return {"init": functools.partial(lm.init_lm, cfg=cfg, mesh=mesh),
                "loss": functools.partial(_loss, cfg=cfg, mesh=mesh),
                "prefill": functools.partial(_prefill, cfg=cfg,
                                             kv_repeat=kv_repeat,
                                             kv_quant=kv_quant, mesh=mesh),
                "decode": functools.partial(_decode, cfg=cfg, mesh=mesh)}
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


def _loss(params, batch, *, cfg, mesh=None):
    return lm.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                      mesh=mesh)


def _encdec_loss(params, batch, *, cfg, mesh=None):
    if mesh is not None:
        params, = lm.gathered(mesh, sh.train_specs(cfg, mesh.shape),
                              [("", params)])
    return encdec.encdec_loss(params, cfg, batch["tokens"], batch["labels"],
                              batch["encoder_frames"], mesh=mesh)


def _prefill(params, tokens, *, cfg, attn_impl: str = "auto",
             kv_repeat: int = 1, kv_quant: bool = False, mesh=None,
             seq_parallel: bool = False):
    return lm.lm_prefill(params, cfg, tokens, attn_impl=attn_impl,
                         kv_repeat=kv_repeat, kv_quant=kv_quant, mesh=mesh,
                         seq_parallel=seq_parallel)


def _decode(params, tokens, cache, position, *, cfg, mesh=None,
            sp_len=None):
    return lm.lm_decode(params, cfg, tokens, cache, position, mesh=mesh,
                        sp_len=sp_len)


def _encdec_prefill(params, tokens, encoder_frames, *, cfg,
                    attn_impl: str = "auto", mesh=None,
                    seq_parallel: bool = False):
    return encdec.encdec_prefill(params, cfg, tokens, encoder_frames,
                                 attn_impl=attn_impl, mesh=mesh,
                                 seq_parallel=seq_parallel)


def _encdec_decode(params, tokens, cache, position, *, cfg, mesh=None,
                   sp_len=None):
    return encdec.encdec_decode(params, cfg, tokens, cache, position,
                                mesh=mesh, sp_len=sp_len)


def keeps_f32(leaf: str, t) -> bool:
    """Whether a weight named ``leaf`` (the last part of its path) stays
    f32 when served: the norm scales and biases (ndim < 2) and the
    matrices of :data:`F32_MATRICES`; the rule of
    :func:`cast_for_inference` and of ``lm.cast_tree``."""
    return t.dim() < 2 or leaf in F32_MATRICES


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
        if not keeps_f32(name.rsplit(".", 1)[-1], p):
            p.data = p.data.to(cfg.dtype)
    return params


@functools.lru_cache(maxsize=16)
def param_shapes(cfg):
    """The parameter module tree of ``cfg`` with fake tensors (shapes and
    dtypes, no memory): what the partition rules read.  Made once a
    config (a few seconds at full size)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return make_model(cfg)["init"](torch.Generator())


def param_specs(cfg, *, inference: bool = False):
    """The parameter module tree of ``cfg`` on the meta device (shapes
    and dtypes, no memory), JAX's ``param_specs``: ``inference`` casts
    the matrices as :func:`cast_for_inference` does (JAX's rule casts
    every f32 matrix; the port keeps :data:`F32_MATRICES` f32, as the
    model reads them)."""
    tree = param_shapes.__wrapped__(cfg)
    for mod in tree.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:       # the fake leaf, swapped for a meta one
                mod._parameters[name] = torch.nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device="meta"),
                    requires_grad=False)
    return cast_for_inference(tree, cfg) if inference else tree


def cache_specs(cfg, batch: int, seq_len: int, kv_repeat: int = 1,
                kv_quant: bool = False) -> dict:
    """A decode cell's cache tree on the meta device: :func:`init_cache`,
    the tree the prefill returns and the decode reads (JAX's
    ``cache_specs`` takes it from its prefill by ``eval_shape``)."""
    return init_cache(cfg, batch, seq_len, "meta", kv_repeat=kv_repeat,
                      kv_quant=kv_quant)


def init_cache(cfg, batch: int, max_len: int, device, *, kv_repeat: int = 1,
               kv_quant: bool = False, mesh=None) -> dict:
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
    dtype.  With a ``mesh``, ``batch`` is the global batch and each leaf
    the rank's block of it (``sharding._cache_pspec``, sequence-parallel
    when the batch does not cover ``"data"``)."""
    if mesh is not None:
        whole = init_cache(cfg, batch, max_len, "meta", kv_repeat=kv_repeat,
                           kv_quant=kv_quant)
        specs = sh.batch_shardings({"cache": whole}, mesh.shape,
                                   global_batch=batch)["cache"]

        def zeros_block(t, spec):
            if isinstance(t, dict):
                return {k: zeros_block(t[k], spec[k]) for k in t}
            shape = sh.block(t, spec, mesh).shape
            return torch.zeros(shape, dtype=t.dtype, device=device)

        return zeros_block(whole, specs)
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
