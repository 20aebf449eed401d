"""Decoder-only LM assembly: embed -> blocks -> norm -> head.

The JAX package's ``models/lm.py``.  The parameters are an
``nn.Module`` tree that mirrors the JAX pytree (``embed``,
``final_norm``, ``blocks``, ``lm_head`` when untied), except that
``blocks`` is an ``nn.ModuleList`` of the ``n_layers`` blocks in order
where JAX stacks each block position of the pattern over the periods
(``convert.py`` carries one into the other).  A block is attention
(``attn``), a mamba layer (``mamba``), each followed by ``ln2`` and an
``mlp`` or, at the pattern's MoE positions, a ``moe``; or an mLSTM or
sLSTM ``core``, which carries its own projections and has no ``ln2`` and
no MLP.  The parameters are made frozen (``requires_grad`` False); the
trainer (``launch/steps.py``) turns their gradients on.  The
encoder-decoder is ``models/encdec.py``.

Modes: ``lm_loss`` (train: ``lm_backbone`` with each period's blocks
recomputed in the backward, as JAX's ``jax.checkpoint`` of the period),
``lm_prefill`` (full sequence -> last logits + cache) and ``lm_decode``
(one token per row against the cache, updated in place).
The cache is JAX's: ``{"pos{p}": {...}}`` for each block position p of
the pattern, each leaf stacked over the periods (layer ``li`` is period
``li // P`` of position ``li % P``): attention ``"k", "v"[, "k_scale",
"v_scale"]`` (n_periods, B, T_p, KVH * kv_repeat, hd) (scales (..., 1)),
a local layer's T_p its window once the sequence reaches it; mamba
``"ssm"`` (n_periods, B, inner, state) f32 and ``"conv"`` (n_periods, B,
K-1, inner); mLSTM ``"C"``, ``"n"``, ``"m"`` and sLSTM ``"h"``, ``"c"``,
``"n"``, ``"m"`` in f32.

On a ``(data, model)`` mesh (``mesh=``, a ``launch/mesh.DataMesh``) a
rank holds its blocks of the weights (:func:`init_lm` or
``convert.lm_params_from_numpy`` with the mesh, JAX's inference rules)
and of the cache (``sharding._cache_pspec``), and takes its rows of the
batch: ``lm_prefill`` and ``lm_decode`` run the vocab-parallel embedding,
the rank's heads and ff slices with their ``"model"`` sums, the
expert-parallel MoE, and return the rank's vocab shard of the logits.  A
batch that does not cover ``"data"`` is sequence-parallel: every rank
holds all rows, and the attention caches their sequence blocks.

Training on a mesh (``lm_loss(..., mesh=)``), a rank holds its blocks by
JAX's training rules (``init_lm(..., train=True)``: FSDP over
``"data"``, heads, ff and vocab over ``"model"``, experts whole).  The
embedding's leaves are gathered over ``"data"`` before the lookup, each
period's just before the period (kept for its recompute under ``remat``,
so a period is gathered once a microbatch), the final norm's and the
head's after the last; each gather is one collective whose backward
reduce-scatters the gradients in rank order
(``launch/mesh.gather_data``).  The blocks run tensor-parallel
under autograd: ``model_copy`` where a replicated activation enters the
rank's slice of the work, ``model_sum`` after a row-parallel product,
and the loss is the vocab-parallel cross-entropy
(``layers.cross_entropy_sharded``): the rank's logits are never
gathered.  The mamba, mLSTM and sLSTM blocks run on the rank's inner
blocks or heads (``models/ssm.py``, ``models/xlstm.py``), serving and
training alike, or whole on every rank where the heads (the inner width)
do not divide ``"model"``.  With ``mesh=None`` the path is the one-device
path.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import gather_data, model_copy, model_split
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm, xlstm
from repro_torch.models.layers import (cross_entropy, cross_entropy_sharded,
                                       embed, embed_sharded, init_embedding,
                                       init_mlp, init_rmsnorm, mlp,
                                       mlp_sharded, rmsnorm, unembed)
from repro_torch.runtime import sharding as sh

ATTN_KINDS = ("attn", "local", "global")
# the recurrent cores: (fwd, prefill, decode); prefill and decode return
# (out, state)
RECURRENT = {"mlstm": (xlstm.mlstm_fwd, xlstm.mlstm_prefill,
                       xlstm.mlstm_decode),
             "slstm": (xlstm.slstm_fwd, xlstm.slstm_prefill,
                       xlstm.slstm_decode)}
BLOCK_KINDS = ATTN_KINDS + ("mamba",) + tuple(RECURRENT)


def check_supported(cfg) -> None:
    """Raise for a block kind the model code does not know (every kind of
    the JAX package's architectures serves)."""
    for kind in cfg.block_pattern:
        if kind not in BLOCK_KINDS:
            raise ValueError(f"{cfg.name}: block kind {kind!r}, expected "
                             f"one of {BLOCK_KINDS}")


def check_mesh(cfg, mesh) -> None:
    """Raise for what the sharded serving and training paths do not run
    at ``model`` > 1: an mLSTM/sLSTM whose widths (the mLSTM's inner 2d,
    the sLSTM's d) do not divide the model axis, and an attention head
    dimension that does not (``attention.check_mesh_heads``).  Query
    heads that do not divide are run whole on every rank
    (``attention.heads_whole``), and so are the mLSTM's and sLSTM's heads
    (``xlstm.heads_whole``) and a mamba inner width (``ssm``)."""
    if mesh is None or mesh.shape["model"] == 1:
        return
    M = mesh.shape["model"]
    kinds = set(cfg.block_pattern)
    if kinds & {"mlstm", "slstm"} and cfg.d_model % M:
        raise ValueError(f"{cfg.name}: the mLSTM/sLSTM width "
                         f"{cfg.d_model} does not divide over model={M}")
    if kinds & set(ATTN_KINDS) or cfg.is_encoder_decoder:
        attn.check_mesh_heads(cfg, M)


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
    parameters take no gradients (``module.requires_grad_(True)`` turns
    them on, as the trainer does)."""
    if isinstance(tree, list):
        return nn.ModuleList([as_module(t) for t in tree])
    tensors = [torch.is_tensor(v) for v in tree.values()]
    if all(tensors):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    if any(tensors):
        return ParamTree(tree)
    return nn.ModuleDict({k: as_module(v) for k, v in tree.items()})


def map_tree(fn, module) -> nn.Module:
    """A new module tree of ``fn(leaf)`` for every parameter of a tree
    made by :func:`as_module`, in its structure and order (so that its
    ``parameters()`` pair up with the original's)."""
    def walk(m):
        if torch.is_tensor(m):
            return fn(m)
        if isinstance(m, nn.ModuleList):
            return [walk(c) for c in m]
        return {k: walk(v) for k, v in m.items()}

    return as_module(walk(module))


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


def cast_tree(tree: dict, cfg) -> dict:
    """A nested dict of weights with its matrices cast to the compute
    dtype by ``factory.cast_for_inference``'s rule
    (``factory.keeps_f32``)."""
    from repro_torch.models.factory import keeps_f32

    return {k: cast_tree(v, cfg) if isinstance(v, dict) else
            v if keeps_f32(k, v) else v.to(cfg.dtype)
            for k, v in tree.items()}


def init_lm(generator: torch.Generator, cfg, mesh=None, *,
            train: bool = False, inference: bool = False) -> nn.ModuleDict:
    """Random f32 master weights on ``generator.device``, with the JAX
    init's distributions (not its numbers: the generators differ).  With
    a ``mesh``, the rank's blocks of the same weights (JAX's inference
    rules, or its training rules under ``train``), each cut as soon as its
    block is drawn: a rank holds one whole block at most beside its own
    blocks.  ``inference`` casts each block as it is cut
    (:func:`cast_tree`), so that no f32 copy of the whole model is ever
    held: the weights ``factory.cast_for_inference`` would leave."""
    check_supported(cfg)
    check_mesh(cfg, mesh)
    P = len(cfg.block_pattern)

    def cut(tree, prefix):
        if mesh is not None:
            tree = sh.blocks_of(tree, mesh, prefix, stacked=False,
                                train=train)
        return cast_tree(tree, cfg) if inference else tree

    tree = {"embed": cut(init_embedding(generator, cfg.vocab_size,
                                        cfg.d_model), "embed"),
            "final_norm": init_rmsnorm(cfg.d_model, generator.device),
            "blocks": [cut(init_block(generator, cfg, li % P),
                           f"blocks/pos{li % P}")
                       for li in range(cfg.n_layers)]}
    if not cfg.tie_embeddings:
        tree["lm_head"] = cut(init_embedding(generator, cfg.vocab_size,
                                             cfg.d_model), "lm_head")
    return as_module(tree)


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------

def apply_block(cfg, p: int, params, x, *, mode: str, cache=None,
                position=None, attn_impl: str = "auto", kv_repeat: int = 1,
                kv_quant: bool = False, mesh=None, sp_len=None):
    """Block position ``p`` of the pattern; returns (x, cache entry, aux),
    as the JAX package's: the cache entry None under ``mode="fwd"`` (the
    training forward), aux the MoE block's load-balance loss there and 0.0
    otherwise (a float: no device allocation on the serving path).  An
    attention decode writes the cache in place and returns it; a
    recurrent decode returns new states (``lm_decode`` copies them in).

    With a ``mesh`` the block is the rank's share: the recurrent blocks
    run on the rank's inner blocks or heads (``ssm``, ``xlstm``); attention
    runs on the rank's heads (and its cache blocks when serving:
    ``sp_len`` marks a sequence-parallel prefill or decode), the MLP
    column- then row-parallel; the MoE is expert-parallel when serving
    (``moe.moe_apply_sharded``) and, in the training forward, runs every
    expert on the rank's ff slice (``moe.moe_apply_tp``).  In training the
    weights are the period's gathered leaves (:func:`lm_loss`)."""
    kind = cfg.block_pattern[p]
    if mode not in ("fwd", "prefill", "decode"):
        raise ValueError(f"apply_block: mode {mode!r}, expected fwd|"
                         "prefill|decode")
    aux = 0.0
    new_cache = None
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if kind in RECURRENT:
        fwd, prefill, decode = RECURRENT[kind]
        if mode == "fwd":
            a = fwd(params["core"], h, cfg, mesh=mesh)
        elif mode == "prefill":
            a, new_cache = prefill(params["core"], h, cfg, mesh=mesh)
        else:
            a, new_cache = decode(params["core"], h, cfg, cache, mesh=mesh)
        return x + a, new_cache, aux
    if kind == "mamba":
        if mode == "fwd":
            a = ssm.mamba_fwd(params["mamba"], h, cfg, mesh=mesh)
        elif mode == "prefill":
            a, new_cache = ssm.mamba_prefill(params["mamba"], h, cfg,
                                             mesh=mesh)
        else:
            a, new_cache = ssm.mamba_decode(params["mamba"], h, cfg, cache,
                                            mesh=mesh)
    elif mode == "fwd":
        a = attn.attention_fwd(params["attn"], h, cfg, kind=kind,
                               impl=attn_impl, mesh=mesh)
    elif mode == "prefill":
        a, new_cache = attn.attention_prefill(
            params["attn"], h, cfg, kind=kind, impl=attn_impl,
            kv_repeat=kv_repeat, kv_quant=kv_quant, mesh=mesh,
            seq_parallel=sp_len is not None)
    else:
        a, new_cache = attn.attention_decode(params["attn"], h, cfg, cache,
                                             position, kind=kind, mesh=mesh,
                                             sp_len=sp_len)
    x = x + a
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    if "moe" in params and mesh is not None and mode != "fwd":
        m, _ = moe_lib.moe_apply_sharded(params["moe"], h, cfg, mesh,
                                         batch_first=sp_len is None)
    elif "moe" in params:
        m, moe_aux = moe_lib.moe_apply_tp(params["moe"], h, cfg, mesh)
        if mode == "fwd":
            aux = moe_aux
    elif mesh is not None:
        m = mlp_sharded(params["mlp"], h, cfg.mlp_type, cfg.d_ff, mesh)
    else:
        m = mlp(params["mlp"], h, cfg.mlp_type)
    return x + m, new_cache, aux


# ---------------------------------------------------------------------------
# Full stacks
# ---------------------------------------------------------------------------

def _embed_in(emb, cfg, tokens, mesh=None):
    """The embedding ``emb`` (``params["embed"]``) of ``tokens``."""
    if model_split(mesh):
        x = embed_sharded(emb, tokens, cfg.dtype, cfg.vocab_size, mesh)
    else:
        x = embed(emb, tokens, cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                             device=x.device)
    return x


def _logits(params, cfg, x):
    table = params["embed"]["table"] if cfg.tie_embeddings else \
        params["lm_head"]["table"]
    return unembed({}, x, table=table)


def gathered(mesh, specs, items: list) -> list:
    """The modules of ``items`` (``(name prefix, module)`` pairs; the
    prefix "" for a whole tree) with their leaves gathered whole over
    ``"data"`` in one collective (``launch/mesh.gather_data``, under
    autograd), each as a nested dict (a list where the module is a list),
    each leaf's dimension read off ``specs`` (``sharding.train_specs``).
    The modules themselves without a mesh or on a data axis of one."""
    if mesh is None or mesh.shape["data"] == 1:
        return [m for _, m in items]
    keys, leaves, dims = [], [], []
    for i, (prefix, module) in enumerate(items):
        for n, t in module.named_parameters():
            keys.append((i, n))
            leaves.append(t)
            dims.append(sh.data_dim(specs[f"{prefix}.{n}" if prefix
                                          else n][1]))
    out = [{} for _ in items]
    for (i, n), t in zip(keys, gather_data(mesh, leaves, dims)):
        node = out[i]
        *up, leaf = n.split(".")
        for u in up:
            node = node.setdefault(u, {})
        node[leaf] = t
    return [_lists(t) for t in out]


def _lists(tree):
    """A nested dict whose keys at a level are 0, 1, ... as a list."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def _period(cfg, blocks, x, attn_impl: str, mesh):
    """One period's blocks (gathered on a mesh) in the training forward:
    (x, summed aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, block in enumerate(blocks):
        x, _, a = apply_block(cfg, p, block, x, mode="fwd",
                              attn_impl=attn_impl, mesh=mesh)
        aux = aux + a
    return x, aux


def _backbone(params, cfg, tokens, attn_impl: str, remat: bool, mesh):
    """:func:`lm_backbone`, and the head's table (gathered on a mesh)."""
    check_supported(cfg)
    check_mesh(cfg, mesh)
    specs = None if mesh is None else sh.train_specs(cfg, mesh.shape)
    emb, = gathered(mesh, specs, [("embed", params["embed"])])
    x = _embed_in(emb, cfg, tokens, mesh)
    if not cfg.tie_embeddings:
        emb = None
    P = len(cfg.block_pattern)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks = list(params["blocks"])
    for li in range(0, cfg.n_layers, P):
        # gathered outside the checkpoint: its recompute reuses them
        period = gathered(mesh, specs, [(f"blocks.{li + j}", b) for j, b in
                                        enumerate(blocks[li:li + P])])
        if remat:
            x, a = checkpoint(_period, cfg, period, x, attn_impl, mesh,
                              use_reentrant=False)
        else:
            x, a = _period(cfg, period, x, attn_impl, mesh)
        aux = aux + a
    tail = [("final_norm", params["final_norm"])]
    if emb is None:
        tail.append(("lm_head", params["lm_head"]))
    got = gathered(mesh, specs, tail)
    table = emb["table"] if emb is not None else got[1]["table"]
    return rmsnorm(got[0], x, cfg.norm_eps), aux, table


def lm_backbone(params, cfg, tokens, *, attn_impl: str = "auto",
                remat: bool = False, mesh=None):
    """(B, S) tokens -> ((B, S, d) hidden states after the final norm,
    the periods' summed MoE aux loss).  ``remat`` recomputes each period
    in the backward (``torch.utils.checkpoint``, non-reentrant), the JAX
    package's ``jax.checkpoint`` of its scanned period: activations are
    kept at period boundaries only, and a training step runs each period's
    forward twice (flash forward launches too) and its backward once.
    With a ``mesh``, the rank's rows from its training blocks (the module
    docstring)."""
    x, aux, _ = _backbone(params, cfg, tokens, attn_impl, remat, mesh)
    return x, aux


def lm_loss(params, cfg, tokens, labels, *, attn_impl: str = "auto",
            aux_coef: float = 0.01, remat: bool = True, mesh=None):
    """Mean token cross-entropy (with z-loss) of the next-token labels,
    plus ``aux_coef * aux / n_periods`` for a MoE model, as the JAX
    package's ``lm_loss``; a 0-d f32 tensor.  With a ``mesh``, of the
    rank's rows from its training blocks: the same bits on every rank of
    a data row."""
    x, aux, table = _backbone(params, cfg, tokens, attn_impl, remat, mesh)
    if mesh is not None and table.shape[0] < cfg.vocab_size:
        loss = cross_entropy_sharded(
            unembed({}, model_copy(mesh, x), table=table), labels, mesh)
    else:
        loss = cross_entropy(unembed({}, x, table=table), labels)
    if cfg.n_experts:
        loss = loss + aux_coef * aux / max(cfg.n_periods, 1)
    return loss


@torch.no_grad()
def lm_prefill(params, cfg, tokens, *, attn_impl: str = "auto",
               kv_repeat: int = 1, kv_quant: bool = False, mesh=None,
               seq_parallel: bool = False):
    """tokens (B, S) -> (last-position logits (B, V) f32, cache).  With a
    ``mesh``: the rank's rows of tokens (all rows under
    ``seq_parallel``), its blocks of the weights; returns its vocab shard
    of the logits and its blocks of the cache."""
    check_supported(cfg)
    check_mesh(cfg, mesh)
    sp_len = tokens.shape[1] if mesh is not None and seq_parallel else None
    x = _embed_in(params["embed"], cfg, tokens, mesh)
    P = len(cfg.block_pattern)
    entries = [[] for _ in range(P)]
    for li, block in enumerate(params["blocks"]):
        x, c, _ = apply_block(cfg, li % P, block, x, mode="prefill",
                              attn_impl=attn_impl, kv_repeat=kv_repeat,
                              kv_quant=kv_quant, mesh=mesh, sp_len=sp_len)
        entries[li % P].append(c)
    x = rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps)
    cache = {f"pos{p}": {name: torch.stack([c[name] for c in cs])
                         for name in cs[0]}
             for p, cs in enumerate(entries)}
    return _logits(params, cfg, x), cache


@torch.no_grad()
def lm_decode(params, cfg, tokens, cache, position, *, mesh=None,
              sp_len=None):
    """tokens (B, 1); position (B,) index of the new token.  Updates
    ``cache`` in place (the new token's K and V, each recurrent layer's
    states); returns (logits (B, V), cache).  With a ``mesh``, the rank's
    rows, blocks and vocab shard as in :func:`lm_prefill`; ``sp_len``, the
    global length of a position-indexed cache, marks a sequence-parallel
    decode (all rows on every rank, the caches' sequence over
    ``"data"``)."""
    check_supported(cfg)
    check_mesh(cfg, mesh)
    x = _embed_in(params["embed"], cfg, tokens, mesh)
    P = len(cfg.block_pattern)
    for li, block in enumerate(params["blocks"]):
        layer = {name: t[li // P]
                 for name, t in cache[f"pos{li % P}"].items()}
        x, new, _ = apply_block(cfg, li % P, block, x, mode="decode",
                                cache=layer, position=position, mesh=mesh,
                                sp_len=sp_len)
        for name, t in new.items():
            if t is not layer[name]:
                layer[name].copy_(t)
    x = rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps)
    return _logits(params, cfg, x), cache
