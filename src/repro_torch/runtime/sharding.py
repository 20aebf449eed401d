"""The row layout every stage of the distributed pipeline shares, and
the partition rules of the sharded trainer.

Each stage (the KNN ring, calibration, symmetrization, the sampler build)
shards its N rows the same way: N is padded up to a multiple of the
shard count P, and shard s owns the contiguous block of
``rows_per_shard(N, P)`` rows starting at ``s * rows_per_shard(N, P)``,
so a local row l is global row ``s * rows_per_shard + l``.  One layout
across stages means a stage's output block is the next stage's input
block, with no repartitioning between them.

The LM rules are the JAX package's (``runtime/sharding.py``): FSDP over
``"data"``, tensor parallelism over ``"model"``, every proposed axis
dropped where the dimension does not divide over it.  They take the
mesh's axis sizes as a mapping, JAX's ``mesh.shape`` (``DataMesh.shape``
in the port), and a spec is a tuple of an axis name, a tuple of names or
None per dimension, JAX's ``PartitionSpec``.  The serving layouts are
JAX's too: ``_cache_pspec`` (a decode cache batch-sharded over the DP
axes, or its sequence over ``"data"`` when the batch does not cover them;
heads, or else the head dimension, over ``"model"``) and
``out_shardings_for``.  :func:`block` cuts a rank's block out of a whole
tensor by its spec (:func:`blocks_of`, of every parameter of a tree),
and :func:`assemble` puts the ranks' blocks back together.

JAX's activation policy and ``constrain_*`` have no counterpart: they are
XLA trace-time hints, and a port rank holds its own rows by
construction.
"""
from __future__ import annotations

import functools
import re
from typing import Mapping, Optional

import torch


def rows_per_shard(n: int, n_shards: int) -> int:
    """Rows each shard owns after padding ``n`` to a shard multiple."""
    return -(-n // max(1, n_shards))


def pad_rows(x: torch.Tensor, n_shards: int, fill=0) -> torch.Tensor:
    """``x`` with axis 0 padded to ``rows_per_shard(n, P) * P`` rows of
    ``fill``, on x's device."""
    n = x.shape[0]
    n_pad = rows_per_shard(n, n_shards) * n_shards - n
    if n_pad == 0:
        return x
    return torch.cat([x, x.new_full((n_pad,) + tuple(x.shape[1:]), fill)])


def shard_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of the GLOBAL row array ``x`` (padded with zeros
    to the mesh's layout), on the mesh's device.

    Every sharded stage takes its rows this way, and so does a resumed
    one: stage checkpoints hold global arrays, so a resuming process
    takes its block for whatever shard count its own mesh has, not only
    the one that wrote the checkpoint."""
    n_loc = rows_per_shard(x.shape[0], mesh.size)
    lo = mesh.rank * n_loc
    if lo + n_loc <= x.shape[0]:              # a block with no padding
        return x[lo:lo + n_loc].to(mesh.device)
    return pad_rows(x, mesh.size)[lo:lo + n_loc].to(mesh.device)


# ---------------------------------------------------------------------------
# The LM partition rules
# ---------------------------------------------------------------------------

def _axis_size(sizes: Mapping, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _axis_size(sizes, n)
        return out
    return sizes[name] if name in sizes else 0


def _guard(sizes: Mapping, shape, spec) -> tuple:
    """``spec`` with each axis that is absent, or does not divide its
    dimension, replaced by None; a tuple of one name is the name, as in
    JAX's ``PartitionSpec``."""
    out = []
    for dim, ax in zip(shape, spec):
        size = _axis_size(sizes, ax) if ax is not None else 0
        if isinstance(ax, tuple) and len(ax) == 1:
            ax = ax[0]
        out.append(ax if size and dim % size == 0 and dim >= size else None)
    return tuple(out)


def dp_axes(sizes: Mapping) -> tuple:
    return ("pod", "data") if "pod" in sizes else ("data",)


def fsdp_axis(sizes: Mapping, train: bool):
    return "data" if train else None


_RULES = [
    # (regex on the "/"-joined path, proposal builder given ndim)
    (r"(embed|lm_head)/table$", lambda nd: ["model", "fsdp"]),
    (r"dec_pos$|enc_pos$", lambda nd: ["fsdp", None]),
    (r"attn/w[qkv]$|xattn/w[qkv]$", lambda nd: ["fsdp", "model", None]),
    (r"attn/wo$|xattn/wo$", lambda nd: ["model", None, "fsdp"]),
    (r"attn/b[qkv]$", lambda nd: ["model", None]),
    (r"mlp/w_(gate|up)$", lambda nd: ["fsdp", "model"]),
    (r"mlp/w_down$", lambda nd: ["model", "fsdp"]),
    (r"mlp/b_up$", lambda nd: ["model"]),
    (r"mlp/b_down$", lambda nd: [None]),
    (r"moe/router$", lambda nd: ["fsdp", None]),
    (r"moe/w_(gate|up)$", lambda nd: ["expert", "fsdp", "model"]),
    (r"moe/w_down$", lambda nd: ["expert", "model", "fsdp"]),
    (r"mamba/w_in$", lambda nd: ["fsdp", "model"]),
    (r"mamba/conv_w$", lambda nd: [None, "model"]),
    (r"mamba/conv_b$|mamba/d_skip$|mamba/dt_bias$", lambda nd: ["model"]),
    (r"mamba/w_[bc]$|mamba/a_log$|mamba/w_dt_down$",
     lambda nd: ["model", None]),
    (r"mamba/w_dt_up$", lambda nd: [None, "model"]),
    (r"mamba/w_out$", lambda nd: ["model", "fsdp"]),
    (r"core/w_up$|core/w_x$", lambda nd: ["fsdp", "model"]),
    (r"core/w_[qkv]$", lambda nd: [None, "model"]),
    (r"core/w_[if]$", lambda nd: ["model", None]),
    (r"core/b_[ifx]$", lambda nd: ["model"]),
    (r"core/r$", lambda nd: [None, None, None]),
    (r"core/w_down$|core/w_out$", lambda nd: ["model", "fsdp"]),
    (r"core/norm/scale$", lambda nd: ["model"]),
]

_LAYER_LISTS = ("enc_layers", "dec_layers")     # the encoder-decoder's


def jax_path(name: str, period: int) -> tuple[str, bool]:
    """(the JAX path, whether JAX stacks the leaf) of the port's parameter
    ``name`` (``named_parameters``), in ``convert.lm_params_to_numpy``'s
    layout: layer ``li`` of ``blocks`` is period ``li // period`` of
    ``blocks/pos{li % period}``, and the encoder-decoder's layer lists are
    JAX's ``enc_layers``/``dec_layers``, stacked over the layers."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return "/".join(["blocks", f"pos{int(parts[1]) % period}"]
                        + parts[2:]), True
    if parts[0] in _LAYER_LISTS:
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


def param_pspec(path: str, shape, sizes: Mapping, *, train: bool,
                stacked: bool) -> tuple:
    """The spec of one parameter leaf at ``path`` ("/"-joined); a
    ``stacked`` leaf carries a leading period axis, never sharded."""
    shape = tuple(shape)
    fsdp = fsdp_axis(sizes, train)
    body = shape[1:] if stacked else shape
    proposal: Optional[list] = None
    for pat, builder in _RULES:
        if re.search(pat, path):
            proposal = builder(len(body))
            break
    if proposal is None or len(proposal) != len(body):
        proposal = [None] * len(body)
    resolved = []
    for ax in proposal:
        if ax == "fsdp":
            resolved.append(fsdp)
        elif ax == "expert":
            # EP: experts over "data" at inference (no FSDP there);
            # during training "data" is taken by FSDP, so E is replicated
            resolved.append(None if train else "data")
        else:
            resolved.append(ax)
    spec = _guard(sizes, body, resolved)
    return (None,) + spec if stacked else spec


def params_shardings(params, cfg, sizes: Mapping, *, train: bool) -> dict:
    """{name: spec} of every parameter of the port's module tree, in
    ``named_parameters`` order.  Each leaf is named by its JAX path
    (:func:`jax_path`); a port layer is one period of JAX's stacked leaf,
    so its spec is JAX's without the leading None."""
    period = len(cfg.block_pattern)
    return {name: param_pspec(jax_path(name, period)[0], p.shape, sizes,
                              train=train, stacked=False)
            for name, p in params.named_parameters()}


def data_dim(spec) -> Optional[int]:
    """The dimension a spec shards over ``"data"``, or None."""
    for d, ax in enumerate(spec):
        if ax == "data" or (isinstance(ax, tuple) and "data" in ax):
            return d
    return None


@functools.lru_cache(maxsize=32)
def _train_specs(cfg, data: int, model: int) -> tuple:
    from repro_torch.models.factory import param_shapes

    whole = param_shapes(cfg)
    specs = params_shardings(whole, cfg, {"data": data, "model": model},
                             train=True)
    return tuple((n, tuple(p.shape), specs[n])
                 for n, p in whole.named_parameters())


def train_specs(cfg, sizes: Mapping) -> dict:
    """{name: (whole shape, spec)} of every parameter of ``cfg`` by the
    training rules (JAX's ``params_shardings(train=True)``), in
    ``named_parameters`` order; made once a config and mesh shape."""
    return {n: (shape, spec) for n, shape, spec in
            _train_specs(cfg, sizes["data"], sizes["model"])}


def owned_blocks(params, cfg, mesh) -> list:
    """The mesh rank's block of each parameter (``parameters()`` order)
    under its training spec (:func:`train_specs`): None for a leaf the
    spec keeps whole, else a flat tuple of one ``(dim, start, length)``
    triple a cut dimension, ``"data"`` by the data axis's size and the
    rank's index on it, ``"model"`` likewise.  ``params`` may hold whole
    leaves or the rank's blocks."""
    specs = train_specs(cfg, mesh.shape)
    out = []
    for name, _ in params.named_parameters():
        shape, spec = specs[name]
        cuts = ()
        for d, ax in enumerate(spec):
            if ax is None:
                continue
            names = ax if isinstance(ax, tuple) else (ax,)
            n, idx = 1, 0
            for a in names:
                idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
                n *= mesh.axis_size(a)
            if n > 1:
                b = shape[d] // n
                cuts += (d, idx * b, b)
        out.append(cuts or None)
    return out


def block_of(t: torch.Tensor, block) -> torch.Tensor:
    """The view of a whole ``t`` that an :func:`owned_blocks` entry names
    (``t`` itself for None)."""
    for i in range(0, len(block or ()), 3):
        t = t.narrow(*block[i:i + 3])
    return t


def row_dim(name: str, shape) -> Optional[int]:
    """The dimension of a parameter whose rule proposes FSDP (the one its
    training spec shards over ``"data"`` wherever the data axis divides
    it), or None: the rows by which the gradient norm is summed
    (``optim/adamw.py``), whatever the mesh."""
    spec = param_pspec(name.replace(".", "/"), shape, {"data": 1,
                                                       "model": 1},
                       train=True, stacked=False)
    return data_dim(spec)


def _walk(tree, fn, path=""):
    """``fn(path, leaf)`` over a nested dict (or tuple) of leaves, the
    "/"-joined path as JAX's ``_path_str`` spells it (a tuple's index as
    a number)."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, fn, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, _shape(tree))


def _shape(leaf) -> tuple:
    """The shape of a tensor, an array or a shape."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def covers_dp(sizes: Mapping, global_batch: int) -> bool:
    """Whether ``global_batch`` rows shard over the DP axes (JAX's
    ``batch_first``); otherwise a decode cache is sequence-parallel."""
    dp_size = 1
    for a in dp_axes(sizes):
        dp_size *= sizes[a]
    return global_batch % dp_size == 0 and global_batch >= dp_size


def batch_shardings(batch: Mapping, sizes: Mapping, *,
                    global_batch: int) -> dict:
    """{name: spec} of a batch (nested where the batch nests): tokens,
    labels, positions and encoder frames over the DP axes along their rows
    when the batch covers them, whole otherwise; a decode cache's leaves by
    :func:`_cache_pspec`, batch- or sequence-sharded."""
    dp = dp_axes(sizes)
    batch_first = covers_dp(sizes, global_batch)

    def one(s, shape):
        if "cache" in s:
            return _cache_pspec(s, shape, sizes, batch_first)
        if len(shape) >= 1 and batch_first:
            spec = [dp] + [None] * (len(shape) - 1)
        else:
            spec = [None] * len(shape)
        return _guard(sizes, shape, spec)

    return _walk(dict(batch), one)


def _cache_pspec(s: str, shape, sizes: Mapping, batch_first: bool) -> tuple:
    """The spec of a cache leaf at path ``s``, stacked over the periods
    (n_periods, B, ...), JAX's rules: attention ``k``/``v`` and their
    scales (n_periods, B, T, KVH, hd) batch-sharded when the batch covers
    the DP axes, else their sequence over ``"data"`` (SP); the heads over
    ``"model"`` when they divide it, else the head dimension.  mamba
    ``ssm``/``conv`` and the mLSTM's ``C`` shard their inner dimension over
    ``"model"``; the other recurrent states and ``encoder_out`` (B, F, d)
    only their batch."""
    dp = dp_axes(sizes)
    model = max(_axis_size(sizes, "model"), 1)
    bdp = dp if batch_first else None
    shape = tuple(shape)
    if s.endswith("encoder_out"):
        return _guard(sizes, shape, [bdp, None, None])
    if s.endswith("/k") or s.endswith("/v") or s.endswith("_scale"):
        heads = shape[3] % model == 0
        if batch_first:
            return _guard(sizes, shape, [None, dp, None, "model", None]
                          if heads else [None, dp, None, None, "model"])
        return _guard(sizes, shape, [None, None, "data", "model", None]
                      if heads else [None, None, "data", None, "model"])
    if s.endswith("/ssm"):
        return _guard(sizes, shape, [None, bdp, "model", None])
    if s.endswith("/conv"):
        return _guard(sizes, shape, [None, bdp, None, "model"])
    if s.endswith("/C"):
        return _guard(sizes, shape, [None, bdp, None, "model", None])
    return _guard(sizes, shape, [None, bdp] + [None] * (len(shape) - 2))


def out_shardings_for(kind: str, sizes: Mapping, *,
                      global_batch: int) -> tuple:
    """The loss: a replicated scalar, ``()``.  Logits (B, V): ``(dp,
    "model")``, unguarded, as JAX's."""
    dp = dp_axes(sizes)
    if kind == "loss":
        return ()
    return (dp[0] if len(dp) == 1 else dp, "model")


# ---------------------------------------------------------------------------
# A rank's block of a whole tensor, and the whole tensor from the blocks
# ---------------------------------------------------------------------------

def _coords(rank: int, sizes: Mapping) -> dict:
    """Mesh rank ``rank``'s index along each axis (row-major, JAX's
    device order: the last axis fastest)."""
    out, rest = {}, rank
    for name in reversed(list(sizes)):
        out[name] = rest % sizes[name]
        rest //= sizes[name]
    return out


def _slices(shape, spec, sizes: Mapping, rank: int) -> tuple:
    """The index of mesh rank ``rank``'s block of a whole ``shape``."""
    at = _coords(rank, sizes)
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(slice(None))
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        n, idx = 1, 0
        for a in names:
            idx = idx * sizes[a] + at[a]
            n *= sizes[a]
        b = dim // n
        out.append(slice(idx * b, (idx + 1) * b))
    return tuple(out)


def block_shape(shape, spec, sizes: Mapping) -> tuple:
    """The shape of every rank's block of a whole ``shape`` under
    ``spec`` (JAX's per-device shard shape)."""
    return tuple(d if ax is None else d // _axis_size(sizes, ax)
                 for d, ax in zip(shape, spec))


def block(x, spec, mesh):
    """Mesh rank ``mesh.rank``'s block of the whole tensor (or array)
    ``x`` under ``spec`` (a view where the tensor allows)."""
    return x[_slices(x.shape, spec, mesh.shape, mesh.rank)]


def blocks_of(tree: Mapping, mesh, prefix: str = "", *,
              stacked: bool, train: bool = False) -> dict:
    """The rank's blocks of every leaf of a nested dict of parameters
    (tensors or arrays) at JAX path ``prefix``, by the inference rules
    (``param_pspec(train=False)``), or the training rules under ``train``
    (FSDP over ``"data"``, experts whole).  ``stacked``: the tree is JAX's,
    whose leaves under ``blocks/`` and the layer lists carry a leading
    layer axis, never cut.  A cut tensor is copied, so that the whole leaf
    can be freed."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out[k] = blocks_of(v, mesh, path, stacked=stacked, train=train)
            continue
        lead = stacked and ("blocks/" in path or "_layers/" in path)
        spec = param_pspec(path, v.shape, mesh.shape, train=train,
                           stacked=lead)
        b = block(v, spec, mesh)
        cut = torch.is_tensor(v) and b.numel() < v.numel()
        out[k] = b.clone() if cut else b
    return out


def gather_tree(mesh, tree, cfg, *, to_host: bool = False,
                bucket: int = 1 << 26):
    """A module tree of the parameters' structure (the parameters or a
    moment) whose leaves are the rank's training blocks
    (:func:`train_specs`), with every leaf gathered whole over the mesh,
    the blocks in buckets of whole leaves of at most ``bucket`` elements
    a rank, one collective a bucket (host copies under ``to_host``); a
    leaf already whole is taken as it is.  A collective: every rank of
    the mesh calls it."""
    from repro_torch.models.lm import map_tree

    specs = train_specs(cfg, mesh.shape)
    wholes, todo = {}, []
    for name, t in tree.named_parameters():
        shape, spec = specs[name]
        if tuple(t.shape) == shape:
            wholes[id(t)] = t.detach().cpu() if to_host else t.detach()
        else:
            todo.append((t, spec))

    def flush(group):
        parts = mesh.all_gather_list(torch.cat(
            [t.detach().reshape(-1) for t, _ in group]))
        off = 0
        for t, spec in group:
            n = t.numel()
            w = assemble([p[off:off + n].view(t.shape) for p in parts],
                         spec, mesh.shape)
            wholes[id(t)] = w.cpu() if to_host else w
            off += n

    group, size = [], 0
    for t, spec in todo:
        if group and size + t.numel() > bucket:
            flush(group)
            group, size = [], 0
        group.append((t, spec))
        size += t.numel()
    if group:
        flush(group)
    return map_tree(lambda t: wholes[id(t)], tree)


def gather(mesh, t, spec):
    """The whole tensor of which ``t`` is this rank's block under
    ``spec``: every rank's block gathered over the mesh and assembled (a
    collective: every rank of the mesh calls it)."""
    return assemble(mesh.all_gather_list(t.contiguous()), spec, mesh.shape)


def assemble(blocks: list, spec, sizes: Mapping):
    """The whole tensor (or array) from every mesh rank's block under
    ``spec``, the blocks in mesh rank order; a replicated dimension is
    taken from the first rank that holds each block."""
    first = blocks[0]
    shape = list(first.shape)
    for d, ax in enumerate(spec):
        if ax is not None:
            shape[d] *= _axis_size(sizes, ax)
    if torch.is_tensor(first):
        whole = first.new_empty(shape)
    else:
        import numpy as np
        whole = np.empty(shape, dtype=first.dtype)
    for r, b in enumerate(blocks):
        whole[_slices(shape, spec, sizes, r)] = b
    return whole
