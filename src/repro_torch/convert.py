"""Carry state between the JAX package and the port: a fitted LargeVis
state, and an LM's parameters.

The state is a dict of numpy arrays (LargeVis's counterpart of model
weights): ``y``, ``knn_idx``, ``knn_dist``, ``weights``, ``x``, the edge
sampler's ``edge_src``/``edge_dst``/``edge_threshold``/``edge_alias`` and
the node sampler's ``node_threshold``/``node_alias``.

:func:`result_to_numpy` reads those fields off any result object that has
them (the port's :class:`LargeVisResult`, or the JAX package's, whose
arrays ``numpy.asarray`` accepts), and :func:`result_from_numpy` builds the
port's result on a device.  A round trip is bitwise.

:func:`lm_params_from_numpy` builds the port's LM parameters from the JAX
parameter pytree as numpy, and :func:`lm_params_to_numpy` gives it back.
JAX stacks each block position ``p`` of the pattern over the periods
along axis 0 (``blocks/pos{p}``); the port keeps the blocks in layer
order, layer ``period * P + p``.  Each block's tree is JAX's, whatever it
holds: ``attn`` (with ``qnorm``/``knorm`` under QK-norm) or ``mamba``,
and ``mlp`` or ``moe`` (``router`` (d, E), expert arrays
``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d)); or an mLSTM or
sLSTM ``core``.  The encoder-decoder's ``enc_layers`` and ``dec_layers``
are stacked over the layers in JAX and lists in layer order in the port.
A round trip is bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.largevis_default import LargeVisConfig
from repro_torch.core.largevis import LargeVisResult, resolve_device
from repro_torch.core.sampler import EdgeSampler, NodeSampler
from repro_torch.models import lm
from repro_torch.runtime import sharding as sh

_FIELDS = ("y", "knn_idx", "knn_dist", "weights", "x")
_EDGE = ("src", "dst", "threshold", "alias")
_NODE = ("threshold", "alias")
_LAYER_LISTS = ("enc_layers", "dec_layers")     # the encoder-decoder's


def _np(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def result_to_numpy(result) -> dict:
    """The fitted state of ``result`` as a dict of numpy arrays."""
    out = {f: _np(getattr(result, f)) for f in _FIELDS}
    out.update({f"edge_{f}": _np(getattr(result.edge_sampler, f))
                for f in _EDGE})
    out.update({f"node_{f}": _np(getattr(result.neg_sampler, f))
                for f in _NODE})
    return out


def result_from_numpy(arrays: dict, cfg: LargeVisConfig | None = None,
                      device="cuda") -> LargeVisResult:
    """The port's :class:`LargeVisResult` from a dict of numpy arrays."""
    dev = resolve_device(device)

    def t(name):
        return torch.from_numpy(np.array(arrays[name])).to(dev)

    n_nodes = int(arrays["y"].shape[0])
    edge = EdgeSampler(*(t(f"edge_{f}") for f in _EDGE),
                       n_edges=int(arrays["edge_src"].shape[0]))
    node = NodeSampler(*(t(f"node_{f}") for f in _NODE), n_nodes=n_nodes)
    return LargeVisResult(
        y=t("y"), knn_idx=t("knn_idx"), knn_dist=t("knn_dist"),
        weights=t("weights"), timings={}, edge_samples=0, x=t("x"),
        edge_sampler=edge, neg_sampler=node,
        cfg=cfg if cfg is not None else LargeVisConfig())


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_numpy(tree: dict, cfg, device="cuda", mesh=None, *,
                         train: bool = False):
    """The port's LM parameters (f32, as ``lm.init_lm`` makes them) from
    the JAX package's parameter pytree with numpy leaves (or tensors).
    With a ``mesh``, the rank's blocks of them by JAX's inference rules
    (``params_shardings(train=False)``: no FSDP, experts over ``"data"``),
    or under ``train`` its training rules (FSDP over ``"data"``, experts
    whole), each cut before it is copied to the device."""
    dev = resolve_device(device)
    lm.check_supported(cfg)
    lm.check_mesh(cfg, mesh)
    P = len(cfg.block_pattern)
    if mesh is not None:
        tree = sh.blocks_of(tree, mesh, stacked=True, train=train)

    def t(a):        # a tensor is taken as it is, not copied
        if torch.is_tensor(a):
            return a.to(device=dev, dtype=torch.float32)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    def layer(stacked, i):
        return _map(stacked, lambda a: t(a[i]))

    if cfg.is_encoder_decoder:          # stacked over the layers
        lists = {k: [layer(tree[k], i) for i in range(n)] for k, n in
                 zip(_LAYER_LISTS, (cfg.n_enc_layers, cfg.n_layers))}
    else:                               # per position, over the periods
        lists = {"blocks": [layer(tree["blocks"][f"pos{li % P}"], li // P)
                            for li in range(cfg.n_layers)]}
    out = {k: _map(v, t) for k, v in tree.items() if k not in lists}
    return lm.as_module({**out, **lists})


def lm_params_to_numpy(params, cfg) -> dict:
    """The JAX-layout parameter pytree (numpy leaves) of the port's LM
    parameters; weights cast for inference come back as f32."""
    P = len(cfg.block_pattern)

    def tree(m):
        if torch.is_tensor(m):     # a copy: a later step updates m in place
            x = m.detach().float()
            return x.numpy().copy() if x.device.type == "cpu" else \
                x.cpu().numpy()
        return {k: tree(v) for k, v in m.items()}

    if cfg.is_encoder_decoder:
        return {k: _stack([tree(b) for b in v]) if k in _LAYER_LISTS
                else tree(v) for k, v in params.items()}
    out = {k: tree(v) for k, v in params.items() if k != "blocks"}
    layers = [tree(b) for b in params["blocks"]]
    out["blocks"] = {
        f"pos{p}": _stack([layers[li] for li in range(p, cfg.n_layers, P)])
        for p in range(P)}
    return out


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def opt_state_to_numpy(state: dict, cfg) -> dict:
    """The JAX package's AdamW state ``{"m", "v", "step"}`` (numpy
    leaves) of the port's."""
    return {"m": lm_params_to_numpy(state["m"], cfg),
            "v": lm_params_to_numpy(state["v"], cfg),
            "step": np.asarray(_np(state["step"]), dtype=np.int32)}


def opt_state_from_numpy(tree: dict, cfg, device="cuda", mesh=None) -> dict:
    """The port's AdamW state from the JAX package's (numpy leaves, or a
    rank's blocks as tensors): the moments frozen f32 module trees,
    ``step`` an int32 0-d tensor.  With a ``mesh``, the rank's blocks of
    whole moments by the training rules."""
    dev = resolve_device(device)
    kw = {"mesh": mesh, "train": True}
    return {"m": lm_params_from_numpy(tree["m"], cfg, dev, **kw),
            "v": lm_params_from_numpy(tree["v"], cfg, dev, **kw),
            "step": torch.tensor(int(tree["step"]), dtype=torch.int32,
                                 device=dev)}


def train_state_to_numpy(params, opt_state: dict, cfg, mesh=None):
    """The trainer's checkpoint tree, the JAX trainer's: ``{"params":
    <JAX layout>, "opt": {"m", "v", "step"}}`` with numpy leaves.  With a
    ``mesh`` the parameters and moments are the rank's training blocks
    (or whole leaves), gathered whole leaf by leaf to the host
    (``sharding.gather_tree``): every rank of the mesh calls it, and
    every rank gets the tree of whole leaves, the same file whatever the
    mesh."""
    if mesh is not None and mesh.size > 1:
        params = sh.gather_tree(mesh, params, cfg, to_host=True)
        opt_state = dict(opt_state, **{
            k: sh.gather_tree(mesh, opt_state[k], cfg, to_host=True)
            for k in ("m", "v")})
    return {"params": lm_params_to_numpy(params, cfg),
            "opt": opt_state_to_numpy(opt_state, cfg)}
