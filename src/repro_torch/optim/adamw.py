"""AdamW on the port's parameter tree — the JAX package's
``optim/adamw.py``.

The state is ``{"m", "v", "step"}``: ``m`` and ``v`` are module trees
of the parameters' structure (``lm.map_tree``), f32, zero at init, so a
moment pairs with its parameter in ``parameters()`` order and converts to
the JAX tree as the parameters do (``convert.opt_state_to_numpy``);
``step`` is an int32 0-d tensor.  Weight decay applies to every leaf,
norms and biases included, as in the JAX package.

:func:`adamw_update` follows JAX's arithmetic line by line, in f32, with
every division's divisor a tensor: in torch ``float / tensor`` is a
reciprocal and a product, and on CUDA a Python scalar divisor is a product
by its reciprocal (ROADMAP Queue 3), where JAX divides.  It updates the
parameters and the moments in place (the JAX package returns new trees)
and returns them.  The gradient norm sums the leaves in the order of the
parameters' names, not ``jax.tree.leaves``' (JAX stacks the layers), so it
agrees with JAX's within f32 rounding; a tree rebuilt from a checkpoint
(its dicts in another key order) gives the same bits as the tree it was
saved from, which a resumed run needs to be bitwise the uninterrupted one.

Under the sharded trainer (``launch/steps.py`` with a mesh) each rank
holds its blocks of the parameters, the gradients and the moments, by
each leaf's training spec over ``"data"`` and ``"model"``
(``sharding.train_specs``); the per-element arithmetic runs on the
blocks: element for element the bits of the one-device update.

The gradient norm (:func:`grad_norm`) sums each leaf's squares by the
rows of its FSDP dimension (``sharding.row_dim``; a leaf without one is
one row): each row's squares by halving (:func:`_tree_sums`, whose bits
depend on the row's length alone), a row cut over ``"model"`` added
over it in rank order, the rows of the ranks along ``"data"`` gathered
in order, the rows then halved to the leaf's sum, and the leaves added
in name order.  Every rank gets the same bits, and at ``model`` = 1 they
do not depend on the data axis (world 1 included): the trainer's world
P at one microbatch a rank is world 1 at P microbatches bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.lm import map_tree
from repro_torch.runtime import sharding as sh

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100


def adamw_init(params) -> dict:
    """Zero moments (f32, frozen) in the parameters' tree, each of its
    parameter's shape (a rank's blocks on a mesh); step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(params.parameters()).device)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``: ``lr * min(step / warmup, 1)``."""
    warm = step.to(_F32) / torch.tensor(float(max(cfg.warmup_steps, 1)),
                                        dtype=_F32, device=step.device)
    return cfg.lr * torch.clamp(warm, max=1.0)


# a tensor of more elements halves alone, one add a level; smaller ones
# of one row length halve together (their rows concatenated)
_ALONE = 1 << 16


def _halve(t: torch.Tensor) -> torch.Tensor:
    """(R, L) -> (R, L // 2): the first half plus the second, an odd last
    column added to the first."""
    h = t.shape[1] // 2
    s = t[:, :h] + t[:, h:2 * h]
    if t.shape[1] % 2:
        s[:, :1] += t[:, 2 * h:]
    return s


def _tree_sums(ts: list) -> list:
    """[(R_i, L_i)] -> [(R_i,)]: each row summed by halving
    (:func:`_halve` until one column), elementwise adds whose bits depend
    on the row's length alone, not on R_i, on the rows it is halved
    beside or on the device's reduction.  A large tensor halves alone
    until it is small; the small ones of one length then halve together,
    a few launches a length rather than a few a leaf."""
    small = []
    for t in ts:
        while t.shape[1] > 1 and t.numel() > _ALONE:
            t = _halve(t)
        small.append(t)
    by_len = {}
    for i, t in enumerate(small):
        by_len.setdefault(t.shape[1], []).append(i)
    out = [None] * len(ts)
    for idx in by_len.values():
        t = torch.cat([small[i] for i in idx]) if len(idx) > 1 else \
            small[idx[0]]
        while t.shape[1] > 1:
            t = _halve(t)
        for i, part in zip(idx, t[:, 0].split([small[i].shape[0]
                                               for i in idx])):
            out[i] = part
    return out


def _squares(name: str, g: torch.Tensor) -> torch.Tensor:
    """The f32 squares of ``g`` as (rows of its FSDP dimension, the rest
    of the leaf)."""
    sq = torch.square(g.to(_F32))
    d = sh.row_dim(name, g.shape)
    if d is None:
        return sq.reshape(1, -1)
    return sq.movedim(d, 0).reshape(sq.shape[d], -1)


def grad_norm(names, grads, *, mesh=None, specs=None) -> torch.Tensor:
    """The global gradient norm (the module docstring's order) of the
    gradients ``grads`` of the parameters ``names``: whole leaves, or on a
    ``mesh`` the rank's blocks under ``specs`` (one a leaf)."""
    order = sorted(range(len(names)), key=names.__getitem__)
    rows = _tree_sums([_squares(names[i], grads[i]) for i in order])
    if mesh is not None:
        spec = [specs[i] for i in order]
        part = [j for j, s in enumerate(spec) if mesh.shape["model"] > 1
                and any(ax == "model" for ax in s)]
        cut = [j for j, s in enumerate(spec) if mesh.shape["data"] > 1
               and sh.data_dim(s) is not None]
        with mesh.timed("grad_norm"):
            if part:
                flat = mesh.all_reduce_sum(torch.cat([rows[j] for j in part]),
                                           "model")
                for j, r in zip(part, flat.split([rows[j].numel()
                                                  for j in part])):
                    rows[j] = r
            if cut:
                parts = mesh.all_gather_list(
                    torch.cat([rows[j] for j in cut]), "data")
                off = 0
                for j in cut:
                    n = rows[j].numel()
                    rows[j] = torch.cat([p[off:off + n] for p in parts])
                    off += n
    total = None
    for leaf in _tree_sums([r.view(1, -1) for r in rows]):
        total = leaf[0] if total is None else total + leaf[0]
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: dict, *,
                 mesh=None, specs=None):
    """One AdamW step.  ``grads`` are the gradients in
    ``params.parameters()`` order (a sequence of tensors, or a module tree
    of the parameters' structure), of the leaves' shapes: whole, or on a
    ``mesh`` the rank's blocks, whose training specs ``specs`` (one a
    leaf) the gradient norm reads.  Updates ``params``, ``state["m"]``
    and ``state["v"]`` in place; returns (params, new state,
    {"grad_norm", "lr"})."""
    if isinstance(grads, torch.nn.Module):
        grads = list(grads.parameters())
    step = state["step"] + 1
    dev = step.device
    names = [n for n, _ in params.named_parameters()]
    gn = grad_norm(names, grads, mesh=mesh, specs=specs)
    clip = torch.tensor(cfg.grad_clip_norm, dtype=_F32, device=dev)
    scale = torch.clamp(clip / (gn + 1e-9), max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(_F32)
    bc2 = 1.0 - b2 ** step.to(_F32)
    for p, g, m, v in zip(params.parameters(), grads,
                          state["m"].parameters(), state["v"].parameters(),
                          strict=True):
        g = g.to(_F32) * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        mh = m / bc1
        vh = v / bc2
        upd = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p
        p.copy_((p - lr * upd).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gn, "lr": lr}
