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
owns a block of every leaf that its spec shards over ``"data"``
(``blocks``: one ``(dim, start, length)`` or None a parameter).  ``m``
and ``v`` then hold only those blocks, and the per-element arithmetic
runs on the block of the parameter and its gradient, views along that
dimension: element for element the bits of the one-device update.  A
leaf with no block is updated whole on every rank.  The gradient norm
is taken over the full gradients, as on one device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.lm import map_tree

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


def block_of(t: torch.Tensor, block) -> torch.Tensor:
    """The view of ``t`` that a block ``(dim, start, length)`` names (``t``
    itself for None)."""
    return t if block is None else t.narrow(*block)


def adamw_init(params, blocks=None) -> dict:
    """Zero moments (f32, frozen) in the parameters' tree, each of its
    block's shape when ``blocks`` is given; step 0."""
    plist = list(params.parameters())
    own = dict(zip(map(id, plist), blocks or [None] * len(plist)))
    zeros = lambda p: torch.zeros(block_of(p, own[id(p)]).shape,
                                  dtype=_F32, device=p.device)
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=plist[0].device)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``: ``lr * min(step / warmup, 1)``."""
    warm = step.to(_F32) / torch.tensor(float(max(cfg.warmup_steps, 1)),
                                        dtype=_F32, device=step.device)
    return cfg.lr * torch.clamp(warm, max=1.0)


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum over the leaves (tensors, in order) of their f32
    sums of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(_F32)))
                          for leaf in leaves))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: dict, *,
                 blocks=None):
    """One AdamW step.  ``grads`` are the whole gradients in
    ``params.parameters()`` order (a sequence of tensors, or a module tree
    of the parameters' structure).  Updates ``params``, ``state["m"]`` and
    ``state["v"]`` in place, each parameter only on its block when
    ``blocks`` is given; returns (params, new state, {"grad_norm",
    "lr"})."""
    if isinstance(grads, torch.nn.Module):
        grads = list(grads.parameters())
    step = state["step"] + 1
    dev = step.device
    names = [n for n, _ in params.named_parameters()]
    gn = global_norm([grads[i] for i in sorted(range(len(names)),
                                                 key=names.__getitem__)])
    clip = torch.tensor(cfg.grad_clip_norm, dtype=_F32, device=dev)
    scale = torch.clamp(clip / (gn + 1e-9), max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(_F32)
    bc2 = 1.0 - b2 ** step.to(_F32)
    blocks = blocks or [None] * len(names)
    for p, g, m, v, blk in zip(params.parameters(), grads,
                               state["m"].parameters(),
                               state["v"].parameters(), blocks, strict=True):
        p, g = block_of(p, blk), block_of(g, blk)
        g = g.to(_F32) * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        mh = m / bc1
        vh = v / bc2
        upd = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p
        p.copy_((p - lr * upd).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gn, "lr": lr}
