"""The train step on one device — the JAX package's ``launch/steps.py``
(``pick_microbatches``, ``make_train_step``).

JAX builds a sharded, jitted step over a mesh; the port's step runs
eagerly on the parameters' device, so the mesh arguments, the shardings
and the argument specs have no counterpart here (the sharded trainer,
``make_prefill_step``, ``make_decode_step`` and ``make_step`` are ROADMAP
Queue 1 item 7 step 8).
"""
from __future__ import annotations

import torch

from repro_torch.models.factory import make_model
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def pick_microbatches(shape_cfg, *, tokens_budget: int = 8192) -> int:
    """The largest divisor of the batch that brings a microbatch's tokens
    under budget (activation memory is one microbatch's; gradients
    accumulate in f32 across microbatches).  One device: the whole batch
    is the device's."""
    per_dev_batch = max(1, shape_cfg.global_batch)
    target = max(1, per_dev_batch * shape_cfg.seq_len // tokens_budget)
    n = 1
    for cand in range(1, per_dev_batch + 1):
        if per_dev_batch % cand == 0 and cand <= target:
            n = cand
    return n


def _split(batch: dict, n: int, i: int) -> dict:
    """Microbatch ``i`` of ``n``: rows [i B/n, (i+1) B/n) of every leaf,
    JAX's reshape to (n, B/n, ...)."""
    out = {}
    for name, t in batch.items():
        if t.shape[0] % n:
            raise ValueError(f"make_train_step: batch leaf {name!r} has "
                             f"{t.shape[0]} rows, not a multiple of {n} "
                             "microbatches")
        b = t.shape[0] // n
        out[name] = t[i * b:(i + 1) * b]
    return out


def make_train_step(cfg, shape_cfg, *, opt_cfg: AdamWConfig = None,
                    microbatches: int = 0):
    """The step ``train_step(params, opt_state, batch) -> (params,
    opt_state, loss)``: the mean loss and gradients over
    ``microbatches`` microbatches (0: :func:`pick_microbatches`), summed
    in f32 in microbatch order and divided by their count, then one AdamW
    step, as JAX's step.  It turns the parameters' gradients on, updates
    them and the moments in place (``adamw_update``) and returns a 0-d f32
    loss."""
    opt_cfg = opt_cfg or AdamWConfig()
    loss_fn = make_model(cfg)["loss"]
    n_micro = microbatches or pick_microbatches(shape_cfg)

    def grads_of(params, plist, batch):
        loss = loss_fn(params, batch)
        gs = torch.autograd.grad(loss, plist, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(plist, gs)]

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        plist = list(params.parameters())
        if n_micro == 1:
            loss, grads = grads_of(params, plist, batch)
        else:
            dev = plist[0].device
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                    for p in plist]
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n_micro):
                loss_i, g = grads_of(params, plist,
                                     _split(batch, n_micro, i))
                gsum = [acc + gi.float() for acc, gi in zip(gsum, g)]
                lsum = lsum + loss_i
                del g
            n = torch.tensor(float(n_micro), dtype=torch.float32,
                             device=dev)
            grads = [g / n for g in gsum]
            loss = lsum / n
        params, opt_state, _ = adamw_update(opt_cfg, params, grads,
                                            opt_state)
        return params, opt_state, loss

    train_step.microbatches = n_micro
    return train_step
