"""Mixture-of-Experts with sort-based token dispatch — the JAX package's
``models/moe.py`` on one device (``_moe_apply_global`` ->
``_dispatch_and_compute``).

The routed (token, expert) pairs are argsorted by expert and gathered into
a padded (E, capacity, d) buffer, so the expert FFN is one batched product
over the expert axis; pairs past an expert's capacity are dropped.  The
router's aux loss is the Switch load-balance term E * sum_e f_e * p_e.

Orders, as JAX has them: the top-k is a stable descending sort (ties to
the lower expert, as ``lax.top_k``), the dispatch order a stable argsort
(as ``jnp.argsort``), and the combine adds each token's contributions from
zero in their sorted stream order in the compute dtype, as XLA applies
``zeros.at[t_s].add(...)``.  No atomics: the card gives the same sums
from run to run.  The gradient path is as ordered: the backward of each
gather is CUDA's sort-based accumulating ``index_put_``, and two training
steps of a MoE model on the card are bitwise equal (``chip_smoke.py``).

Not ported yet: the mesh-sharded dispatch (``_moe_apply_sharded``,
``_dispatch_ep_a2a``), which needs the LM partition specs (ROADMAP
Queue 1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_moe(generator, cfg) -> dict:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(generator, (d, E), scale=0.02),
        # expert arrays are (E, in, out): fan-in is axis 1, not axis 0
        "w_gate": dense_init(generator, (E, d, f), scale=1.0 / math.sqrt(d)),
        "w_up": dense_init(generator, (E, d, f), scale=1.0 / math.sqrt(d)),
        "w_down": dense_init(generator, (E, f, d), scale=1.0 / math.sqrt(f)),
    }


def capacity(n_tokens: int, n_experts: int, topk: int,
             factor: float = 1.25) -> int:
    c = int(math.ceil(n_tokens * topk * factor / n_experts))
    return max(8, int(math.ceil(c / 8)) * 8)


def route(params, xf, cfg):
    """Router: xf (T, d) -> (probs (T, E), top_p (T, K) renormalized,
    top_e (T, K)), in f32 on the f32 router."""
    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    sp, si = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.topk_experts
    top_p, top_e = sp[:, :K], si[:, :K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def moe_apply(params, x, cfg, capacity_factor: float = 1.25):
    """x: (B,S,d) -> (y (B,S,d) in x's dtype, aux loss f32 scalar)."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.topk_experts
    dtype = x.dtype
    dev = x.device
    xf = x.reshape(T, d)
    probs, top_p, top_e = route(params, xf, cfg)

    # ---- aux load-balance loss (Switch): E * sum_e f_e * p_e ----
    me = probs.mean(dim=0)
    fe = F.one_hot(top_e, E).float().sum(1).mean(dim=0) / K
    aux = E * (fe * me).sum()

    # ---- sort-based dispatch ----
    C = capacity(T, E, K, capacity_factor)
    e_flat = top_e.reshape(-1)
    t_flat = torch.arange(T, device=dev).repeat_interleave(K)
    w_flat = top_p.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_s, t_s = e_flat[order], t_flat[order]
    # rank within the expert's segment
    seg_starts = torch.searchsorted(e_s, torch.arange(E, device=dev))
    pos = torch.arange(T * K, device=dev) - seg_starts[e_s]
    keep = pos < C
    dest = torch.where(keep, e_s * C + pos, E * C)         # E*C: dropped

    gathered = torch.zeros((E * C + 1, d), dtype=dtype, device=dev)
    gathered[dest] = xf[t_s]
    g = gathered[:-1].view(E, C, d)

    # ---- expert FFN, batched over E; silu(x) = x * sigmoid(x) ----
    gate = torch.bmm(g, params["w_gate"].to(dtype))
    up = torch.bmm(g, params["w_up"].to(dtype))
    h = gate * torch.sigmoid(gate) * up
    out = torch.bmm(h, params["w_down"].to(dtype)).reshape(E * C, d)

    # ---- combine back: each token's K contributions in stream order ----
    contrib = torch.where(keep, w_flat[order], 0.0).to(dtype)
    picked = torch.where(keep[:, None], out[dest.clamp(max=E * C - 1)],
                         torch.zeros((), dtype=dtype, device=dev))
    upd = picked * contrib[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=dev)
    slots = inv.view(T, K).sort(dim=1).values
    y = torch.zeros((T, d), dtype=dtype, device=dev)
    for j in range(K):
        y = y + upd[slots[:, j]]
    return y.reshape(B, S, d), aux
