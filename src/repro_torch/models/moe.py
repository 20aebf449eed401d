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

On a ``(data, model)`` mesh, :func:`moe_apply_sharded` is JAX's
``_moe_apply_sharded`` with ``_dispatch_ep_a2a``: experts over
``"data"`` (EP), their ff over ``"model"``, the route chosen by
:func:`moe_route`.  Training follows JAX's training rule instead
(:func:`moe_apply_tp`): every expert on every rank, its ff over
``"model"``, no all-to-all.
"""
from __future__ import annotations

import collections
import math

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import model_copy, model_sum
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


def _dispatch(params, xf, cfg, capacity_factor: float):
    """Route the tokens ``xf`` (T, d) and gather them into the padded
    (E, C, d) buffer of each expert's slots; returns (the buffer, what
    :func:`_combine` needs, the aux loss)."""
    T, d = xf.shape
    E, K = cfg.n_experts, cfg.topk_experts
    dev = xf.device
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

    gathered = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=dev)
    gathered[dest] = xf[t_s]
    return gathered[:-1].view(E, C, d), (order, keep, dest, w_flat), aux


def _experts(g, w_gate, w_up, w_down):
    """The expert FFN batched over the experts of ``g`` (E, C, d); silu(x)
    = x * sigmoid(x)."""
    dtype = g.dtype
    gate = torch.bmm(g, w_gate.to(dtype))
    up = torch.bmm(g, w_up.to(dtype))
    h = gate * torch.sigmoid(gate) * up
    return torch.bmm(h, w_down.to(dtype))


def _combine(out, state, T: int, K: int):
    """Each token's K contributions from ``out`` (E * C, d), added from
    zero in their sorted stream order."""
    order, keep, dest, w_flat = state
    EC, d = out.shape
    dtype, dev = out.dtype, out.device
    contrib = torch.where(keep, w_flat[order], 0.0).to(dtype)
    picked = torch.where(keep[:, None], out[dest.clamp(max=EC - 1)],
                         torch.zeros((), dtype=dtype, device=dev))
    upd = picked * contrib[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=dev)
    slots = inv.view(T, K).sort(dim=1).values
    y = torch.zeros((T, d), dtype=dtype, device=dev)
    for j in range(K):
        y = y + upd[slots[:, j]]
    return y


def moe_apply(params, x, cfg, capacity_factor: float = 1.25):
    """x: (B,S,d) -> (y (B,S,d) in x's dtype, aux loss f32 scalar)."""
    return moe_apply_tp(params, x, cfg, None, capacity_factor)


def moe_apply_tp(params, x, cfg, mesh, capacity_factor: float = 1.25):
    """:func:`moe_apply` on a rank of a ``(data, model)`` mesh in
    training, JAX's training rule: the experts whole on every rank (no
    all-to-all), ``w_gate``/``w_up`` the rank's ff columns and ``w_down``
    its ff rows.  The rank routes its own tokens at their capacity (a
    microbatch as on one device), runs every expert on its ff slice, and
    the partial outputs are summed over ``"model"`` in rank order; the
    dispatched slots take their gradient summed over ``"model"``
    (``model_copy``).  Weights whose ff is whole (or no mesh): the
    one-device MoE."""
    B, S, d = x.shape
    g, state, aux = _dispatch(params, x.reshape(B * S, d), cfg,
                              capacity_factor)
    E, C = g.shape[:2]
    split = mesh is not None and params["w_gate"].shape[2] < cfg.d_ff
    if split:
        g = model_copy(mesh, g)
    out = _experts(g, params["w_gate"], params["w_up"], params["w_down"])
    if split:
        out = model_sum(mesh, out)
    y = _combine(out.reshape(E * C, d), state, B * S, cfg.topk_experts)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# On a (data, model) mesh: JAX's _moe_apply_sharded and _dispatch_ep_a2a
# ---------------------------------------------------------------------------

ROUTES: collections.Counter = collections.Counter()   # route -> calls


def moe_route(cfg, t_loc: int, sizes, capacity_factor: float = 1.25, *,
              batch_first: bool = True) -> str:
    """The sharded MoE's route at inference, JAX's choice
    (``_moe_apply_sharded``): ``"local"`` when the experts do not divide
    over ``"data"`` (each rank holds them all); with experts over
    ``"data"`` (EP), ``"a2a"`` (the token slots go to their experts' ranks
    and back) when the slots' bytes ``2 E c_loc d 2`` are below the
    resident expert stack's ``3 E d ff 2 / M``, at ``c_loc =
    capacity(t_loc)`` of the rank's ``t_loc`` tokens, else ``"gather"``
    (the expert weights gathered over ``"data"``), which is also the route
    of a batch that does not cover ``"data"`` (every rank holds all rows,
    JAX's global path)."""
    D, M = sizes.get("data", 1), sizes.get("model", 1)
    E, d = cfg.n_experts, cfg.d_model
    if E % D or E < D:
        return "local"
    if not batch_first:
        return "gather"
    c_loc = capacity(max(t_loc, 1), E, cfg.topk_experts, capacity_factor)
    token_bytes = 2 * E * c_loc * d * 2
    weight_bytes = 3 * E * d * cfg.d_ff * 2 // max(1, M)
    return "gather" if token_bytes >= weight_bytes else "a2a"


def moe_apply_sharded(params, x, cfg, mesh, capacity_factor: float = 1.25,
                      *, batch_first: bool = True, mean_aux: bool = False):
    """:func:`moe_apply` on a rank of a ``(data, model)`` mesh at
    inference: x the rank's rows (all rows unless ``batch_first``), the
    expert weights its blocks (experts over ``"data"``, ff over
    ``"model"``).  The rank routes its own tokens at ``capacity(t_loc)``;
    by :func:`moe_route` the slots go to their experts' ranks by
    ``all_to_all`` over ``"data"`` and back, or the expert weights are
    gathered over ``"data"``.  The partial outputs of the ff slices are
    summed over ``"model"`` in rank order.  ``mean_aux``: the aux loss is
    the mean over the data ranks, added in rank order (else the rank's
    own).  The orders are :func:`moe_apply`'s, so two runs agree."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.topk_experts
    kind = moe_route(cfg, T, mesh.shape, capacity_factor,
                     batch_first=batch_first)
    ROUTES[kind] += 1
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if kind == "gather":
        wg, wu, wd = (mesh.all_gather(w, "data") for w in (wg, wu, wd))
    g, state, aux = _dispatch(params, x.reshape(T, d), cfg, capacity_factor)
    C = g.shape[1]
    if kind == "a2a":
        g = mesh.all_to_all(g, "data", 0, 1)     # (E/D, D*C, d)
    out = _experts(g, wg, wu, wd)
    if wg.shape[2] < cfg.d_ff:
        out = model_sum(mesh, out)
    if kind == "a2a":
        out = mesh.all_to_all(out, "data", 1, 0)     # (E, C, d)
    y = _combine(out.reshape(E * C, d), state, T, K)
    if mean_aux and mesh.shape["data"] > 1:
        aux = mesh.all_reduce_sum(aux.reshape(1), "data")[0] / \
            mesh.shape["data"]
    return y.reshape(B, S, d), aux


def moe_flops(cfg, n_tokens: int, capacity_factor: float = 1.25) -> float:
    """JAX's analytic flops of an MoE layer over ``n_tokens``: every
    expert's capacity of rows through its three matrices, and the
    router."""
    C = capacity(n_tokens, cfg.n_experts, cfg.topk_experts, capacity_factor)
    per_expert = 2.0 * 3 * C * cfg.d_model * cfg.d_ff
    router = 2.0 * n_tokens * cfg.d_model * cfg.n_experts
    return per_expert * cfg.n_experts + router
