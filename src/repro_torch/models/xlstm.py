"""xLSTM blocks — the JAX package's ``models/xlstm.py``: mLSTM (matrix
memory, 2x expansion) and sLSTM (scalar memory with head-wise recurrent
gating).  Training differentiates ``mlstm_fwd``/``slstm_fwd`` with
autograd through the token loops (each step makes new states; nothing
writes in place).

Both use exponential gating with the max-stabilizer state m (xLSTM paper,
arXiv:2405.04517).  The recurrences run token by token, as the JAX
package's ``lax.scan`` does, with the states in f32: ``C`` (B,nh,dh,dh),
``n`` (B,nh,dh), ``m`` (B,nh) for the mLSTM and ``h``, ``c``, ``n``,
``m`` (B,nh,dh) for the sLSTM.  The gate and recurrent matrices (``w_i``,
``w_f``, ``w_x``, ``r``) are read in f32, as the JAX package reads them.

On a ``(data, model)`` mesh (``mesh=``, ``model`` > 1) a rank holds
JAX's blocks (``runtime/sharding.py``) and computes its heads:

* mLSTM.  ``w_up`` (d, 2 inner) is cut over ``"model"`` as one block
  (so at model 2 rank 0 holds u's columns and rank 1 z's); the rank's
  product is re-blocked to its inner blocks of u and z by one exchange
  (``mesh.model_halves``, as mamba's), and u's blocks are gathered whole
  over ``"model"`` (``mesh.model_gather``: ``w_q``/``w_k``/``w_v``, cut
  by their output columns, take the whole u); no rank receives z's other
  blocks.  Its columns of the q, k,
  v products are whole heads (``n_heads`` must divide the model axis).
  ``w_i``/``w_f`` are row-parallel: the rank's partial gates are summed
  over ``"model"``; ``b_i``/``b_f`` are the rank's heads.  The
  token-by-token recurrence runs on the rank's heads with no collective
  inside the loop; the norm over the whole inner width sums the squares
  over ``"model"`` in f32; ``w_down`` is row-parallel, then the
  ``"model"`` sum.  JAX's cache holds ``C`` (B, nh, dh, dh) cut on its
  key dimension and ``n``, ``m`` whole: the prefill re-blocks its final
  ``C`` from heads to key blocks with one all-to-all and gathers ``n``
  and ``m``, once at the end; the decode gathers the new token's q, k, v
  and gates over ``"model"`` (small), updates the key blocks of ``C``
  and the whole ``n``, ``m`` on every rank, and sums the partial
  numerators over ``"model"``.
* sLSTM.  ``w_x`` (d, 4d) and ``b_x`` are cut contiguously, and the
  pre-activations are head-major (each head's z, i, f, o side by side),
  so the rank's block is its whole heads with all four gates and the
  recurrence is head-parallel; the recurrent ``r``, whole on every rank,
  is read for the rank's heads (``model_copy``: its gradient summed over
  ``"model"``).  JAX's cache holds ``h``, ``c``, ``n``, ``m`` whole: they
  are gathered over ``"model"`` at the prefill's end and after each
  decode step.  The norm over d sums its squares over ``"model"``;
  ``w_out`` is row-parallel, then the ``"model"`` sum.

Heads that do not divide ``"model"`` (xlstm-125m's 4 at model 16) run
whole on every rank (:func:`heads_whole`), from JAX's blocks at rest.
The mLSTM's ``w_q``/``w_k``/``w_v`` are cut by columns, mid-head (96 of
a head's 384 at model 16): each rank computes its column blocks of q, k
and v from the whole u and gathers them over ``"model"``
(``mesh.model_unshard``, whose backward takes the rank's block of a
gradient every rank holds alike); the gates are the ``"model"`` sum of
the row-parallel partial products (``w_i``/``w_f``), ``b_i``/``b_f`` are
whole.  The recurrence then runs on every head with no collective
inside the loop, and the norm, the gate and ``w_down`` read the rank's
inner block of its output (``mesh.model_shard``, whose backward gathers
the blocks' gradients, so that the recurrence's backward runs on the
whole gradient alike on every rank).  The cache's ``C`` is JAX's key
block: every rank holds ``C`` whole after the prefill and keeps its
slice; the decode steps as above.  The sLSTM gathers its pre-activations
(B, S, 4d) f32 over ``"model"`` (the rank's block of ``w_x`` is a gate
of a head or less), runs every head with the whole ``r`` (its gradient
not summed over ``"model"``), and the norm and ``w_out`` read the rank's
block of d.  JAX's own design keeps the heads cut and sums the partial
numerators over each head's ranks every token; the whole heads keep the
collectives outside the token loops, at the price of every rank saving
every head's states for the backward (``PERF.md`` §6 has the peak).

On the meta device (the dry run) a token loop runs as two trips, the
first token's and one of B x (S - 1) rows for the rest
(:func:`_folded`): the operation counters see every trip's work, and
the dry run of a long sequence costs two trips' ops.

No Pallas kernel sits behind these blocks; the JAX package's docstring
names a chunked ``mlstm_fwd_chunked`` that it does not have, so it has no
counterpart here.  ``mlstm_fwd`` and ``slstm_fwd`` record their token
recurrences in the cost book (``models/costbook.py``, JAX's labels,
totals and trips, on the rank's heads), and ``xlstm_flops`` is JAX's
analytic count.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import (model_copy, model_gather,
                                     model_halves, model_shard,
                                     model_split, model_sum, model_unshard)
from repro_torch.models import costbook
from repro_torch.models.layers import (dense_init, init_rmsnorm,
                                       log_sigmoid, rmsnorm)

_F32 = torch.float32


def heads_whole(cfg, mesh) -> bool:
    """Whether the mLSTM's and sLSTM's heads run whole on every rank of
    ``mesh``: its ``"model"`` axis is above 1 and does not divide the
    heads (xlstm-125m's 4 at model 16; the module docstring)."""
    return model_split(mesh) and cfg.n_heads % mesh.shape["model"] != 0


def _fold(x) -> bool:
    """Whether a token loop over ``x`` runs folded into two trips (the
    meta device: :func:`_folded`)."""
    return x.device.type == "meta" and x.shape[1] > 1


def _folded(step, carry0, inputs, S: int):
    """A token loop on the meta device in two trips: the first token's
    from the zero states, as the loop's first trip, then the other S - 1
    tokens' as one trip over (B (S - 1), ...) rows from the first trip's
    states repeated, so that the operation counters of the dry run see
    every trip's products and elementwise work (each op of a step is
    linear in its rows, and the states take gradients in every trip but
    the first, as in the loop); returns (the final states (B, ...), the
    outputs (B, S, ...)).  The shapes follow the loop's; the meta device
    holds no values to be wrong."""
    B = inputs[0].shape[0]
    carry, h0 = step(carry0, [a[:, 0] for a in inputs])
    rest = [a[:, 1:].reshape((B * (S - 1),) + tuple(a.shape[2:]))
            for a in inputs]
    carry, h = step(tuple(c.repeat_interleave(S - 1, 0) for c in carry),
                    rest)
    carry = tuple(c.view((B, S - 1) + tuple(c.shape[1:]))[:, -1]
                  for c in carry)
    h = h.view((B, S - 1) + tuple(h.shape[1:]))
    return carry, torch.cat([h0[:, None], h], dim=1)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(generator, cfg) -> dict:
    d = cfg.d_model
    inner = 2 * d
    nh = cfg.n_heads
    dev = generator.device
    return {
        "w_up": dense_init(generator, (d, 2 * inner)),     # -> (u, z)
        "w_q": dense_init(generator, (inner, inner)),
        "w_k": dense_init(generator, (inner, inner)),
        "w_v": dense_init(generator, (inner, inner)),
        "w_i": dense_init(generator, (inner, nh), scale=0.02),
        "b_i": torch.zeros((nh,), dtype=_F32, device=dev),
        "w_f": dense_init(generator, (inner, nh), scale=0.02),
        "b_f": torch.full((nh,), 3.0, dtype=_F32, device=dev),  # forget-open
        "norm": init_rmsnorm(inner, dev),
        "w_down": dense_init(generator, (inner, d)),
    }


def _norm(params, h, eps: float, width: int, mesh):
    """:func:`rmsnorm` over ``width`` features of which ``h`` holds the
    rank's block on a mesh: the squares summed over ``"model"`` in f32,
    the rank's block of the scale."""
    if not model_split(mesh):
        return rmsnorm(params, h, eps)
    x = h.float()
    ss = model_copy(mesh, model_sum(mesh, x.square().sum(-1, keepdim=True)))
    x = x * torch.rsqrt(ss / width + eps)
    return (x * params["scale"]).to(h.dtype)


def _mlstm_qkvgates(params, x, cfg, mesh=None):
    """q, v in the compute dtype; k in f32 (the JAX package divides the
    product by ``np.sqrt(dh)``, a float64 scalar that is not weakly typed,
    so k comes out f32 under bf16: here the product cast to f32 over an
    f32 sqrt(dh) on the device, a true division, where a Python scalar on
    CUDA would multiply by its reciprocal); the gates ``it``, ``ft``
    (B,S,nh) in f32.  On a mesh: the rank's heads of each, or every head
    where the heads run whole (:func:`heads_whole`), and its inner block
    of z (module docstring)."""
    dtype = x.dtype
    inner = 2 * cfg.d_model
    nh = cfg.n_heads
    dh = inner // nh
    w_up = params["w_up"].to(dtype)
    if model_split(mesh):
        u_own, z = model_halves(mesh, model_copy(mesh, x) @ w_up).chunk(
            2, -1)
        u = model_gather(mesh, u_own)
    else:
        u, z = (x @ w_up).chunk(2, dim=-1)                  # (B,S,inner)
        u_own = u
    B, S, _ = u.shape
    qkv = [u @ params[name].to(dtype) for name in ("w_q", "w_k", "w_v")]
    whole = heads_whole(cfg, mesh)
    if whole:
        # the rank's column blocks, which cut the heads: gathered whole
        qkv = model_unshard(mesh, torch.stack(qkv), -1).unbind(0)
    nh_l = qkv[0].shape[-1] // dh
    q, k, v = (t.reshape(B, S, nh_l, dh) for t in qkv)
    k = k.float()
    k = k / k.new_full((), math.sqrt(dh))
    uf = u_own.float()
    it, ft = uf @ params["w_i"], uf @ params["w_f"]          # (B,S,nh)
    if whole:
        gates = model_sum(mesh, torch.cat([it, ft], -1))
        it, ft = gates[..., :nh], gates[..., nh:]
    elif model_split(mesh):
        gates = model_copy(mesh, model_sum(mesh, torch.cat([it, ft], -1)))
        lo = mesh.axis_index("model") * nh_l
        it = gates[..., lo:lo + nh_l]
        ft = gates[..., nh + lo:nh + lo + nh_l]
    return q, k, v, it + params["b_i"], ft + params["b_f"], z


def _mlstm_inputs(params, x, cfg, mesh=None):
    """The step's inputs for every token at once (elementwise, so the
    same values as the JAX package's inside its scan): q, k, v (B,S,nh,dh)
    in f32, it and log sigmoid(ft) (B,S,nh); and z (the rank's heads and
    inner block on a mesh)."""
    q, k, v, it, ft, z = _mlstm_qkvgates(params, x, cfg, mesh)
    return (q.float(), k, v.float(), it, log_sigmoid(ft)), z


def _mlstm_gates(m, it, logf):
    m_new = torch.maximum(logf + m, it)
    return m_new, torch.exp(it - m_new), torch.exp(logf + m - m_new)


def _mlstm_step(carry, inp):
    """carry: (C (B,nh,dh,dh), n (B,nh,dh), m (B,nh)); one token's
    inputs from :func:`_mlstm_inputs`."""
    C, n, m = carry
    qf, kf, vf, it, logf = inp                 # (B,nh,dh) x3, (B,nh) x2
    m_new, i_p, f_p = _mlstm_gates(m, it, logf)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * kf
    num = torch.einsum("bhde,bhd->bhe", C, qf)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qf).abs(),
                        torch.exp(-m_new))[..., None]
    return (C, n, m_new), num / den


def _mlstm_out(params, h, z, cfg, mesh):
    """The norm over the inner width, the gate and ``w_down``; h and z
    (B, S, inner) or the rank's inner blocks (h whole where the heads run
    whole: its block taken here)."""
    if heads_whole(cfg, mesh):
        h = model_shard(mesh, h, -1)
    h = _norm(params["norm"], h, cfg.norm_eps, 2 * cfg.d_model, mesh) * \
        F.silu(z)
    out = h @ params["w_down"].to(h.dtype)
    return model_sum(mesh, out) if model_split(mesh) else out


def _mlstm(params, x, cfg, mesh=None):
    """The token-by-token scan from zero states on the rank's heads (every
    head where they run whole): (out, (C, n, m))."""
    B, S, d = x.shape
    dtype = x.dtype
    inp, z = _mlstm_inputs(params, x, cfg, mesh)
    nh_l, dh = inp[0].shape[2], inp[0].shape[3]
    carry = (x.new_zeros((B, nh_l, dh, dh), dtype=_F32),
             x.new_zeros((B, nh_l, dh), dtype=_F32),
             x.new_zeros((B, nh_l), dtype=_F32))
    if _fold(x):
        carry, h = _folded(_mlstm_step, carry, inp, S)
    else:
        hs = []
        for t in range(S):
            carry, h = _mlstm_step(carry, [a[:, t] for a in inp])
            hs.append(h)
        h = torch.stack(hs, dim=1)
    h = h.reshape(B, S, nh_l * dh).to(dtype)
    return _mlstm_out(params, h, z, cfg, mesh), carry


def mlstm_fwd(params, x, cfg, mesh=None):
    out, (C, _, _) = _mlstm(params, x, cfg, mesh)
    B, S = x.shape[:2]
    nh, dh = C.shape[1], C.shape[2]
    costbook.record("mlstm_scan", total_flops=6.0 * B * S * nh * dh * dh,
                    total_bytes=8.0 * B * S * nh * dh * dh, trips=S)
    return out


def mlstm_prefill(params, x, cfg, mesh=None):
    """(out, cache); on a mesh the cache is the rank's block of JAX's:
    ``C`` by key blocks over ``"model"`` (heads whole), re-blocked from
    the rank's heads with one all-to-all (gathered by heads where the key
    dimension does not divide the axis), ``n`` and ``m`` whole.  Where
    the heads run whole every rank holds them all: its key block of ``C``
    is a slice, and nothing is moved."""
    out, (C, n, m) = _mlstm(params, x, cfg, mesh)
    if model_split(mesh):
        M = mesh.shape["model"]
        dh = C.shape[-1]
        split = dh % M == 0 and dh >= M
        if heads_whole(cfg, mesh):
            if split:
                kb = dh // M
                C = C[:, :, mesh.axis_index("model") * kb:][:, :, :kb]
        else:
            C = mesh.all_to_all(C, "model", 2, 1) if split else \
                mesh.all_gather(C, "model", dim=1)
            nm = mesh.all_gather(torch.cat([n, m[..., None]], -1),
                                 "model", dim=1)
            n, m = nm[..., :-1], nm[..., -1]
    return out, {"C": C, "n": n, "m": m}


def mlstm_decode(params, x, cfg, cache, mesh=None):
    """One token against the cache.  On a mesh the cache is the rank's
    block of JAX's (``C``'s key block, whole ``n``, ``m``): the rank's
    heads of the token's q, k, v and gates are gathered over ``"model"``
    (every rank computes every head's where the heads run whole), every
    rank updates its key block of ``C`` and the whole ``n`` and ``m`` for
    every head, and the partial numerators over the key blocks are summed
    over ``"model"``."""
    B = x.shape[0]
    dtype = x.dtype
    inp, z = _mlstm_inputs(params, x, cfg, mesh)
    if not model_split(mesh):
        (C, n, m), h = _mlstm_step((cache["C"], cache["n"], cache["m"]),
                                   [a[:, 0] for a in inp])
        h = h.reshape(B, 1, 2 * cfg.d_model).to(dtype)
        return _mlstm_out(params, h, z, cfg, mesh), {"C": C, "n": n, "m": m}
    qf, kf, vf, it, logf = (a[:, 0] for a in inp)
    dh = qf.shape[2]
    whole = heads_whole(cfg, mesh)
    if not whole:
        got = mesh.all_gather(torch.cat([qf, kf, vf, it[..., None],
                                         logf[..., None]], -1), "model",
                              dim=1)
        qf, kf = got[..., :dh], got[..., dh:2 * dh]
        vf = got[..., 2 * dh:3 * dh]
        it, logf = got[..., 3 * dh], got[..., 3 * dh + 1]
    C, n, m = cache["C"], cache["n"], cache["m"]
    kb = C.shape[-2]                              # the rank's key rows
    lo = mesh.axis_index("model") * kb if kb < dh else 0
    m_new, i_p, f_p = _mlstm_gates(m, it, logf)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (
        kf[..., lo:lo + kb, None] * vf[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * kf
    num = torch.einsum("bhde,bhd->bhe", C, qf[..., lo:lo + kb])
    if kb < dh:
        num = mesh.all_reduce_sum(num, "model")
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qf).abs(),
                        torch.exp(-m_new))[..., None]
    h = (num / den).reshape(B, 1, -1).to(dtype)
    if not whole:             # the rank's heads: its inner block
        w = z.shape[-1]
        h = h[..., mesh.axis_index("model") * w:][..., :w]
    return _mlstm_out(params, h, z, cfg, mesh), {"C": C, "n": n,
                                                 "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(generator, cfg) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    dev = generator.device
    zeros = torch.zeros((d,), dtype=_F32, device=dev)
    return {
        "w_x": dense_init(generator, (d, 4 * d)),        # z,i,f,o pre-acts
        "b_x": torch.cat([zeros, zeros, torch.full_like(zeros, 3.0), zeros]),
        "r": dense_init(generator, (nh, dh, 4 * dh),     # head-wise
                        scale=1.0 / math.sqrt(dh)),
        "norm": init_rmsnorm(d, dev),
        "w_out": dense_init(generator, (d, d)),
    }


def _slstm_step(r, carry, xproj):
    """carry: (h, c, n, m) each (B,nh,dh); xproj: (B,4 nh dh) input
    pre-activation; r: (nh,dh,4dh) the heads' recurrent matrices."""
    h, c, n, m = carry
    B, nh, dh = h.shape
    rec = torch.einsum("bhd,hde->bhe", h, r)                 # (B,nh,4dh)
    pre = xproj.reshape(B, nh, 4 * dh) + rec
    zt, it, ft, ot = pre.chunk(4, dim=-1)                   # (B,nh,dh)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    logf = log_sigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(logf + m - m_new)
    c = f_p * c + i_p * zt
    n = f_p * n + i_p
    return ot * c / n.clamp_min(1e-6), c, n, m_new


def _slstm_in(params, x, cfg, mesh):
    """The rank's input pre-activations (B, S, 4 nh_l dh) in f32 and its
    heads' recurrent matrices (every head without a mesh, and where the
    heads run whole: the rank's block of the pre-activations, a gate of a
    head or less, gathered whole)."""
    r = params["r"]
    if not model_split(mesh):
        return x.float() @ params["w_x"] + params["b_x"], r
    xp = model_copy(mesh, x).float() @ params["w_x"] + params["b_x"]
    if heads_whole(cfg, mesh):
        return model_unshard(mesh, xp, -1), r
    nh_l = params["w_x"].shape[1] // (4 * r.shape[1])
    lo = mesh.axis_index("model") * nh_l
    return xp, model_copy(mesh, r)[lo:lo + nh_l]


def _slstm_out(params, h, cfg, mesh):
    """The norm over d and ``w_out``; h the rank's heads (every head where
    they run whole: its block of d taken here)."""
    if heads_whole(cfg, mesh):
        h = model_shard(mesh, h, -1)
    h = _norm(params["norm"], h, cfg.norm_eps, cfg.d_model, mesh)
    out = h @ params["w_out"].to(h.dtype)
    return model_sum(mesh, out) if model_split(mesh) else out


def _gather_states(cfg, mesh, states):
    """The rank's heads of (h, c, n, m) gathered whole over ``"model"``
    in one collective (held whole already where the heads run whole)."""
    if not model_split(mesh) or heads_whole(cfg, mesh):
        return states
    return mesh.all_gather(torch.stack(states), "model", dim=2).unbind(0)


def _slstm_loop_step(r):
    def step(carry, inp):
        carry = _slstm_step(r, carry, inp[0])
        return carry, carry[0]
    return step


def _slstm(params, x, cfg, mesh=None):
    """The token-by-token scan from zero states on the rank's heads (every
    head where they run whole): (out, (h, c, n, m))."""
    B, S, d = x.shape
    dtype = x.dtype
    xp, r = _slstm_in(params, x, cfg, mesh)                  # (B,S,4d)
    zero = x.new_zeros((B, r.shape[0], r.shape[1]), dtype=_F32)
    carry = (zero, zero, zero, zero)
    if _fold(x):
        carry, h = _folded(_slstm_loop_step(r), carry, [xp], S)
    else:
        hs = []
        for t in range(S):
            carry = _slstm_step(r, carry, xp[:, t])
            hs.append(carry[0])
        h = torch.stack(hs, dim=1)
    h = h.reshape(B, S, -1).to(dtype)
    return _slstm_out(params, h, cfg, mesh), carry


def slstm_fwd(params, x, cfg, mesh=None):
    out, (h, _, _, _) = _slstm(params, x, cfg, mesh)
    B, S = x.shape[:2]
    nh, dh = h.shape[1], h.shape[2]
    costbook.record("slstm_scan", total_flops=2.0 * B * S * nh * dh * 4 * dh,
                    total_bytes=4.0 * B * S * nh * dh, trips=S)
    return out


def slstm_prefill(params, x, cfg, mesh=None):
    """(out, cache); on a mesh the states gathered whole over
    ``"model"`` (JAX's cache holds them whole)."""
    out, states = _slstm(params, x, cfg, mesh)
    h, c, n, m = _gather_states(cfg, mesh, states)
    return out, {"h": h, "c": c, "n": n, "m": m}


def slstm_decode(params, x, cfg, cache, mesh=None):
    """One token; on a mesh the rank's heads of the whole states step
    (every head where they run whole), and the new states are gathered
    whole again."""
    B = x.shape[0]
    dtype = x.dtype
    xp, r = _slstm_in(params, x, cfg, mesh)
    nh_l = r.shape[0]
    lo = mesh.axis_index("model") * nh_l if model_split(mesh) and \
        not heads_whole(cfg, mesh) else 0
    states = tuple(cache[k][:, lo:lo + nh_l] for k in ("h", "c", "n", "m"))
    new = _slstm_step(r, states, xp[:, 0])
    h = _slstm_out(params, new[0].reshape(B, 1, -1).to(dtype), cfg, mesh)
    h_new, c, n, m = _gather_states(cfg, mesh, new)
    return h, {"h": h_new, "c": c, "n": n, "m": m}


def xlstm_flops(cfg, n_tokens: int, kind: str) -> float:
    """JAX's analytic flops of an mLSTM (``kind`` "mlstm") or sLSTM block
    over ``n_tokens``: its products and its recurrence."""
    d = cfg.d_model
    nh = cfg.n_heads
    if kind == "mlstm":
        inner = 2 * d
        dh = inner // nh
        proj = 2.0 * n_tokens * d * (2 * inner) + \
            2.0 * n_tokens * inner * (3 * inner + d)
        rec = 6.0 * n_tokens * nh * dh * dh
        return proj + rec
    dh = d // nh
    proj = 2.0 * n_tokens * d * 4 * d + 2.0 * n_tokens * d * d
    rec = 2.0 * n_tokens * nh * dh * 4 * dh
    return proj + rec
