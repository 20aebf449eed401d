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

No Pallas kernel sits behind these blocks; the JAX package's docstring
names a chunked ``mlstm_fwd_chunked`` that it does not have, so it has no
counterpart here.  The cost-book records wait for ``models/costbook.py``
(ROADMAP Queue 1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, init_rmsnorm,
                                       log_sigmoid, rmsnorm)

_F32 = torch.float32


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


def _mlstm_qkvgates(params, x, cfg):
    """q, v in the compute dtype; k in f32 (the JAX package divides the
    product by ``np.sqrt(dh)``, a float64 scalar that is not weakly typed,
    so k comes out f32 under bf16: here the product cast to f32 over an
    f32 sqrt(dh) on the device, a true division, where a Python scalar on
    CUDA would multiply by its reciprocal); the gates ``it``, ``ft``
    (B,S,nh) in f32."""
    dtype = x.dtype
    inner = 2 * cfg.d_model
    nh = cfg.n_heads
    dh = inner // nh
    u, z = (x @ params["w_up"].to(dtype)).chunk(2, dim=-1)   # (B,S,inner)
    B, S, _ = u.shape
    q = (u @ params["w_q"].to(dtype)).reshape(B, S, nh, dh)
    k = (u @ params["w_k"].to(dtype)).reshape(B, S, nh, dh).float()
    k = k / k.new_full((), math.sqrt(dh))
    v = (u @ params["w_v"].to(dtype)).reshape(B, S, nh, dh)
    uf = u.float()
    it = uf @ params["w_i"] + params["b_i"]                   # (B,S,nh)
    ft = uf @ params["w_f"] + params["b_f"]
    return q, k, v, it, ft, z


def _mlstm_inputs(params, x, cfg):
    """The step's inputs for every token at once (elementwise, so the
    same values as the JAX package's inside its scan): q, k, v (B,S,nh,dh)
    in f32, it and log sigmoid(ft) (B,S,nh); and z."""
    q, k, v, it, ft, z = _mlstm_qkvgates(params, x, cfg)
    return (q.float(), k, v.float(), it, log_sigmoid(ft)), z


def _mlstm_step(carry, inp):
    """carry: (C (B,nh,dh,dh), n (B,nh,dh), m (B,nh)); one token's
    inputs from :func:`_mlstm_inputs`."""
    C, n, m = carry
    qf, kf, vf, it, logf = inp                 # (B,nh,dh) x3, (B,nh) x2
    m_new = torch.maximum(logf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(logf + m - m_new)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * kf
    num = torch.einsum("bhde,bhd->bhe", C, qf)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qf).abs(),
                        torch.exp(-m_new))[..., None]
    return (C, n, m_new), num / den


def _mlstm(params, x, cfg):
    """The token-by-token scan from zero states: (out, (C, n, m))."""
    B, S, d = x.shape
    dtype = x.dtype
    inner = 2 * d
    nh = cfg.n_heads
    dh = inner // nh
    inp, z = _mlstm_inputs(params, x, cfg)
    carry = (x.new_zeros((B, nh, dh, dh), dtype=_F32),
             x.new_zeros((B, nh, dh), dtype=_F32),
             x.new_zeros((B, nh), dtype=_F32))
    hs = []
    for t in range(S):
        carry, h = _mlstm_step(carry, [a[:, t] for a in inp])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, inner).to(dtype)
    h = rmsnorm(params["norm"], h, cfg.norm_eps) * F.silu(z)
    return h @ params["w_down"].to(dtype), carry


def mlstm_fwd(params, x, cfg):
    return _mlstm(params, x, cfg)[0]


def mlstm_prefill(params, x, cfg):
    out, (C, n, m) = _mlstm(params, x, cfg)
    return out, {"C": C, "n": n, "m": m}


def mlstm_decode(params, x, cfg, cache):
    B = x.shape[0]
    dtype = x.dtype
    inp, z = _mlstm_inputs(params, x, cfg)
    (C, n, m), h = _mlstm_step((cache["C"], cache["n"], cache["m"]),
                               [a[:, 0] for a in inp])
    h = h.reshape(B, 1, 2 * cfg.d_model).to(dtype)
    h = rmsnorm(params["norm"], h, cfg.norm_eps) * F.silu(z)
    return h @ params["w_down"].to(dtype), {"C": C, "n": n, "m": m}


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


def _slstm_step(params, cfg, carry, xproj):
    """carry: (h, c, n, m) each (B,nh,dh); xproj: (B,4d) input
    pre-activation."""
    h, c, n, m = carry
    B = h.shape[0]
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    rec = torch.einsum("bhd,hde->bhe", h, params["r"])      # (B,nh,4dh)
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


def _slstm(params, x, cfg):
    """The token-by-token scan from zero states: (out, (h, c, n, m))."""
    B, S, d = x.shape
    dtype = x.dtype
    nh = cfg.n_heads
    xp = x.float() @ params["w_x"] + params["b_x"]           # (B,S,4d)
    zero = x.new_zeros((B, nh, d // nh), dtype=_F32)
    carry = (zero, zero, zero, zero)
    hs = []
    for t in range(S):
        carry = _slstm_step(params, cfg, carry, xp[:, t])
        hs.append(carry[0])
    h = torch.stack(hs, dim=1).reshape(B, S, d).to(dtype)
    h = rmsnorm(params["norm"], h, cfg.norm_eps)
    return h @ params["w_out"].to(dtype), carry


def slstm_fwd(params, x, cfg):
    return _slstm(params, x, cfg)[0]


def slstm_prefill(params, x, cfg):
    out, (h, c, n, m) = _slstm(params, x, cfg)
    return out, {"h": h, "c": c, "n": n, "m": m}


def slstm_decode(params, x, cfg, cache):
    B, _, d = x.shape
    dtype = x.dtype
    xp = x[:, 0].float() @ params["w_x"] + params["b_x"]
    h_new, c, n, m = _slstm_step(params, cfg, (cache["h"], cache["c"],
                                               cache["n"], cache["m"]), xp)
    h = rmsnorm(params["norm"], h_new.reshape(B, 1, d).to(dtype),
                cfg.norm_eps)
    return h @ params["w_out"].to(dtype), {"h": h_new, "c": c, "n": n,
                                           "m": m}
