"""Mamba (S6) selective state-space layer — the JAX package's
``models/ssm.py``.  Training differentiates ``mamba_fwd`` with autograd as
it stands (the doubling scan's ``cat`` and products save their inputs;
nothing here writes in place into a saved tensor).

Diagonal linear recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t with
input-dependent (selective) dt/B/C, run as a chunked scan: within a chunk
a log-depth scan of the combine (a1 a2, a2 b1 + b2) in torch ops, the
chunks chained with the f32 state carried.  The JAX package scans a chunk
with ``lax.associative_scan``, whose odd/even recursion multiplies in
another order, so the two agree within f32 rounding, not bitwise.  Decode
is one token's state update against the cache.

The chunk contract: a sequence longer than ``CHUNK`` tokens must be a
multiple of it (the JAX package's reshape refuses the rest);
:func:`check_chunks` raises.  The conv tail that prefill keeps for decode
is the last K-1 raw inputs, left-padded with zeros below K-1 tokens: the
context ``_causal_conv`` assumes without ``prev`` (the JAX package keeps
fewer rows there, ROADMAP Queue 3).

On a ``(data, model)`` mesh (``mesh=``, ``model`` > 1) a rank holds
JAX's blocks (``runtime/sharding.py``): ``w_in`` (d, 2 inner) cut over
``"model"`` along its last dimension as one block, and the rank's block of
the inner dimension of ``conv_w``, ``conv_b``, ``dt_bias``, ``d_skip``,
``a_log``, ``w_b``, ``w_c``, ``w_dt_down``, ``w_dt_up`` and ``w_out``
(and of the ``ssm``/``conv`` cache).  ``w_in``'s block is not the rank's
inner block of u and of z: at model 2 rank 0 holds all of u's columns
and rank 1 all of z's.  The rank re-blocks its product ``x @ w_in`` into
its inner blocks of u and z with one exchange of two pieces along
``"model"`` a layer (``launch/mesh.model_halves``; (B, S, 2 inner / M)
values a rank, the inverse exchange in the backward).  The other way,
holding u's and z's inner blocks of ``w_in`` instead of JAX's block,
moves about as many bytes once at load (a 33.5 MB block a layer at
jamba's d 4096, inner 8192, model 4, against 67 MB of bf16 activations
for 2 x 4096 tokens) but leaves the rank holding other weights than
JAX's at rest, so that checkpoints, the training blocks and the
optimizer's moments would need a second layout; the activations are
re-blocked instead (their cost on the card: ``model_exchange`` in the
timed collectives of ``tools/distributed_check.py --serve``).  The
selective products ``u @ w_dt_down``, ``u @ w_b`` and ``u @ w_c`` are
sums over inner: the rank's partial products of the whole sequence are
summed over ``"model"`` once, before the chunk loop, and the chunked scan
then runs on the rank's inner block with no collective.  ``w_out`` is
row-parallel, followed by the ``"model"`` sum.  An inner width that does
not divide ``"model"`` runs whole on every rank (:func:`inner_mesh`):
JAX's ``_guard`` leaves the inner-cut leaves whole, and a ``w_in`` still
cut by its 2 inner columns has its product gathered whole
(``mesh.model_unshard``).

No Pallas kernel sits behind this layer; the JAX package computes it in
jnp.  ``mamba_fwd`` records its chunk scan in the cost book
(``models/costbook.py``, JAX's label, totals and trips, on the rank's
inner block), and ``mamba_flops`` is JAX's analytic count.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import (model_copy, model_halves,
                                     model_split, model_sum, model_unshard)
from repro_torch.models import costbook
from repro_torch.models.layers import dense_init, softplus

CHUNK = 256


def check_chunks(S: int, chunk: int = CHUNK) -> None:
    """Raise unless a sequence of ``S`` tokens fits the chunked scan:
    ``S <= chunk`` or a multiple of it."""
    if S > chunk and S % chunk:
        raise ValueError(
            f"mamba: a sequence of {S} tokens; the chunked scan takes at "
            f"most {chunk} tokens or a multiple of {chunk} (the JAX "
            "package's chunk contract)")


def init_mamba(generator, cfg) -> dict:
    d = cfg.d_model
    inner = d * cfg.ssm_expand
    state = cfg.ssm_state
    dt_rank = max(8, math.ceil(d / 16))
    dev = generator.device
    # S4-style A init: -(1..state) per channel
    a = torch.arange(1, state + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(inner, 1)
    # softplus^-1 of U(1e-3, 1e-1)
    u = torch.rand((inner,), generator=generator, device=dev) * \
        (1e-1 - 1e-3) + 1e-3
    return {
        "w_in": dense_init(generator, (d, 2 * inner)),
        "conv_w": dense_init(generator, (cfg.ssm_conv, inner), scale=0.2),
        "conv_b": torch.zeros((inner,), dtype=torch.float32, device=dev),
        "w_b": dense_init(generator, (inner, state)),
        "w_c": dense_init(generator, (inner, state)),
        "w_dt_down": dense_init(generator, (inner, dt_rank)),
        "w_dt_up": dense_init(generator, (dt_rank, inner)),
        "dt_bias": torch.log(torch.expm1(u)),
        "a_log": torch.log(a),
        "d_skip": torch.ones((inner,), dtype=torch.float32, device=dev),
        "w_out": dense_init(generator, (inner, d)),
    }


def _causal_conv(u, w, b, prev=None):
    """Depthwise causal conv.  u: (B,S,inner); w: (K,inner); prev:
    (B,K-1,inner) carried context for decode (None = zeros)."""
    K, S = w.shape[0], u.shape[1]
    if prev is None:
        prev = u.new_zeros((u.shape[0], K - 1, u.shape[2]))
    up = torch.cat([prev, u], dim=1)                        # (B,S+K-1,in)
    out = sum(up[:, i:i + S] * w[i].to(u.dtype) for i in range(K))
    return out + b.to(u.dtype)


def inner_mesh(cfg, mesh):
    """``mesh`` where the layer runs on the rank's inner blocks, None where
    the inner width does not divide ``"model"``: JAX's ``_guard`` leaves
    every inner-cut leaf whole there, and the layer runs whole on every
    rank (only ``w_in``, whose 2 inner columns may divide, can still be
    cut: :func:`_uz` gathers its product)."""
    if not model_split(mesh) or \
            (cfg.d_model * cfg.ssm_expand) % mesh.shape["model"]:
        return None
    return mesh


def _uz(params, x, cfg, mesh):
    """The conv's raw input u and the gate z, (B, L, inner) each, or the
    rank's inner blocks of both on a mesh (:func:`model_halves` of the
    rank's block of ``x @ w_in``); both whole where the inner width does
    not divide ``"model"`` (a cut ``w_in``'s product gathered whole)."""
    w = params["w_in"].to(x.dtype)
    if not model_split(mesh) or w.shape[1] == 2 * cfg.d_model * \
            cfg.ssm_expand:
        return (x @ w).chunk(2, dim=-1)
    if inner_mesh(cfg, mesh) is None:
        return model_unshard(mesh, model_copy(mesh, x) @ w, -1).chunk(
            2, dim=-1)
    return model_halves(mesh, model_copy(mesh, x) @ w).chunk(2, dim=-1)


def _selective(params, u, mesh):
    """The low-rank dt, B and C of the (conv'd, silu'd) input u: (B, L,
    dt_rank), (B, L, state) x2, the f32 products on the f32 matrices.  On
    a mesh each is a sum over inner: the rank's partial products, summed
    over ``"model"`` in one collective."""
    uf = u.float()
    parts = [uf @ params[name] for name in ("w_dt_down", "w_b", "w_c")]
    if not model_split(mesh):
        return parts
    sizes = [t.shape[-1] for t in parts]
    whole = model_copy(mesh, model_sum(mesh, torch.cat(parts, dim=-1)))
    return whole.split(sizes, dim=-1)


def _ssm_params(params, u, dt_low, bm):
    """The chunk's decay and input terms from u (B, L, inner) and its
    rows of the selective products: da, dbu (B, L, inner, state)."""
    dt = softplus(dt_low @ params["w_dt_up"] + params["dt_bias"])
    a = -torch.exp(params["a_log"])                         # (inner,state)
    da = torch.exp(dt[..., None] * a)                       # (B,L,in,st)
    dbu = (dt * u.float())[..., None] * bm[:, :, None, :]   # (B,L,in,st)
    return da, dbu


def _chunk_scan(da, dbu, h0):
    """Inclusive scan of h_t = da_t h_{t-1} + dbu_t over axis 1 from h0,
    in log2(L) doubling steps (Hillis-Steele): at offset o, element t takes
    the combine of element t - o with itself.  da/dbu: (B,L,inner,state);
    h0: (B,inner,state).  Returns (h_all, h_last)."""
    a, b = da, dbu
    off = 1
    while off < a.shape[1]:
        b = torch.cat([b[:, :off],
                       torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    h = a * h0[:, None] + b
    return h, h[:, -1]


def _out(params, y, u, z, mesh):
    """The skip, the gate and ``w_out`` (row-parallel on a mesh, then the
    ``"model"`` sum)."""
    dtype = u.dtype
    y = (y + u * params["d_skip"].to(dtype)) * F.silu(z)
    out = y @ params["w_out"].to(dtype)
    return model_sum(mesh, out) if model_split(mesh) else out


def _mamba(params, x, cfg, chunk: int, mesh=None):
    """The chunked forward: (out, raw conv input u, final state)."""
    B, S, d = x.shape
    check_chunks(S, chunk)
    dtype = x.dtype
    u_raw, z = _uz(params, x, cfg, mesh)
    mesh = inner_mesh(cfg, mesh)
    u = F.silu(_causal_conv(u_raw, params["conv_w"], params["conv_b"]))
    dt_low, bm, cm = _selective(params, u, mesh)
    L = min(chunk, S)
    h = torch.zeros((B, u.shape[-1], cfg.ssm_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c in range(S // L):
        rows = slice(c * L, (c + 1) * L)
        da, dbu = _ssm_params(params, u[:, rows], dt_low[:, rows],
                              bm[:, rows])
        h_all, h = _chunk_scan(da, dbu, h)
        ys.append(torch.einsum("blis,bls->bli", h_all, cm[:, rows]
                               ).to(dtype))
        del da, dbu, h_all
    y = torch.cat(ys, dim=1)
    return _out(params, y, u, z, mesh), u_raw, h


def mamba_fwd(params, x, cfg, chunk: int = CHUNK, mesh=None):
    """Full-sequence forward.  x: (B,S,d) -> (B,S,d); on a mesh, the
    rank's inner blocks (module docstring)."""
    out, _, h = _mamba(params, x, cfg, chunk, mesh)
    B, S = x.shape[:2]
    inner, state = h.shape[1], h.shape[2]
    costbook.record("mamba_scan", total_flops=10.0 * B * S * inner * state,
                    total_bytes=8.0 * B * S * inner * state,
                    trips=S // min(chunk, S))
    return out


def mamba_flops(cfg, n_tokens: int) -> float:
    """JAX's analytic flops of a mamba block over ``n_tokens``: the in
    and out products, the selective products, the scan."""
    d = cfg.d_model
    inner = d * cfg.ssm_expand
    state = cfg.ssm_state
    dt_rank = max(8, int(math.ceil(d / 16)))
    proj = 2.0 * n_tokens * d * 3 * inner                       # in + out
    sel = 2.0 * n_tokens * inner * (2 * state + 2 * dt_rank)
    scan = 10.0 * n_tokens * inner * state
    return proj + sel + scan


def mamba_prefill(params, x, cfg, chunk: int = CHUNK, mesh=None):
    """Returns (out, cache): the final f32 state ``ssm`` (B,inner,state)
    and the conv tail ``conv`` (B,K-1,inner), zero rows first when the
    sequence is shorter than K-1; on a mesh the rank's inner blocks of
    both (JAX's ``_cache_pspec``)."""
    out, u_raw, h = _mamba(params, x, cfg, chunk, mesh)
    K1 = cfg.ssm_conv - 1
    tail = u_raw[:, max(x.shape[1] - K1, 0):]
    tail = F.pad(tail, (0, 0, K1 - tail.shape[1], 0))
    return out, {"ssm": h, "conv": tail}


def mamba_decode(params, x, cfg, cache, mesh=None):
    """One token.  x: (B,1,d); cache: {ssm: (B,inner,state), conv:
    (B,K-1,inner)} (the rank's inner blocks on a mesh).  Returns (out,
    new cache)."""
    dtype = x.dtype
    u_raw, z = _uz(params, x, cfg, mesh)                     # (B,1,in)
    mesh = inner_mesh(cfg, mesh)
    new_conv = torch.cat([cache["conv"], u_raw], dim=1)[:, 1:]
    u = F.silu(_causal_conv(u_raw, params["conv_w"], params["conv_b"],
                            prev=cache["conv"].to(dtype)))
    dt_low, bm, cm = _selective(params, u, mesh)
    da, dbu = _ssm_params(params, u, dt_low, bm)             # (B,1,...)
    h = cache["ssm"] * da[:, 0] + dbu[:, 0]                  # (B,in,st)
    y = torch.einsum("bis,bs->bi", h, cm[:, 0])[:, None, :].to(dtype)
    return _out(params, y, u, z, mesh), {"ssm": h, "conv": new_conv}
