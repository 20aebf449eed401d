"""Plain PyTorch versions of every ported kernel.

They are what the CPU runs, the reference each CUDA kernel is held to on
the card, and they follow the JAX oracles' op order so that the CPU tests
can hold them to ``repro.kernels.ref`` on the same numpy inputs:

* ``_sim_tile`` is ``((2ab - |a|^2) - |b|^2)``;
* the top-k merge is a *stable* descending sort over ``[state | tile]``
  in IEEE total order (-0.0 below +0.0, as XLA sorts), which keeps the
  earliest position among ties, as ``lax.top_k`` does (``torch.topk``
  does not);
* the sum of the M negative forces is taken left to right;
* row norms |a|^2 are summed left to right in feature order, each
  product and each sum rounded on its own (``sq_norms``): the order the
  CUDA distance kernels sum them in, so that on the card a kernel and its
  plain version agree bitwise.
"""
from __future__ import annotations

import math

import torch

# Similarity of a masked candidate (padding, self-edge, bucket mismatch,
# duplicate of the running state), and the distance an empty output slot
# carries.  -INVALID_DIST == INVALID_SIM exactly.
INVALID_SIM = -3.0e38
INVALID_DIST = 3.0e38


# ---------------------------------------------------------------------------
# pairwise squared distances
# ---------------------------------------------------------------------------

def sq_norms(a: torch.Tensor) -> torch.Tensor:
    """|a|^2 over the last axis, summed left to right in feature order.

    A library reduction sums in an order of its own, which differs between
    the CPU and the card and from one release to the next; an explicit
    loop fixes it, and the CUDA kernels sum in the same order."""
    sq = a * a
    if sq.shape[-1] == 0:
        return sq.sum(-1)
    n = sq[..., 0]
    for q in range(1, sq.shape[-1]):
        n = n + sq[..., q]
    return n


def pairwise_sqdist_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (M, d), b: (N, d) -> (M, N) squared euclidean distances, f32."""
    a = a.float()
    b = b.float()
    an = sq_norms(a)[:, None]                             # (M, 1)
    bn = sq_norms(b)[None, :]                             # (1, N)
    return (an + bn - 2.0 * (a @ b.T)).clamp_min(0.0)


# ---------------------------------------------------------------------------
# streaming distance -> top-k
# ---------------------------------------------------------------------------

def dedup_tile(n: int) -> int:
    """The default column-tile width of the dedup semantics for n columns
    (the JAX oracle's default tile)."""
    return 8192 if n >= 65536 else 4096


def total_order(s: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 keys in IEEE total order, -0.0 below +0.0, the order
    XLA sorts floats in (``lax.top_k`` ranks a candidate at +0.0 above a
    seeded state entry at -0.0; ``torch.sort`` would call them tied)."""
    i = s.contiguous().view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def _sim_tile(a, b, an, bn):
    """(G, M, n) similarity s = 2 a.b - |a|^2 - |b|^2 (closer = larger)."""
    s = 2.0 * torch.matmul(a, b.transpose(1, 2))
    return s - an[:, :, None] - bn[:, None, :]


def gather_rows(base, idx):
    """``base[idx]`` with the rows of index -1 read as zeros."""
    rows = base[idx.long().clamp_min(0)]
    return rows.masked_fill((idx < 0)[..., None], 0.0)


def topk_sqdist_ref(a, b, k: int, *, a_idx=None, b_idx=None, a_ids=None,
                    b_ids=None, codes_a=None, codes_b=None, init_ids=None,
                    init_dists=None, dedup: bool = False,
                    bn: int | None = None):
    """For each row of ``a`` the ``k`` nearest rows of ``b``.

    a: (M, d) or (G, M, d); b: (N, d) or (G, N, d) — a leading group
    dimension runs G independent problems in one call.  Returns
    (ids int32, sqdists f32), each (..., M, k), distances ascending.

    The index form: with ``a_idx`` (M,) or (G, M), ``a`` is a base matrix
    and the rows are ``a[a_idx]``; likewise ``b_idx`` (N,) or (G, N) for
    ``b``.  Index -1 reads a zero row (mask it with an id of -1).  This
    version gathers first; the kernel reads the base in place.

    * ``b_ids`` (N,) gives candidate ids (default ``arange(N)``);
      negative ids are padding and never selected over real candidates.
    * ``a_ids`` (M,) masks self pairs (b_id == a_id).
    * ``codes_a`` (M, T) / ``codes_b`` (N, T) keep only pairs that share
      a bucket code in at least one of T trees.
    * ``init_ids``/``init_dists`` (M, k) seed the running state; empty
      slots are (id=-1, dist=INVALID_DIST).
    * ``dedup`` masks candidates whose id already sits in the running
      state as it was at the start of their column tile of width ``bn``
      (the JAX oracle's tile semantics; default 4096, or 8192 from
      N = 65536 up).

    Columns fold in tiles of ``bn`` into the (M, k) state: concatenate
    ``[state | tile]``, stable-sort descending, keep k.
    """
    if a_idx is not None:
        a = gather_rows(a, a_idx)
    if b_idx is not None:
        b = gather_rows(b, b_idx)
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
        a_ids, b_ids, codes_a, codes_b, init_ids, init_dists = (
            None if t is None else t[None]
            for t in (a_ids, b_ids, codes_a, codes_b, init_ids, init_dists))
    G, M, _ = a.shape
    N = b.shape[1]
    dev = a.device
    a = a.float()
    b = b.float()
    bn = bn or dedup_tile(N)
    a_ids = (torch.full((G, M), -1, dtype=torch.int32, device=dev)
             if a_ids is None else a_ids.to(torch.int32))
    b_ids = (torch.arange(N, dtype=torch.int32, device=dev).expand(G, N)
             if b_ids is None else b_ids.to(torch.int32))
    if init_ids is not None:
        si = init_ids.to(torch.int32)
        ss = (-init_dists.float()).clamp_min(INVALID_SIM)
    else:
        si = torch.full((G, M, k), -1, dtype=torch.int32, device=dev)
        ss = torch.full((G, M, k), INVALID_SIM, device=dev)
    an, b_norm = sq_norms(a), sq_norms(b)
    for c0 in range(0, N, bn):
        bit = b_ids[:, c0:c0 + bn]
        s = _sim_tile(a, b[:, c0:c0 + bn], an, b_norm[:, c0:c0 + bn])
        bad = (bit[:, None, :] < 0) | (bit[:, None, :] == a_ids[:, :, None])
        if codes_a is not None:
            match = (codes_a[:, :, None, :]
                     == codes_b[:, None, c0:c0 + bn, :]).any(-1)
            bad |= ~match
        if dedup:
            bad |= (bit[:, None, :, None] == si[:, :, None, :]).any(-1)
        s = s.masked_fill(bad, INVALID_SIM)
        s_all = torch.cat([ss, s], dim=-1)
        i_all = torch.cat([si, bit[:, None, :].expand(G, M, -1)], dim=-1)
        order = torch.sort(total_order(s_all), dim=-1, descending=True,
                           stable=True).indices[..., :k]
        ss = torch.gather(s_all, -1, order)
        si = torch.gather(i_all, -1, order)
    dist = (-ss).clamp_min(0.0)
    if squeeze:
        return si[0], dist[0]
    return si, dist


# ---------------------------------------------------------------------------
# LargeVis forces (f(x) = 1/(1+a x^2)), Eqn (6)
# ---------------------------------------------------------------------------

def largevis_grads_ref(yi, yj, yneg, *, gamma: float = 7.0, a: float = 1.0,
                       clip: float = 5.0, eps: float = 0.1, neg_mask=None):
    """Gradients of the (negated, minimised) edge log-likelihood.

    yi, yj: (B, s); yneg: (B, M, s); neg_mask: (B, M) 1.0 valid / 0.0
    skip.  Returns (gi, gj, gneg), each coordinate clipped to +-clip.
    The M negative forces on yi, and the squared norms, are summed left
    to right, which is the order XLA's reduction uses, so the result is
    bitwise the JAX oracle's (and the CUDA kernels', which sum in the same
    order).
    """
    yi, yj, yneg = yi.float(), yj.float(), yneg.float()
    dij = yi - yj                                          # (B, s)
    d2 = sq_norms(dij)[:, None]                            # (B, 1)
    # a tensor numerator: ``float / tensor`` is reciprocal-then-multiply in
    # torch, one rounding more than XLA's division
    c2a = torch.tensor(2.0 * a, dtype=torch.float32, device=yi.device)
    gpos = (c2a / (1.0 + a * d2)) * dij
    din = yi[:, None, :] - yneg                            # (B, M, s)
    dn2 = sq_norms(din)[..., None]                         # (B, M, 1)
    gneg_i = -2.0 * gamma * din / ((eps + dn2) * (1.0 + a * dn2))
    if neg_mask is not None:
        gneg_i = gneg_i * neg_mask[..., None]
    push = torch.zeros_like(gpos)
    if gneg_i.shape[1]:
        push = gneg_i[:, 0]
        for m in range(1, gneg_i.shape[1]):
            push = push + gneg_i[:, m]
    gi = (gpos + push).clamp(-clip, clip)
    gj = (-gpos).clamp(-clip, clip)
    gneg = (-gneg_i).clamp(-clip, clip)
    return gi, gj, gneg


def edge_update_stream(i, j, negs, gi, gj, gneg, lr, n_frozen: int = 0):
    """The split route's update stream from the forces of an edge batch:
    rows ``idx`` (B*(2+M),) and updates ``-lr * g`` (B*(2+M), s) in the
    canonical per-edge order ``[i_e, j_e, negs_e,0..M-1] for e =
    0..B-1``.

    ``lr`` is a float, a 0-d f32 tensor or a (B,) per-edge vector; a
    tensor on the device is read there (no host-to-device copy, so the
    stream can be captured).  Updates to rows below ``n_frozen`` become
    -0.0, a bitwise no-op when added.
    """
    s = gi.shape[1]
    idx = torch.cat([i[:, None], j[:, None], negs], dim=1).reshape(-1)
    upd = torch.cat([gi[:, None], gj[:, None], gneg], dim=1).reshape(-1, s)
    if torch.is_tensor(lr) and lr.dim():  # (B,) per-edge -> per update row
        lr = lr.float().repeat_interleave(2 + negs.shape[1])[:, None]
    upd = upd * -lr
    if n_frozen:
        upd = upd.masked_fill((idx < n_frozen)[:, None], -0.0)
    return idx, upd


def largevis_grads_stream_ref(y, i, j, negs, neg_mask, lr, n_frozen: int = 0,
                              *, gamma: float = 7.0, a: float = 1.0,
                              clip: float = 5.0, eps: float = 0.1):
    """The indexed force kernel's plain version: gather y at the edge
    batch, the forces of :func:`largevis_grads_ref`, then
    :func:`edge_update_stream`.  Returns ``(idx (B*(2+M),) int32, upd
    (B*(2+M), s) f32)``."""
    il, jl, nl = i.long(), j.long(), negs.long()
    gi, gj, gneg = largevis_grads_ref(y[il], y[jl], y[nl], gamma=gamma, a=a,
                                      clip=clip, eps=eps, neg_mask=neg_mask)
    idx, upd = edge_update_stream(il, jl, nl, gi, gj, gneg, lr, n_frozen)
    return idx.to(torch.int32), upd


# ---------------------------------------------------------------------------
# fused edge step: gather -> forces -> scatter-accumulate
# ---------------------------------------------------------------------------

def scatter_add_ordered_ref(y, idx, upd):
    """``y[idx[u]] += upd[u]`` in place; on the CPU ``index_add_`` adds the
    updates to one row in stream order (on CUDA it uses atomics, whose
    order varies, so this version is the reference only on the CPU).
    Returns ``y``."""
    return y.index_add_(0, idx.long(), upd)


def fused_edge_step_ref(y, i, j, negs, neg_mask, lr, *, gamma: float = 7.0,
                        a: float = 1.0, clip: float = 5.0, eps: float = 0.1,
                        n_frozen: int = 0):
    """One SGD update of the (N, s) embedding over an edge batch, in place.

    Every gather happens before any update; the updates ``-lr * g``
    accumulate in the canonical per-edge order ``[i_e, j_e,
    negs_e,0..M-1] for e = 0..B-1``.  ``lr`` is a scalar or a (B,)
    per-edge vector.  Updates to rows below ``n_frozen`` are -0.0, a
    bitwise no-op, so those rows never change.  Returns ``y``.
    """
    i, j, negs = i.long(), j.long(), negs.long()
    gi, gj, gneg = largevis_grads_ref(y[i], y[j], y[negs], gamma=gamma, a=a,
                                      clip=clip, eps=eps, neg_mask=neg_mask)
    s = gi.shape[1]
    idx = torch.cat([i[:, None], j[:, None], negs], dim=1).reshape(-1)
    upd = torch.cat([gi[:, None], gj[:, None], gneg], dim=1).reshape(-1, s)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=y.device)
    if lr.dim():                         # (B,) per-edge -> per update row
        lr = lr.repeat_interleave(2 + negs.shape[1])[:, None]
    upd = -lr * upd
    if n_frozen:
        upd = torch.where((idx >= n_frozen)[:, None], upd,
                          torch.tensor(-0.0, device=y.device))
    return scatter_add_ordered_ref(y, idx, upd)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

FLASH_NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q (B, S, H, hd), k and v (B, T, H, hd), heads pre-broadcast.

    One f32 softmax over the whole (S, T) score matrix, ``(q.k) * scale``
    with scale = 1/sqrt(hd) as the kernel multiplies it; masked scores are
    -1e30.  The causal mask is top-left, ``kpos <= qpos`` with both counted
    from 0, as the JAX package's Pallas kernel has it (its plain version
    ``flash_attention_ref`` aligns bottom-right, ``tril(k=T-S)``; the two
    agree only at S == T).  The output is cast to q's dtype."""
    S, T, hd = q.shape[1], k.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * \
        (1.0 / math.sqrt(hd))
    if causal:
        keep = torch.ones((S, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, FLASH_NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
