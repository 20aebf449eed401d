"""The bf16 flash backward kernel's arithmetic and order, on the CPU.

``csrc/flash_attention_bwd.cu`` (namespace ``wg``) cannot run here, so
``_kernel_emulation`` walks its tiles in its order on CPU tensors: a
block a tile of keys (128 up to hd 64, 64 at hd 128 and 256) walking the
query tiles of 64 rows that the mask lets see it, from the last one
down; S^T = K Q^T and dP^T = V dO^T summed in f32 from the exact bf16
products; p = 2^(s c - lse log2 e) with c = log2(e) / sqrt(hd), and p
and ds set to 0 by a select on masked (and padded) pairs; P^T and dS^T
rounded to bf16 before the dV, dK and dQ products; dK and dV summed in
f32 over the walk; each query tile's dQ partials added in ascending key
tile order (the first writes the f32 accumulator, each later one adds
into it, the last rounds the sum to bf16).  ``_walk`` and ``_adders`` are
the kernel's ``walk`` and ``adders``: the query tiles a key tile walks,
and the key tiles the counter of a query tile admits.

The emulation is held against the plain version
(``ref.flash_attention_bwd_ref``) at ``chip_smoke.py``'s bf16 limit
(max |err| / max |plain| of each gradient at most 1e-2), at hd 16, 64 and
256, S and T one off the tiles, S > T, non-causal and windows of 2 and
64; and against ``jax.vjp`` of the JAX package's ``mha_chunked`` at the
bar of ``tests/test_torch_flash_bwd.py``: no farther from the f32
gradient of the same (bf16) inputs than twice JAX's own bf16 gradient.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import ref

BQ = 64                       # query rows of a tile
LOG2E = 1.4426950408889634
BF16_TOL = 1e-2               # chip_smoke.py's BWD_BF16_TOL


def _bk(hd):
    """The kernel's keys a block: 128 up to hd 64, 64 at hd 128 and 256."""
    return 128 if hd <= 64 else 64


def _walk(j, nq, T, causal, window, bk):
    """The query tiles [lo, hi) that key tile j walks (the kernel's
    ``walk``): causal from the tile of its first key on, a window up to
    its last key + W - 1."""
    k0, kend = j * bk, min(j * bk + bk, T)
    lo = k0 // BQ if causal else 0
    hi = min(nq, (kend - 1 + window - 1) // BQ + 1) if window else nq
    return lo, hi


def _adders(i, nk, causal, window, bk):
    """The key tiles [lo, hi) that add into query tile i, in this order
    (the kernel's ``adders``)."""
    lo = max(0, i * BQ - window + 1) // bk if window else 0
    hi = min(nk, ((i + 1) * BQ - 1) // bk + 1) if causal else nk
    return lo, hi


def _keep(qp, kp, S, T, causal, window):
    """(keys, queries) of the pairs that take p, the others 0."""
    ok = (kp[:, None] < T) & (qp[None, :] < S)
    if causal:
        ok &= kp[:, None] <= qp[None, :]
    if window:
        ok &= kp[:, None] > qp[None, :] - window
    return ok


def _kernel_emulation(q, k, v, out, dout, lse, *, causal=True, window=0,
                      log=None):
    """(dq, dk, dv) in bf16 by the bf16 kernel's tiles and order; ``log``,
    a list, receives (query tile, key tile, "write" | "add" | "round")
    in the order the accumulator sees them."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    window = min(ref.check_window(S, T, causal, window), S)
    bk = _bk(hd)
    nq, nk = -(-S // BQ), -(-T // bk)
    scale = 1.0 / math.sqrt(hd)
    c = scale * LOG2E
    qf, kf, vf, of, gf = (x.float().transpose(1, 2) for x in
                          (q, k, v, out, dout))            # (B, H, ., hd)
    delta = (gf * of).sum(-1)                              # (B, H, S)
    dq = torch.empty((B, H, S, hd))
    dk = torch.zeros((B, H, T, hd))
    dv = torch.zeros_like(dk)
    partial = {}
    for j in range(nk):
        keys = torch.arange(j * bk, min(j * bk + bk, T))
        kt, vt = kf[:, :, keys], vf[:, :, keys]
        lo, hi = _walk(j, nq, T, causal, window, bk)
        for i in range(hi - 1, lo - 1, -1):
            rows = torch.arange(i * BQ, min(i * BQ + BQ, S))
            qt, gt = qf[:, :, rows], gf[:, :, rows]
            st = kt @ qt.transpose(-1, -2)                 # (B, H, keys, rows)
            dpt = vt @ gt.transpose(-1, -2)
            ok = _keep(rows, keys, S, T, causal, window)
            p = torch.exp2(st * c - lse[:, :, None, rows] * LOG2E)
            ds = p * (dpt - delta[:, :, None, rows]) * scale
            p = torch.where(ok, p, 0.0).bfloat16().float()
            ds = torch.where(ok, ds, 0.0).bfloat16().float()
            dv[:, :, keys] += p @ gt
            dk[:, :, keys] += ds @ qt
            partial[i, j] = ds.transpose(-1, -2) @ kt      # (B, H, rows, hd)
    for i in range(nq):
        lo, hi = _adders(i, nk, causal, window, bk)
        assert sorted(jj for ii, jj in partial if ii == i) == \
            list(range(lo, hi)), "walks and counters disagree"
        acc = None
        for j in range(lo, hi):
            acc = partial[i, j] if acc is None else acc + partial[i, j]
            if log is not None:
                log.append((i, j, "write" if j == lo else
                            "round" if j == hi - 1 else "add"))
        dq[:, :, i * BQ:i * BQ + acc.shape[2]] = acc
    return tuple(x.transpose(1, 2).bfloat16() for x in (dq, dk, dv))


def _bf16_case(B, S, T, H, hd, seed):
    rng = np.random.default_rng(seed)
    q, dout = (torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(
        np.float32)).bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, T, H, hd)).astype(
        np.float32)).bfloat16() for _ in range(2))
    return q, k, v, dout


def _rel(got, want):
    got, want = (np.asarray(x, np.float32) for x in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


# a window only with S <= T (ref.check_window)
WALKS = [(S, T, causal, window)
         for S, T in [(1, 1), (63, 65), (64, 64), (65, 200), (129, 63),
                      (300, 1037), (1000, 1000)]
         for causal, window in [(True, 0), (False, 0), (True, 2), (True, 64),
                                (True, 1000)]
         if not (window and S > T)]


@pytest.mark.parametrize("S,T,causal,window", WALKS)
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_walks_and_counters_agree(hd, S, T, causal, window):
    """Query tile i is in key tile j's walk exactly when j is one of i's
    adders, and every query tile has one at least (so dq is written
    whole, by the last of them)."""
    bk = _bk(hd)
    nq, nk = -(-S // BQ), -(-T // bk)
    window = min(window, S)
    walks = [_walk(j, nq, T, causal, window, bk) for j in range(nk)]
    for i in range(nq):
        lo, hi = _adders(i, nk, causal, window, bk)
        assert lo < hi
        assert [j for j, (a, b) in enumerate(walks) if a <= i < b] == \
            list(range(lo, hi))


# (S, T, causal, window): S and T one off the tiles, S < T, S > T,
# non-causal, windows of 2 and 64
PLAIN = [(65, 65, True, 0), (127, 129, True, 0), (129, 63, True, 0),
         (130, 130, False, 0), (63, 129, False, 0), (129, 129, True, 2),
         (200, 257, True, 64)]


@pytest.mark.parametrize("S,T,causal,window", PLAIN)
@pytest.mark.parametrize("hd", [16, 64, 256])
def test_kernel_arithmetic_matches_plain_version(hd, S, T, causal, window):
    q, k, v, dout = _bf16_case(1, S, T, 2, hd, seed=hd + S + T + window)
    kw = dict(causal=causal, window=window)
    out, lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
    got = _kernel_emulation(q, k, v, out, dout, lse, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        assert _rel(g.float(), w.float()) <= BF16_TOL


def test_dq_is_added_in_ascending_key_tile_order():
    """Each query tile's partials reach the accumulator from its first
    adder to its last: written once, added, rounded once; at S 300 and W
    64 (hd 64) the windowed tiles start past key tile 0."""
    q, k, v, dout = _bf16_case(1, 300, 300, 1, 64, seed=1)
    out, lse = ref.flash_attention_fwd_ref(q, k, v, window=64)
    log = []
    _kernel_emulation(q, k, v, out, dout, lse, window=64, log=log)
    by_tile = {}
    for i, j, what in log:
        by_tile.setdefault(i, []).append((j, what))
    assert sorted(by_tile) == list(range(5))
    for i, seq in by_tile.items():
        js = [j for j, _ in seq]
        assert js == list(range(*_adders(i, 3, True, 64, 128)))
        whats = [w for _, w in seq]
        if len(seq) > 1:
            assert whats == ["write"] + ["add"] * (len(seq) - 2) + ["round"]
    assert [j for j, _ in by_tile[4]] == [1, 2]      # rows 256.. see 193..


# (hd, S, T, causal, window) that JAX's mha_chunked takes with 64-row
# blocks: every head dim causal, the window and non-causal at hd 64
JAX_CASES = [(16, 128, 128, True, 0), (64, 128, 128, True, 0),
             (256, 128, 128, True, 0), (64, 128, 128, True, 64),
             (64, 128, 64, False, 0)]


@functools.lru_cache(maxsize=None)
def _jax_grads(hd, S, T, causal, window):
    """(f32 gradient, JAX's bf16 gradient) of the bf16 case, by jax.vjp of
    ``mha_chunked`` with 64-row blocks (cached: each case's JAX
    references are made once)."""
    q, k, v, dout = _bf16_case(1, S, T, 2, hd, seed=7 * hd + S + T + window)
    qp, kp = jnp.arange(S), jnp.arange(T)

    def f(q, k, v):
        return jattn.mha_chunked(q, k, v, qp, kp, causal=causal,
                                 window=window, q_block=64, kv_block=64)

    res = []
    for dt in (jnp.float32, jnp.bfloat16):
        args = [jnp.asarray(x.float().numpy()).astype(dt)
                for x in (q, k, v)]
        _, vjp = jax.vjp(f, *args)
        grads = vjp(jnp.asarray(dout.float().numpy()).astype(dt))
        res.append([np.asarray(g.astype(jnp.float32)) for g in grads])
    return (q, k, v, dout), res[0], res[1]


@pytest.mark.parametrize("hd,S,T,causal,window", JAX_CASES)
def test_kernel_arithmetic_within_twice_jax_error(hd, S, T, causal, window):
    (q, k, v, dout), exact, jax_bf16 = _jax_grads(hd, S, T, causal, window)
    kw = dict(causal=causal, window=window)
    out, lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
    got = _kernel_emulation(q, k, v, out, dout, lse, **kw)
    for g, jb, want in zip(got, jax_bf16, exact):
        assert _rel(g.float().numpy(), want) <= 2 * _rel(jb, want), \
            (_rel(g.float().numpy(), want), _rel(jb, want))
