"""The split route's indexed force kernel against the JAX package, on the CPU.

``largevis_grads_stream`` (``csrc/largevis_grad.cu``) reads y at the edge
batch's rows and writes the update stream ``(idx, upd)`` that the ordered
scatter takes, in the canonical per-edge order ``[i_e, j_e,
negs_e,0..M-1]``.  No CUDA kernel runs here; ``chip_smoke.py`` holds the
kernel to its plain version on the card.  These tests hold, bitwise:

* the plain version ``ref.largevis_grads_stream_ref`` to the JAX split
  route run eagerly (``repro.core.layout_engine.apply_edge_batch(...,
  fused_step=False)``): its ``idx`` and ``upd`` as that route builds them,
  and the scattered y;
* a torch model of the kernel's thread mapping (one thread an update row,
  whole edges a block, the pushes staged in shared memory and summed by
  the edge's first thread) to the same JAX stream;
* the fused and split routes to each other through ``StepChunks``.

Bitwise, against the *eager* JAX oracle: jit contracts multiply-adds into
FMAs and moves a force by an ulp, while the port, eager JAX and the CUDA
kernels round every operation on its own.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout_engine as jengine
from repro.kernels import ops as jops
from repro_torch.core import layout_engine
from repro_torch.core import sampler as tsamp
from repro_torch.kernels import largevis_grad, ops
from repro_torch.kernels import ref as tref

GAMMA, A, CLIP, EPS = 7.0, 1.0, 5.0, 0.1
BLOCK = 256                       # largevis_grad.cu: threads a block


def T(x):
    return torch.from_numpy(np.array(x))


def _batch(B, M, s, seed, N=300, hub=False):
    """An edge batch on N rows, about a fifth of the negatives masked by
    collisions; with ``hub`` row 7 takes about 2,000 of the updates."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((N, s)) * 3.0).astype(np.float32)
    i = rng.integers(0, N, B).astype(np.int32)
    j = rng.integers(0, N, B).astype(np.int32)
    negs = rng.integers(0, N, (B, M)).astype(np.int32)
    if hub:
        i[:300] = 7
        j[300:600] = 7
        negs.reshape(-1)[::14] = 7
    if M:
        negs[::5, 0] = i[::5]                 # collisions, masked
    mask = ((negs != i[:, None]) & (negs != j[:, None])).astype(np.float32)
    return y, i, j, negs, mask


def _lr(form, B, seed):
    """The lr as the JAX route takes it and as the port takes it."""
    if form == "float":
        return 0.37, 0.37
    if form == "0-d":
        return jnp.float32(0.37), torch.tensor(0.37)
    lr = np.random.default_rng(seed).uniform(0.1, 1.0, B).astype(np.float32)
    return jnp.asarray(lr), T(lr)


def _jax_split(y, i, j, negs, mask, lr, n_frozen):
    """The JAX split route, eagerly: its update stream as
    ``repro/core/layout_engine.py::apply_edge_batch`` builds it, and the
    y its scatter gives."""
    yj, ij, jj, nj = (jnp.asarray(t) for t in (y, i, j, negs))
    gi, gj, gneg = jops.largevis_grads(yj[ij], yj[jj], yj[nj],
                                       jnp.asarray(mask), gamma=GAMMA, a=A,
                                       clip=CLIP)
    s = y.shape[1]
    idx = jnp.concatenate([ij[:, None], jj[:, None], nj], axis=1).reshape(-1)
    upd = jnp.concatenate([gi[:, None], gj[:, None], gneg],
                          axis=1).reshape(-1, s)
    lr32 = jnp.asarray(lr, jnp.float32)
    if lr32.ndim:
        lr32 = jnp.repeat(lr32, 2 + negs.shape[1])[:, None]
    upd = -lr32 * upd
    if n_frozen:
        upd = jnp.where((idx >= n_frozen)[:, None], upd, jnp.float32(-0.0))
    y_new = jengine.apply_edge_batch(
        yj, ij, jj, nj, jnp.asarray(mask), lr, a=A, gamma=GAMMA, clip=CLIP,
        fused_step=False, n_frozen=n_frozen)
    return np.asarray(idx), np.asarray(upd), np.asarray(y_new)


def _assert_stream(got, want):
    idx, upd = got
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), want[0])
    # bitwise, signed zeros included (a frozen row's update is -0.0)
    np.testing.assert_array_equal(upd.numpy().view(np.uint32),
                                  want[1].view(np.uint32))


# ---------------------------------------------------------------------------
# the plain version against the JAX split route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_frozen", [0, 40])
@pytest.mark.parametrize("lr_form", ["float", "0-d", "per-edge"])
@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("M", [1, 5])
@pytest.mark.parametrize("B", [4096, 4095, 37])
def test_stream_ref_bitwise_jax_split_route(B, M, s, lr_form, n_frozen):
    y, i, j, negs, mask = _batch(B, M, s, seed=B + M + s)
    lr_j, lr_t = _lr(lr_form, B, seed=B)
    want = _jax_split(y, i, j, negs, mask, lr_j, n_frozen)
    got = tref.largevis_grads_stream_ref(T(y), T(i), T(j), T(negs), T(mask),
                                         lr_t, n_frozen, gamma=GAMMA, a=A,
                                         clip=CLIP)
    _assert_stream(got, want)
    y_new = ops.scatter_add_ordered(T(y), *got)
    np.testing.assert_array_equal(y_new.numpy(), want[2])
    routed = layout_engine.apply_edge_batch(
        T(y), T(i), T(j), T(negs), T(mask), lr_t, a=A, gamma=GAMMA,
        clip=CLIP, layout_step="split", n_frozen=n_frozen)
    np.testing.assert_array_equal(routed.numpy(), want[2])
    if n_frozen:
        np.testing.assert_array_equal(y_new.numpy()[:n_frozen],
                                      y[:n_frozen])


@pytest.mark.parametrize("lr_form", ["float", "per-edge"])
def test_stream_ref_bitwise_jax_on_a_hub_batch(lr_form):
    """Row 7 takes about 2,000 of the 28,672 updates."""
    y, i, j, negs, mask = _batch(4096, 5, 2, seed=3, N=1000, hub=True)
    lr_j, lr_t = _lr(lr_form, 4096, seed=3)
    want = _jax_split(y, i, j, negs, mask, lr_j, 5)
    got = tref.largevis_grads_stream_ref(T(y), T(i), T(j), T(negs), T(mask),
                                         lr_t, 5, gamma=GAMMA, a=A, clip=CLIP)
    assert int((got[0] == 7).sum()) > 1500
    _assert_stream(got, want)
    np.testing.assert_array_equal(
        ops.scatter_add_ordered(T(y), *got).numpy(), want[2])


def test_ops_routes_cpu_tensors_to_the_plain_version():
    y, i, j, negs, mask = _batch(300, 5, 2, seed=4)
    ops.reset_launch_counts()
    got = ops.largevis_grads_stream(T(y), T(i), T(j), T(negs), T(mask), 0.5,
                                    12, gamma=GAMMA, a=A, clip=CLIP)
    want = tref.largevis_grads_stream_ref(T(y), T(i), T(j), T(negs),
                                          T(mask), 0.5, 12, gamma=GAMMA, a=A,
                                          clip=CLIP)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.launch_counts()["largevis_grads"] == 0


def test_launcher_refuses_cpu_tensors_and_counts_nothing():
    y, i, j, negs, mask = _batch(16, 5, 2, seed=5)
    largevis_grad.largevis_grads.launches = 0
    with pytest.raises(ValueError):
        largevis_grad.largevis_grads_stream(T(y), T(i), T(j), T(negs),
                                            T(mask), 0.5)
    assert largevis_grad.largevis_grads.launches == 0


# ---------------------------------------------------------------------------
# the kernel's thread mapping, modelled in torch
# ---------------------------------------------------------------------------

def _sqnorm(v):
    acc = v[..., 0] * v[..., 0]
    for k in range(1, v.shape[-1]):
        acc = acc + v[..., k] * v[..., k]
    return acc


def _kernel_model(y, i, j, negs, mask, lr, n_frozen):
    """grads_stream_kernel: blocks of E = 256 // (2+M) whole edges; thread
    t of block b is row r = t % (2+M) of edge b*E + t // (2+M) and writes
    stream entry b*E*(2+M) + t.  Rows 0 and 1 compute the pull, rows 2..
    their push, staged in shared memory; row 0 sums its edge's M pushes
    left to right from there.  Each operation rounded on its own, in
    ``largevis_forces.cuh``'s order.  Returns (idx, upd) in stream
    order."""
    B, M = negs.shape
    s = y.shape[1]
    G = 2 + M
    E = BLOCK // G
    f32 = torch.float32
    c2a, c2g = torch.tensor(2.0 * A, dtype=f32), torch.tensor(-2.0 * GAMMA,
                                                              dtype=f32)
    a, eps = torch.tensor(A, dtype=f32), torch.tensor(EPS, dtype=f32)
    one = torch.tensor(1.0, dtype=f32)
    U = B * G
    idx = torch.full((U,), -7, dtype=torch.int32)
    upd = torch.full((U, s), float("nan"))
    for blk in range(-(-B // E)):
        t = torch.arange(BLOCK)
        r = t % G
        e = blk * E + t // G
        live = (t < E * G) & (e < B)
        t, r, e = t[live], r[live], e[live]
        ii = i[e].long()
        col = (r - 2).clamp(0, max(M - 1, 0))
        other = torch.where(r < 2, j[e].long(),
                            negs[e, col].long()) if M else j[e].long()
        yi, yo = y[ii], y[other]
        d = yi - yo
        d2 = _sqnorm(d)[:, None]
        gp = c2a / (one + a * d2)                  # rows 0, 1: the pull
        gpos = gp * d
        den = (eps + d2) * (one + a * d2)          # rows 2..: a push
        mk = mask[e, col][:, None] if M else torch.ones((e.shape[0], 1))
        g = ((c2g * d) / den) * mk
        push_sh = torch.zeros((BLOCK, s))
        push_sh[t] = torch.where((r >= 2)[:, None], g, push_sh[t])
        out = (-g).clamp(-CLIP, CLIP)
        first = r == 0
        push = torch.zeros((int(first.sum()), s))
        for m in range(M):                         # left to right
            gm = push_sh[t[first] + 2 + m]
            push = gm if m == 0 else push + gm
        out[first] = (gpos[first] + push).clamp(-CLIP, CLIP)
        out[r == 1] = (-gpos[r == 1]).clamp(-CLIP, CLIP)
        lr_e = lr[e] if lr.dim() else lr.expand(e.shape[0])
        nlr = (-lr_e)[:, None]
        row = torch.where(r == 0, ii, other)
        val = torch.where((row < n_frozen)[:, None], torch.tensor(-0.0),
                          nlr * out)
        u = blk * E * G + t
        idx[u] = row.to(torch.int32)
        upd[u] = val
    return idx, upd


@pytest.mark.parametrize("B,M,s", [(4096, 5, 2), (37, 5, 2), (301, 1, 3),
                                   (100, 0, 2), (64, 30, 1)])
def test_thread_mapping_model_bitwise_jax(B, M, s):
    y, i, j, negs, mask = _batch(B, M, s, seed=10 + B)
    lr_j, lr_t = _lr("per-edge", B, seed=11)
    want = _jax_split(y, i, j, negs, mask, lr_j, 9)
    got = _kernel_model(T(y), T(i), T(j), T(negs), T(mask), lr_t, 9)
    _assert_stream(got, want)


# ---------------------------------------------------------------------------
# both routes through the chunked dispatch
# ---------------------------------------------------------------------------

def test_fused_and_split_equal_through_step_chunks():
    """200 steps (two chunks of 100) of each route from one state and one
    seed: bitwise equal, and the generators in the same place."""
    rng = np.random.default_rng(0)
    N, K = 400, 8
    idx = (np.arange(N)[:, None] + rng.integers(1, N, (N, K))) % N
    w = rng.random((N, K)).astype(np.float32) ** 2
    es = tsamp.build_edge_sampler(T(idx.astype(np.int32)), T(w))
    ns = tsamp.build_negative_sampler(T(idx.astype(np.int32)), T(w))
    lrs = layout_engine.lr_table(1.0, 200, "cpu")
    y0 = torch.randn((N, 2), generator=torch.Generator().manual_seed(1))
    outs = []
    for route in ("fused", "split"):
        step = functools.partial(layout_engine.sgd_edge_step,
                                 edge_sampler=es, neg_sampler=ns,
                                 n_negatives=5, batch=200,
                                 layout_step=route)
        y = y0.clone()
        gen = torch.Generator().manual_seed(2)
        assert layout_engine.StepChunks(step, y, 100).run_all(gen, lrs) == 2
        outs.append((y, gen.get_state()))
    assert not torch.equal(outs[0][0], y0)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
