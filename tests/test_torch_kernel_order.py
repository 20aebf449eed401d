"""The orders the redesigned CUDA kernels compute in, modelled in torch on
the CPU and held to the JAX package's oracles.

No CUDA kernel runs here; ``chip_smoke.py`` holds each kernel to its plain
version on the card.  These tests show that the kernels' algorithms give
the oracles' results bit for bit:

* ``fused_edge_step`` (``csrc/largevis_step.cu``): phase 0 links every
  update into its row's list with an atomic exchange, in whatever order
  the threads arrive; phase 1's owner (the update whose exchange returned
  -1) adds the list in ascending stream position — sorted in registers up
  to ``SHORT`` updates, else (phase 2) found by its block's ordered scan
  of the destinations.  Modelled with several random link orders; bitwise equal
  to the *eager* JAX oracle (jit contracts FMAs);
* ``topk_sqdist`` (``csrc/knn_topk.cu``): chunks of 64 columns, a
  threshold filter against each row's k-th similarity, a buffer of at
  most 72 candidates a row merged when a chunk's survivors would
  overflow it, at each dedup tile's end and at the end: sorted by
  (s desc, column asc) and merged with the state first among ties, similarities compared in IEEE total
  order (-0.0 below +0.0: a seeded distance of 0 is a state entry at
  -0.0, which XLA ranks below a candidate at +0.0).  On integer-grid inputs, where every
  product and norm is exact and distances tie often, its ids and
  distances equal the JAX oracle's exactly;
* the index form of the plain top-k (a base matrix read at row indices)
  equals the JAX oracle on the gathered blocks.
"""
import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import knn
from repro_torch.kernels import knn_topk, largevis_step, ops
from repro_torch.kernels import ref as tref

GAMMA, A, CLIP = 7.0, 1.0, 5.0
SHORT = 8                  # largevis_step.cu: longest list a thread sorts
CHUNK, CAP = 64, 72        # knn_topk.cu: BNK, CAP


def T(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# fused_edge_step: linked lists, then each row in ascending stream position
# ---------------------------------------------------------------------------

def _edge_batch(kind: str, seed: int):
    """'dense': N = 64, about 450 updates a row; 'hub': N = 1000, row 7
    takes about 2,000 updates.  Per-edge lr, the first rows frozen."""
    rng = np.random.default_rng(seed)
    N, B, M = (64, 4096, 5) if kind == "dense" else (1000, 4096, 5)
    y = (rng.standard_normal((N, 2)) * 3.0).astype(np.float32)
    i = rng.integers(0, N, B).astype(np.int32)
    j = rng.integers(0, N, B).astype(np.int32)
    negs = rng.integers(0, N, (B, M)).astype(np.int32)
    if kind == "hub":
        i[:300] = 7
        j[300:600] = 7
        negs.reshape(-1)[::14] = 7
    mask = ((negs != i[:, None]) & (negs != j[:, None])).astype(np.float32)
    lr = rng.uniform(0.1, 1.0, B).astype(np.float32)
    return y, i, j, negs, mask, lr, 5


def _staged(y, i, j, negs, mask, lr, n_frozen):
    """Phase 0: the update rows -lr*g and their destinations, in stream
    order [i_e, j_e, negs_e,0..M-1]."""
    gi, gj, gn = tref.largevis_grads_ref(T(y[i]), T(y[j]), T(y[negs]),
                                         gamma=GAMMA, a=A, clip=CLIP,
                                         neg_mask=T(mask))
    M = negs.shape[1]
    dst = np.concatenate([i[:, None], j[:, None], negs], 1).reshape(-1)
    g = torch.cat([gi[:, None], gj[:, None], gn], 1).reshape(-1, 2)
    nlr = -T(lr).repeat_interleave(2 + M)[:, None]
    upd = (nlr * g).numpy()
    return dst, upd


def _phase1_model(y, dst, upd, n_frozen, order):
    """Link in ``order``, then each owner adds its row's list in ascending
    u; returns (y, head after the step)."""
    N = y.shape[0]
    head = np.full(N, -1, np.int64)
    nxt = np.full(dst.shape[0], -7, np.int64)
    for u in order:                      # next[u] = atomicExch(&head, u)
        r = dst[u]
        if r >= n_frozen:
            nxt[u], head[r] = head[r], u
    y = y.copy()
    for u in range(dst.shape[0]):
        r = dst[u]
        if r < n_frozen or nxt[u] != -1:
            continue                     # not the row's owner
        walk, v = [], head[r]
        while v != -1:
            walk.append(v)
            v = nxt[v]
        if len(walk) <= SHORT:
            ids = sorted(walk)
        else:                            # the block's ordered scan
            ids = np.flatnonzero(dst == r).tolist()
            assert ids == sorted(walk)
        acc = y[r].copy()
        for q in ids:
            acc = (acc + upd[q]).astype(np.float32)
        y[r] = acc
        head[r] = -1
    return y, head


@pytest.mark.parametrize("order_seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["dense", "hub"])
def test_linked_list_phase1_matches_jax_oracle_bitwise(kind, order_seed):
    y, i, j, negs, mask, lr, n_frozen = _edge_batch(kind, seed=11)
    dst, upd = _staged(y, i, j, negs, mask, lr, n_frozen)
    order = np.random.default_rng(order_seed).permutation(dst.shape[0])
    got, head = _phase1_model(y, dst, upd, n_frozen, order)
    want = jref.fused_edge_step_ref(
        jnp.asarray(y), jnp.asarray(i), jnp.asarray(j), jnp.asarray(negs),
        jnp.asarray(mask), jnp.asarray(lr), gamma=GAMMA, a=A, clip=CLIP,
        n_frozen=n_frozen)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (head == -1).all(), "a row's head was not reset"
    np.testing.assert_array_equal(got[:n_frozen], y[:n_frozen])
    counts = np.bincount(dst, minlength=y.shape[0])
    assert counts.max() > 400, "the batch must hold long lists"


# ---------------------------------------------------------------------------
# topk_sqdist: threshold filter, buffer, sort, merge with the state first
# ---------------------------------------------------------------------------

def _grid_points(n, d, seed):
    """Integer grid points in [0, 3)^d, each repeated 4 times, shuffled."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 3, (n // 4, d)).astype(np.float32)
    return np.repeat(base, 4, axis=0)[rng.permutation(n)]


def _ord(s) -> int:
    """An f32's rank in IEEE total order (-0.0 below +0.0), as the kernel
    and XLA compare similarities."""
    i = int(np.float32(s).view(np.int32))
    return i ^ 0x7FFFFFFF if i < 0 else i


def _merge(ss, si, buf, b_ids, snap, dedup):
    """One batched merge of a row's buffer into its (desc) state."""
    k = len(ss)
    kth = _ord(ss[-1])
    keep = [(s, c) for s, c in buf
            if _ord(s) > kth and not (dedup and int(b_ids[c]) in snap)]
    keep.sort(key=lambda t: (-_ord(t[0]), t[1]))
    neg_buf = [-_ord(s) for s, _ in keep]
    neg_st = [-_ord(s) for s in ss]
    out_s, out_i = [None] * k, [None] * k
    for r, (s, idx) in enumerate(zip(ss, si)):
        rank = r + bisect.bisect_left(neg_buf, -_ord(s))  # buffer above
        if rank < k:
            out_s[rank], out_i[rank] = s, idx
    for r, (s, c) in enumerate(keep):
        rank = r + bisect.bisect_right(neg_st, -_ord(s))  # state at or above
        if rank < k:
            out_s[rank], out_i[rank] = s, int(b_ids[c])
    return out_s, out_i


def _dists(ss):
    return np.maximum(-np.float32(ss), np.float32(0.0))


def _batched_merge_model(a, b, k, *, a_ids, b_ids, dedup, bn, init=None):
    """The kernel's selection for one problem: (ids (M, k), dists)."""
    states = _fold_states(a, b, k, a_ids=a_ids, b_ids=b_ids, dedup=dedup,
                          bn=bn, init=init)
    return (np.array([si for _, si in states], np.int32),
            np.array([_dists(ss) for ss, _ in states], np.float32))


def _fold_states(a, b, k, *, a_ids, b_ids, dedup, bn, init=None):
    """Each row's final running state (sims, ids), descending."""
    sims = tref._sim_tile(T(a)[None], T(b)[None], tref.sq_norms(T(a))[None],
                          tref.sq_norms(T(b))[None])[0].numpy()
    M, N = sims.shape
    states = []
    for r in range(M):
        if init is None:
            ss, si = [tref.INVALID_SIM] * k, [-1] * k
        else:                            # the seed, stably sorted desc
            s0 = np.maximum(-init[1][r], np.float32(tref.INVALID_SIM))
            o = sorted(range(k), key=lambda t: -_ord(s0[t]))
            ss, si = [float(s0[t]) for t in o], [int(init[0][r][t])
                                                for t in o]
        buf, snap, c0 = [], set(), 0
        while c0 < N:
            cw = min(CHUNK, N - c0)
            if dedup:
                cw = min(cw, bn - c0 % bn)
                if c0 % bn == 0:
                    snap = set(si)
            kth = _ord(ss[-1])
            new = [(float(sims[r, c]), c) for c in range(c0, c0 + cw)
                   if _ord(sims[r, c]) > kth and b_ids[c] >= 0
                   and b_ids[c] != a_ids[r]]
            if len(buf) + len(new) > CAP:        # would overflow: merge
                ss, si = _merge(ss, si, buf, b_ids, snap, dedup)
                buf = []
            buf += [(s, c) for s, c in new if _ord(s) > _ord(ss[-1])]
            assert len(buf) <= CAP
            last = c0 + cw == N
            if buf and (last or (dedup and (c0 + cw) % bn == 0)):
                ss, si = _merge(ss, si, buf, b_ids, snap, dedup)
                buf = []
            c0 += cw
        states.append((ss, si))
    return states


@pytest.mark.parametrize("dedup,bn,k", [
    (False, 4096, 10),
    (True, 32, 10),
    (True, 100, 24),
    (False, 64, 300),          # k > N: empty slots stay last
    (True, 130, 7),
])
def test_batched_merge_matches_jax_oracle_on_ties(dedup, bn, k):
    x = _grid_points(240, 6, seed=bn + k)
    ids = np.arange(240, dtype=np.int32)
    b_ids = ids.copy()
    b_ids[::37] = -1                                   # some padding
    want = jref.topk_sqdist_ref(jnp.asarray(x), jnp.asarray(x), k,
                                a_ids=jnp.asarray(ids),
                                b_ids=jnp.asarray(b_ids), dedup=dedup, bn=bn)
    gi, gd = _batched_merge_model(x, x, k, a_ids=ids, b_ids=b_ids,
                                  dedup=dedup, bn=bn)
    np.testing.assert_array_equal(gi, np.asarray(want[0]))
    np.testing.assert_array_equal(gd, np.asarray(want[1]))
    pi, pd = ops.topk_sqdist(T(x), T(x), k, a_ids=T(ids), b_ids=T(b_ids),
                             dedup=dedup, bn=bn)
    np.testing.assert_array_equal(gi, pi.numpy())


def test_batched_merge_with_a_seeded_state():
    """A seed from an earlier fold, then every column again with dedup:
    the window fold's case (the seed is sorted, ties included)."""
    x = _grid_points(200, 5, seed=4)
    ids = np.arange(200, dtype=np.int32)
    k = 12
    seed = jref.topk_sqdist_ref(jnp.asarray(x), jnp.asarray(x[:90]), k,
                                a_ids=jnp.asarray(ids),
                                b_ids=jnp.asarray(ids[:90]))
    want = jref.topk_sqdist_ref(jnp.asarray(x), jnp.asarray(x), k,
                                a_ids=jnp.asarray(ids), b_ids=jnp.asarray(ids),
                                init_ids=seed[0], init_dists=seed[1],
                                dedup=True, bn=50)
    gi, gd = _batched_merge_model(
        x, x, k, a_ids=ids, b_ids=ids, dedup=True, bn=50,
        init=(np.asarray(seed[0]), np.asarray(seed[1])))
    np.testing.assert_array_equal(gi, np.asarray(want[0]))
    np.testing.assert_array_equal(gd, np.asarray(want[1]))


# ---------------------------------------------------------------------------
# the index form
# ---------------------------------------------------------------------------

def _gather(x, idx):
    """x[idx] with the rows of index -1 zero, as the index form reads."""
    return np.where((idx >= 0)[..., None], x[np.maximum(idx, 0)],
                    np.float32(0.0)).astype(np.float32)


@pytest.mark.parametrize("grouped,dedup", [(True, True), (False, False),
                                           (True, False)])
def test_index_form_matches_jax_on_gathered_blocks(grouped, dedup):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((150, 12)).astype(np.float32)
    G, M, N, k = (3, 20, 45, 8) if grouped else (1, 33, 70, 6)
    a_idx = rng.integers(0, 150, (G, M)).astype(np.int32)
    b_idx = rng.integers(0, 150, (G, N)).astype(np.int32)
    a_idx[:, -2:] = -1                                  # padding rows
    b_idx[:, 5] = -1
    b_ids = b_idx.copy()
    if not grouped:
        a_idx, b_idx, b_ids = a_idx[0], b_idx[0], b_ids[0]

    got = ops.topk_sqdist(T(x), T(x), k, a_idx=T(a_idx), b_idx=T(b_idx),
                          a_ids=T(a_idx), b_ids=T(b_ids), dedup=dedup, bn=16)
    scale = 2.0 * float((x * x).sum(-1).max())
    gi, gd = (t.numpy().reshape(G, M, k) for t in got)
    for g in range(G):                   # the JAX oracle takes one problem
        ai, bi, bid = (t.reshape(G, -1)[g] for t in (a_idx, b_idx, b_ids))
        want = jref.topk_sqdist_ref(
            jnp.asarray(_gather(x, ai)), jnp.asarray(_gather(x, bi)), k,
            a_ids=jnp.asarray(ai), b_ids=jnp.asarray(bid), dedup=dedup,
            bn=16)
        np.testing.assert_array_equal(gi[g], np.asarray(want[0]))
        np.testing.assert_allclose(gd[g], np.asarray(want[1]), rtol=1e-6,
                                   atol=1e-6 * scale)


def test_window_fold_reads_x_in_place():
    """The fold's arguments are x itself and row indices; through the
    plain version they give what the JAX oracle gives on the gathered
    blocks."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((300, 10)).astype(np.float32)
    code = T(rng.integers(0, 8, 300).astype(np.int32))
    k, W = 9, 16
    run_i = torch.full((300, k), -1, dtype=torch.int32)
    run_d = torch.full((300, k), tref.INVALID_DIST)
    a, b, kw, _ = knn.window_fold_args(T(x), code, k, W, run_i, run_d)
    assert a.data_ptr() == b.data_ptr() and tuple(a.shape) == (300, 10)
    got = ops.topk_sqdist(a, b, k, **kw)
    for g in range(kw["a_idx"].shape[0]):
        jkw = {n: jnp.asarray(kw[n][g].numpy()) for n in
               ("a_ids", "b_ids", "init_ids", "init_dists")}
        want = jref.topk_sqdist_ref(
            jnp.asarray(_gather(x, kw["a_idx"][g].numpy())),
            jnp.asarray(_gather(x, kw["b_idx"][g].numpy())), k, dedup=True,
            bn=kw["bn"], **jkw)
        np.testing.assert_array_equal(got[0][g].numpy(), np.asarray(want[0]))


def test_new_launcher_arguments_refuse_cpu_tensors():
    """The index form and the step-sized scatter launch on the card only:
    on CPU tensors they raise, and only ``ops`` runs the plain version."""
    x = torch.randn(20, 4)
    idx = torch.arange(20, dtype=torch.int32)
    with pytest.raises(ValueError):
        knn_topk.topk_sqdist(x, x, 3, a_idx=idx, b_idx=idx)
    with pytest.raises(ValueError):
        largevis_step.scatter_add_ordered(torch.zeros(5, 2),
                                          torch.zeros(7, dtype=torch.long),
                                          torch.ones(7, 2))
    ids, _ = ops.topk_sqdist(x, x, 3, a_idx=idx, b_idx=idx, a_ids=idx,
                             b_ids=idx)
    assert tuple(ids.shape) == (20, 3)
    assert knn_topk.topk_sqdist.launches == 0
    assert largevis_step.scatter_add_ordered.launches == 0


def test_scatter_size_rule_keeps_the_in_degree_sum_on_the_sort():
    """Every step-sized stream takes the linked lists; the negative
    sampler's in-degree sum (U = N*K) takes the sort."""
    assert 4096 * (2 + 5) <= largevis_step.LINK_MAX_U
    assert 10_000 * (2 + 5) <= largevis_step.LINK_MAX_U  # transform step
    assert 100_000 * 150 > largevis_step.LINK_MAX_U
