"""The port's kernel modules against the JAX package's oracles, on the CPU.

The same numpy inputs go through ``repro.kernels.ref`` (the JAX oracles)
and ``repro_torch.kernels.ops``, which on CPU tensors runs each kernel's
plain PyTorch version.  The CUDA kernels themselves are held to these
plain versions on the card by ``chip_smoke.py``.

Tolerances:
* top-k ids are compared exactly; distances within rtol 1e-6 plus an
  atol of 1e-6 * (max |a|^2 + max |b|^2), because the port sums the row
  norms in another order than XLA (the dot products agree bitwise), and
  |a|^2 + |b|^2 - 2ab cancels down to the distance;
* the edge step is compared bitwise with the *eager* oracle: the jitted
  oracle contracts multiply-adds into FMAs on the CPU and moves by an
  ulp, while the port, eager JAX and the CUDA kernel round every
  operation on its own;
* pairwise distances within rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import knn_topk, largevis_step, ops
from repro_torch.kernels import ref as tref

GAMMA, A, CLIP = 7.0, 1.0, 5.0


def T(x):
    return torch.from_numpy(np.array(x))


def _pair(m, n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _assert_topk(got, want, a, b):
    gi, gd = got
    wi, wd = want
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    scale = float((a * a).sum(-1).max() + (b * b).sum(-1).max())
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6,
                               atol=1e-6 * scale)


# ---------------------------------------------------------------------------
# topk_sqdist
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,d,k,bn", [
    (64, 64, 32, 5, 32),        # even multi-tile
    (100, 80, 7, 5, 16),        # odd M, N, d
    (33, 17, 3, 20, 8),         # k > bn AND k > N (invalid tail)
    (256, 512, 100, 20, 128),   # larger sweep
    (130, 1, 5, 1, 8),          # single column
])
def test_topk_matches_jax_oracle(m, n, d, k, bn):
    a, b = _pair(m, n, d, seed=m + n)
    want = jref.topk_sqdist_ref(jnp.asarray(a), jnp.asarray(b), k, bn=bn)
    _assert_topk(ops.topk_sqdist(T(a), T(b), k, bn=bn), want, a, b)


def _mixture(n, d, seed):
    from repro.data.synthetic import gaussian_mixture
    x, _ = gaussian_mixture(jax.random.key(seed), n, d, 4)
    return np.asarray(x)


def test_topk_self_edges_init_and_dedup():
    """Self masking, seeding from a state and dedup agree with the JAX
    oracle; re-folding the same candidates with dedup changes nothing."""
    x = _mixture(200, 16, 3)
    ids = np.arange(200, dtype=np.int32)
    jkw = dict(a_ids=jnp.asarray(ids), b_ids=jnp.asarray(ids), bn=64)
    tkw = dict(a_ids=T(ids), b_ids=T(ids), bn=64)
    want = jref.topk_sqdist_ref(jnp.asarray(x), jnp.asarray(x), 8, **jkw)
    got = ops.topk_sqdist(T(x), T(x), 8, **tkw)
    _assert_topk(got, want, x, x)
    assert (got[0].numpy() != ids[:, None]).all(), "self edges"
    want2 = jref.topk_sqdist_ref(jnp.asarray(x), jnp.asarray(x), 8,
                                 init_ids=want[0], init_dists=want[1],
                                 dedup=True, **jkw)
    got2 = ops.topk_sqdist(T(x), T(x), 8, init_ids=got[0],
                           init_dists=got[1], dedup=True, **tkw)
    _assert_topk(got2, want2, x, x)
    np.testing.assert_array_equal(got2[0].numpy(), got[0].numpy())


def test_topk_duplicate_ids_dedup():
    """Repeated candidate ids across column tiles: the first-seen copy
    wins in both packages and no id survives twice in a row."""
    a, b = _pair(48, 64, 8, seed=7)
    b_ids = (np.arange(64) % 29).astype(np.int32)
    want = jref.topk_sqdist_ref(jnp.asarray(a), jnp.asarray(b), 6,
                                b_ids=jnp.asarray(b_ids), dedup=True, bn=16)
    got = ops.topk_sqdist(T(a), T(b), 6, b_ids=T(b_ids), dedup=True, bn=16)
    _assert_topk(got, want, a, b)
    for row in got[0].numpy():
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real), "dup id survived"


def test_topk_bucket_codes():
    """Bucket-code masking agrees, and every neighbor shares a bucket."""
    x = _mixture(160, 12, 5)
    ids = np.arange(160, dtype=np.int32)
    codes = np.random.default_rng(5).integers(0, 4, (160, 3)).astype(
        np.int32)
    want = jref.topk_sqdist_ref(
        jnp.asarray(x), jnp.asarray(x), 8, a_ids=jnp.asarray(ids),
        b_ids=jnp.asarray(ids), codes_a=jnp.asarray(codes),
        codes_b=jnp.asarray(codes), bn=64)
    got = ops.topk_sqdist(T(x), T(x), 8, a_ids=T(ids), b_ids=T(ids),
                          codes_a=T(codes), codes_b=T(codes), bn=64)
    _assert_topk(got, want, x, x)
    for i, row in enumerate(got[0].numpy()):
        for g in row[row >= 0]:
            assert (codes[i] == codes[g]).any(), (i, g)


def test_topk_grouped_equals_per_group():
    """The leading group dimension runs independent problems."""
    a, b = _pair(5 * 16, 5 * 40, 12, seed=9)
    a, b = a.reshape(5, 16, 12), b.reshape(5, 40, 12)
    gi, gd = ops.topk_sqdist(T(a), T(b), 7)
    for g in range(5):
        wi, wd = ops.topk_sqdist(T(a[g]), T(b[g]), 7)
        assert torch.equal(gi[g], wi) and torch.equal(gd[g], wd)


def test_topk_sorted_and_exact():
    """Ascending distances, and the neighbor sets of an exact f64 search."""
    x = _mixture(500, 24, 4)
    ids = T(np.arange(500, dtype=np.int32))
    ri, rd = ops.topk_sqdist(T(x), T(x), 10, a_ids=ids, b_ids=ids, bn=128)
    assert (np.diff(rd.numpy(), axis=1) >= 0).all(), "not ascending"
    dd = ((x[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    np.fill_diagonal(dd, np.inf)
    np.testing.assert_allclose(rd.numpy(), np.sort(dd, 1)[:, :10],
                               atol=1e-3)
    want_ids = np.argsort(dd, 1, kind="stable")[:, :10]
    assert (np.sort(ri.numpy(), 1) == np.sort(want_ids, 1)).mean() > 0.999


def test_tie_order_is_earliest_position_not_torch_topk():
    """Similarities [1,3,3,2,3] (distances [3,1,1,2,1]) with k=3: the
    earliest position wins among ties, ids [1,2,4], as lax.top_k orders
    them; torch.topk's order ([2,4,1] on the CPU) is not used."""
    a = np.zeros((1, 3), np.float32)
    b = np.array([[1, 1, 1], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0, 0, 1]],
                 np.float32)
    got = ops.topk_sqdist(T(a), T(b), 3)
    assert got[0].tolist() == [[1, 2, 4]]
    assert got[1].tolist() == [[1.0, 1.0, 1.0]]
    want = jax.lax.top_k(jnp.asarray([1.0, 3.0, 3.0, 2.0, 3.0]), 3)[1]
    assert np.asarray(want).tolist() == [1, 2, 4]
    from repro_torch.core.knn import merge_candidates
    mi, _ = merge_candidates(T(np.arange(5, dtype=np.int32)[None]),
                             T(np.array([[3, 1, 1, 2, 1]], np.float32)), 3)
    assert mi.tolist() == [[1, 2, 4]]


# ---------------------------------------------------------------------------
# fused_edge_step
# ---------------------------------------------------------------------------

def _batch(N=50, B=4096, M=5, s=2, seed=0, lo=0):
    """An edge batch; the default shape is dense with duplicates.  Most
    tests share it: the eager oracle compiles each op once per shape."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((N, s)).astype(np.float32)
    i = rng.integers(lo, N, B).astype(np.int32)
    j = rng.integers(lo, N, B).astype(np.int32)
    negs = rng.integers(lo, N, (B, M)).astype(np.int32)
    mask = ((negs != i[:, None]) & (negs != j[:, None])).astype(np.float32)
    return y, i, j, negs, mask


def _both(y, i, j, negs, mask, lr, n_frozen=0):
    """(port, eager JAX oracle) on the same inputs."""
    want = jref.fused_edge_step_ref(
        jnp.asarray(y), jnp.asarray(i), jnp.asarray(j), jnp.asarray(negs),
        jnp.asarray(mask), jnp.asarray(lr), gamma=GAMMA, a=A, clip=CLIP,
        n_frozen=n_frozen)
    got = ops.largevis_edge_step(
        T(y), T(i), T(j), T(negs), T(mask),
        T(lr) if np.ndim(lr) else float(lr), gamma=GAMMA, a=A, clip=CLIP,
        n_frozen=n_frozen)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("N,B", [(300, 37), (50, 4096)])
def test_edge_step_matches_jax_oracle_bitwise(N, B):
    got, want = _both(*_batch(N, B, seed=N + B), 0.37)
    np.testing.assert_array_equal(got, want)


def test_edge_step_duplicates_accumulate_in_canonical_order():
    """Every row is drawn many times over as i, j and negative: bitwise
    the oracle, and close to a numpy loop in the canonical per-edge order
    [i_e, j_e, negs_e,0..M-1] (accumulate, not last-write-wins)."""
    y, i, j, negs, mask = _batch(seed=3)
    got, want = _both(y, i, j, negs, mask, 0.21)
    np.testing.assert_array_equal(got, want)
    gi, gj, gn = (g.numpy() for g in tref.largevis_grads_ref(
        T(y[i]), T(y[j]), T(y[negs]), gamma=GAMMA, a=A, clip=CLIP,
        neg_mask=T(mask)))
    yn = y.copy()
    lr = np.float32(0.21)
    for e in range(i.shape[0]):
        yn[i[e]] += -lr * gi[e]
        yn[j[e]] += -lr * gj[e]
        for m in range(negs.shape[1]):
            yn[negs[e, m]] += -lr * gn[e, m]
    np.testing.assert_allclose(got, yn, atol=1e-4, rtol=1e-4)


def test_edge_step_forces_match_jax_oracle_bitwise():
    """The Eqn-6 forces alone, with the left-to-right negative sum."""
    y, i, j, negs, mask = _batch(seed=4)
    want = jref.largevis_grads_ref(jnp.asarray(y[i]), jnp.asarray(y[j]),
                                   jnp.asarray(y[negs]),
                                   neg_mask=jnp.asarray(mask))
    got = tref.largevis_grads_ref(T(y[i]), T(y[j]), T(y[negs]),
                                  neg_mask=T(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_edge_step_masked_negatives_leave_rows_untouched():
    """Edges in rows [0, 40), every negative row 47 and masked: rows only
    reached through masked negatives, and rows nobody reaches, keep their
    bits."""
    y, i, j, negs, mask = _batch(seed=5)
    i, j = i % 40, j % 40
    negs[:] = 47
    mask[:] = 0.0
    got, want = _both(y, i, j, negs, mask, 0.8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[40:], y[40:])
    assert not np.array_equal(got[:40], y[:40])


def test_edge_step_padding_rows_are_noops():
    """A batch whose edges avoid row 0 leaves row 0 bitwise intact."""
    y, i, j, negs, mask = _batch(seed=6, lo=1)
    got, want = _both(y, i, j, negs, mask, 0.9)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], y[0])


def test_edge_step_frozen_rows_and_per_edge_lr():
    """Rows below n_frozen keep their bits; a (B,) lr is bitwise the
    oracle's; a broadcast vector equals the scalar."""
    y, i, j, negs, mask = _batch(seed=8)
    lr = np.random.default_rng(8).uniform(0.1, 1.0, i.shape[0]).astype(
        np.float32)
    got, want = _both(y, i, j, negs, mask, lr, n_frozen=20)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:20], y[:20])
    assert not np.array_equal(got[20:], y[20:])
    flat = ops.largevis_edge_step(T(y), T(i), T(j), T(negs), T(mask),
                                  torch.full((i.shape[0],), 0.5))
    scalar = ops.largevis_edge_step(T(y), T(i), T(j), T(negs), T(mask), 0.5)
    assert torch.equal(flat, scalar)


# ---------------------------------------------------------------------------
# pairwise_sqdist and routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,d", [(37, 91, 5), (120, 300, 100), (50, 64, 2),
                                   # off the CUDA kernel's 128 x 128 tiles
                                   (129, 257, 1), (130, 131, 2),
                                   (255, 383, 3), (131, 260, 17),
                                   (200, 129, 100), (1, 129, 17)])
def test_pairwise_matches_jax_oracle(m, n, d):
    a, b = _pair(m, n, d, seed=m)
    want = jref.pairwise_sqdist_ref(jnp.asarray(a), jnp.asarray(b))
    got = ops.pairwise_sqdist(T(a), T(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("shape", [(7, 1), (5, 3, 100), (64, 33)])
def test_sq_norms_sum_left_to_right_in_feature_order(shape):
    """The plain versions' row norms, which the CUDA kernels reproduce:
    every product and every partial sum rounded to f32 on its own, in
    feature order."""
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32) * 3.0
    want = np.zeros(shape[:-1], np.float32)
    for q in range(shape[-1]):
        want = (want + x[..., q] * x[..., q]).astype(np.float32)
    np.testing.assert_array_equal(tref.sq_norms(T(x)).numpy(), want)


def test_launchers_name_the_grid_limit():
    """A launch of more than 2^31 - 1 blocks is refused with its size."""
    knn_topk._check_blocks("topk_sqdist", knn_topk.MAX_BLOCKS)
    with pytest.raises(ValueError, match="2147483647"):
        knn_topk._check_blocks("topk_sqdist", 70_000 * 31_000)


def test_cuda_launchers_refuse_cpu_tensors():
    """On a CPU tensor only the plain version runs: the launchers never
    take it, so nothing can fall back silently."""
    a, b = _pair(8, 8, 4, seed=1)
    with pytest.raises(ValueError):
        knn_topk.topk_sqdist(T(a), T(b), 3)
    with pytest.raises(ValueError):
        knn_topk.pairwise_sqdist(T(a), T(b))
    y, i, j, negs, mask = _batch(10, 4)
    with pytest.raises(ValueError):
        largevis_step.fused_edge_step(T(y), T(i), T(j), T(negs), T(mask),
                                      0.1)
    assert ops.launch_counts() == {"topk_sqdist": 0, "fused_edge_step": 0,
                                   "pairwise_sqdist": 0, "largevis_grads": 0,
                                   "scatter_add_ordered": 0,
                                   "flash_attention": 0,
                                   "flash_attention_bwd": 0}
