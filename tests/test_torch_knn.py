"""The port's KNN graph stage against the JAX package, on the CPU.

The same numpy inputs — points, projection hyperplanes, a starting
graph — go through ``repro.core.knn``/``neighbor_explore`` and their
counterparts in ``repro_torch`` (plain versions of the kernels on CPU
tensors).  Neighbor ids must be equal slot for slot: every top-k and
argsort in the port is stable, as JAX's are.  Distances agree within
rtol 1e-6 plus an atol of 1e-6 * max|x|^2 (norms and candidate distances
are summed in another order than XLA's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn as jknn
from repro.core import neighbor_explore as jexp
from repro.data.synthetic import gaussian_mixture
from repro_torch.core import knn as tknn
from repro_torch.core import neighbor_explore as texp

KEY = jax.random.key(3)
N, D, K, TREES, WINDOW = 1000, 32, 10, 3, 32


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True)
def _autotune_off(monkeypatch):
    monkeypatch.setenv("AUTOTUNE", "off")


@pytest.fixture(scope="module")
def x():
    return np.asarray(gaussian_mixture(KEY, N, D, 8)[0])


@pytest.fixture(scope="module")
def forest(x):
    """JAX's forest graph, and the hyperplanes it drew from KEY."""
    depth = jknn._auto_depth(N, 64)
    idx, dist = jknn.forest_knn(jnp.asarray(x), KEY, n_trees=TREES,
                                depth=depth, k=K, window=WINDOW)
    proj = jax.random.normal(KEY, (D, TREES * depth), jnp.float32)
    return np.asarray(idx), np.asarray(dist), np.asarray(proj), depth


def _assert_graph(got, want, x):
    gi, gd = (t.numpy() for t in got)
    wi, wd = (np.asarray(t) for t in want)
    n_diff = int((gi != wi).sum())
    assert n_diff == 0, f"{n_diff} neighbor slot(s) differ"
    np.testing.assert_allclose(gd, wd, rtol=1e-6,
                               atol=1e-6 * float((x * x).sum(1).max()))


def test_hash_codes_equal_with_shared_proj(x, forest):
    proj, depth = forest[2], forest[3]
    want = jknn.hash_codes(jnp.asarray(x), None, TREES, depth,
                           proj=jnp.asarray(proj))
    got = tknn.hash_codes(T(x), TREES, depth, proj=T(proj))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forest_knn_ids_equal(x, forest):
    """The whole forest, fed JAX's hyperplanes: no slot differs."""
    idx, dist, proj, depth = forest
    got = tknn.forest_knn(T(x), n_trees=TREES, depth=depth, k=K,
                          window=WINDOW, proj=T(proj))
    _assert_graph(got, (idx, dist), x)


@pytest.mark.parametrize("r_cap", [K, 3])
def test_reverse_neighbors_equal(forest, r_cap):
    """Includes rows with more than r_cap reverse edges (r_cap=3)."""
    idx = forest[0]
    want = jexp.reverse_neighbors(jnp.asarray(idx), r_cap)
    got = texp.reverse_neighbors(T(idx), r_cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tile", [None, 96])
def test_neighbor_explore_ids_equal(x, forest, tile):
    """One full exploring round (sample=0) from JAX's forest graph, in one
    row tile and in several (a ragged last one included)."""
    idx, dist = forest[0], forest[1]
    want = jexp.neighbor_explore(jnp.asarray(x), jnp.asarray(idx),
                                 jnp.asarray(dist), iters=1, sample=0)
    got = texp.neighbor_explore(T(x), T(idx), T(dist), iters=1, sample=0,
                                tile=tile)
    _assert_graph(got, want, x)


def test_merge_candidates_equal():
    """Repeated ids, self edges and tied distances: equal ids and dists."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 40, (50, 60)).astype(np.int32)
    dists = rng.integers(0, 20, (50, 60)).astype(np.float32)   # many ties
    rows = np.arange(50, dtype=np.int32) % 40
    want = jknn.merge_candidates(jnp.asarray(ids), jnp.asarray(dists), 12,
                                 self_idx=jnp.asarray(rows))
    got = tknn.merge_candidates(T(ids), T(dists), 12, self_idx=T(rows))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_brute_force_knn_and_recall_equal(x, forest):
    want = jknn.brute_force_knn(jnp.asarray(x), K)
    got = tknn.brute_force_knn(T(x), K)
    _assert_graph(got, want, x)
    r_jax = jknn.knn_recall(jnp.asarray(forest[0]), want[0])
    r_port = tknn.knn_recall(T(forest[0]), got[0], tile=300)
    assert r_port == pytest.approx(r_jax, abs=1e-6)
