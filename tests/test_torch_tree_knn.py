"""The port's random-projection tree forest (``rp_mode="tree"``) against
the JAX package, on the CPU.

JAX draws every node's pair inside ``tree_codes`` with
``randint(fold_in(fold_in(key, t), level), (2**level, 2), 0, N)``; the
test rebuilds those pairs in heap order and hands them to the port.  The
side test x.h > b is a dot product that XLA and PyTorch sum in their own
orders, so a point within rounding of a plane may take the other side.
Codes must be equal except at such points: a flipped point must lie
within |x.h - b| <= 4 d 2^-23 (|x| |h| + |b|) of the plane that split it
(``knn.tree_code_flips``), and the assertion names it.  Where no point
flips, the forest's graph equals JAX's slot for slot, distances within
``test_torch_knn.py``'s tolerance (rtol 1e-6, atol 1e-6 max|x|^2),
except where two candidates tie within it (``_graph_vs_jax``);
otherwise the graph is held by recall against brute force, within 0.01
of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.largevis_default import LargeVisConfig as JConfig
from repro.core import knn as jknn
from repro.data.synthetic import gaussian_mixture
from repro_torch import LargeVisConfig, largevis
from repro_torch.core import knn as tknn
from repro_torch.core import metrics
from repro_torch.kernels import ops
from torch_threads import few_threads

KEY = jax.random.key(3)


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True)
def _autotune_off(monkeypatch):
    monkeypatch.setenv("AUTOTUNE", "off")


def jax_pairs(key, N: int, n_trees: int, depth: int) -> np.ndarray:
    """The pairs JAX's ``tree_codes`` draws, (n_trees, 2**depth - 1, 2)
    in heap order."""
    pairs = np.zeros((n_trees, (1 << depth) - 1, 2), np.int32)
    for t in range(n_trees):
        tkey = jax.random.fold_in(key, t)
        for level in range(depth):
            lkey = jax.random.fold_in(tkey, level)
            pairs[t, (1 << level) - 1:(1 << (level + 1)) - 1] = np.asarray(
                jax.random.randint(lkey, (1 << level, 2), 0, N))
    return pairs


def _mixture(N, D, seed=3):
    return np.asarray(gaussian_mixture(jax.random.key(seed), N, D, 8)[0])


def _assert_codes(x, pairs, got, want, depth):
    pt, tr, margin, bound = tknn.tree_code_flips(x, pairs, got, want, depth)
    far = margin > bound
    assert not far.any(), (
        f"points {pt[far].tolist()} (trees {tr[far].tolist()}) flipped at "
        f"margins {margin[far].tolist()} beyond {bound[far].tolist()}")
    return pt


@pytest.mark.parametrize("N,D,trees,depth", [(1000, 32, 3, 4),
                                             (3000, 64, 2, 6),
                                             (700, 5, 4, 7)])
def test_tree_codes_match_jax(N, D, trees, depth):
    x = _mixture(N, D)
    want = np.asarray(jknn.tree_codes(jnp.asarray(x), KEY, trees, depth))
    pairs = jax_pairs(KEY, N, trees, depth)
    got = tknn.tree_codes(T(x), trees, depth, pairs=T(pairs)).numpy()
    assert got.shape == want.shape and got.dtype == np.int32
    flipped = _assert_codes(x, pairs, got, want, depth)
    same = np.ones(N, bool)
    same[flipped] = False
    np.testing.assert_array_equal(got[same], want[same])


def test_tree_code_flips_names_the_splitting_plane():
    """A code bit flipped by hand at a known level is traced back to the
    node both codings reached, with its margin in f64."""
    N, D, depth = 400, 8, 5
    x = _mixture(N, D)
    pairs = jax_pairs(KEY, N, 2, depth)
    codes = tknn.tree_codes(T(x), 2, depth, pairs=T(pairs)).numpy()
    other = codes.copy()
    level = 2
    other[17, 1] ^= 1 << (depth - 1 - level)
    pt, tr, margin, bound = tknn.tree_code_flips(x, pairs, codes, other,
                                                 depth)
    assert pt.tolist() == [17] and tr.tolist() == [1]
    node = pairs[1, (1 << level) - 1 + (codes[17, 1] >> (depth - level))]
    h = (x[node[0]] - x[node[1]]).astype(np.float64)
    b = (h * (x[node[0]] + x[node[1]]).astype(np.float64) * 0.5).sum()
    assert margin[0] == pytest.approx(abs(x[17].astype(np.float64) @ h - b),
                                      rel=1e-12)
    assert bound[0] > 0
    none = tknn.tree_code_flips(x, pairs, codes, codes, depth)
    assert all(len(a) == 0 for a in none)


def test_tree_codes_pair_of_one_point_goes_left():
    """a == b gives h = 0 and b = 0: no point goes right."""
    x = T(_mixture(200, 6))
    pairs = torch.zeros((2, 7, 2), dtype=torch.int32)
    assert int(tknn.tree_codes(x, 2, 3, pairs=pairs).abs().sum()) == 0


def test_tree_codes_drawn_from_the_generator():
    """Without pairs, the same generator seed gives the same codes."""
    x = T(_mixture(500, 16))
    a = tknn.tree_codes(x, 3, 5, generator=torch.Generator().manual_seed(1))
    b = tknn.tree_codes(x, 3, 5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and int(a.max()) < 32
    assert len(torch.unique(a[:, 0])) > 8


def _graph_vs_jax(x, got, want):
    """Slot for slot, distances within the tolerance.  A slot may hold
    another id only where the two candidates tie within that tolerance
    (their f64 distances to the row's point), as the hash forest's graph
    does at the same shapes: XLA and PyTorch round distances apart."""
    gi, gd = (t.numpy() for t in got)
    wi, wd = (np.asarray(t) for t in want)
    atol = 1e-6 * float((x * x).sum(1).max())
    np.testing.assert_allclose(gd, wd, rtol=1e-6, atol=atol)
    r, c = np.nonzero(gi != wi)
    x64 = x.astype(np.float64)
    d_got = ((x64[gi[r, c]] - x64[r]) ** 2).sum(1)
    d_want = ((x64[wi[r, c]] - x64[r]) ** 2).sum(1)
    untied = np.abs(d_got - d_want) > 1e-6 * np.abs(d_want) + atol
    assert not untied.any(), (
        f"slots {list(zip(r[untied].tolist(), c[untied].tolist()))} hold "
        f"other neighbours than JAX's, not tied")
    assert len(r) <= 1e-3 * gi.size, f"{len(r)} tied slots swapped"


def _recall_vs_jax(x, got_idx, want_idx, k):
    true = jknn.brute_force_knn(jnp.asarray(x), k)[0]
    r_jax = jknn.knn_recall(jnp.asarray(want_idx), true)
    r_port = tknn.knn_recall(torch.as_tensor(got_idx), T(np.asarray(true)))
    assert abs(r_port - r_jax) <= 0.01, (r_port, r_jax)


@pytest.mark.parametrize("N,D,trees,k,window", [(1000, 32, 3, 10, 32),
                                                (1500, 12, 4, 15, 24)])
def test_tree_forest_graph_matches_jax(N, D, trees, k, window):
    x = _mixture(N, D)
    depth = jknn._auto_depth(N, 64)
    want = jknn.forest_knn(jnp.asarray(x), KEY, n_trees=trees, depth=depth,
                           k=k, window=window, rp_mode="tree")
    pairs = jax_pairs(KEY, N, trees, depth)
    got = tknn.forest_knn(T(x), n_trees=trees, depth=depth, k=k,
                          window=window, rp_mode="tree", pairs=T(pairs))
    codes = tknn.tree_codes(T(x), trees, depth, pairs=T(pairs)).numpy()
    jcodes = np.asarray(jknn.tree_codes(jnp.asarray(x), KEY, trees, depth))
    flipped = _assert_codes(x, pairs, codes, jcodes, depth)
    if len(flipped) == 0:
        _graph_vs_jax(x, got, want)
    else:
        _recall_vs_jax(x, got[0], want[0], k)


def test_tree_build_knn_graph_matches_jax():
    """Forest + one full exploring round, through ``build_knn_graph``."""
    N, D = 1200, 24
    x = _mixture(N, D, seed=5)
    key = jax.random.key(11)
    kw = dict(n_neighbors=12, n_trees=3, n_explore_iters=1, window=32,
              rp_mode="tree")
    want = jknn.build_knn_graph(jnp.asarray(x), key, JConfig(**kw))
    depth = jknn._auto_depth(N, 64)
    pairs = jax_pairs(key, N, 3, depth)
    got = tknn.build_knn_graph(T(x), LargeVisConfig(**kw), pairs=T(pairs))
    codes = tknn.tree_codes(T(x), 3, depth, pairs=T(pairs)).numpy()
    jcodes = np.asarray(jknn.tree_codes(jnp.asarray(x), key, 3, depth))
    if len(_assert_codes(x, pairs, codes, jcodes, depth)) == 0:
        _graph_vs_jax(x, got, want)
    else:
        _recall_vs_jax(x, got[0], want[0], 12)


def test_tree_forest_folds_through_topk_sqdist(monkeypatch):
    """One ``topk_sqdist`` call a tree: the tree codes fold as the hash
    codes do."""
    calls = []
    real = ops.topk_sqdist

    def spy(*a, **kw):
        calls.append(kw.get("dedup"))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "topk_sqdist", spy)
    x = T(_mixture(600, 16))
    tknn.forest_knn(x, n_trees=5, depth=4, k=8, window=16, rp_mode="tree",
                    generator=torch.Generator().manual_seed(0))
    assert calls == [True] * 5
    with pytest.raises(ValueError, match="rp_mode"):
        tknn.forest_knn(x, n_trees=1, depth=2, k=4, window=8, rp_mode="lsh")


def test_tree_mode_fit_on_cpu():
    """``LargeVisConfig(rp_mode="tree")`` fits through
    ``repro_torch.largevis`` to the package's quality bar (the fixture of
    ``test_torch_pipeline.py``: 5-NN accuracy >= 0.95)."""
    x, labels = gaussian_mixture(jax.random.key(0), 2000, 32, 8)
    x, labels = np.asarray(x), np.asarray(labels)
    cfg = LargeVisConfig(rp_mode="tree", n_neighbors=15, n_trees=4,
                         n_explore_iters=2, window=32, perplexity=10.0,
                         samples_per_node=2000)
    with few_threads():
        res = largevis(x, cfg=cfg, device="cpu")
    assert res.y.shape == (2000, 2) and bool(torch.isfinite(res.y).all())
    assert tuple(res.knn_idx.shape) == (2000, 15)
    assert metrics.graph_recall(res.x, res.knn_idx) >= 0.9
    assert metrics.knn_classifier_accuracy(res.y, labels) >= 0.95
