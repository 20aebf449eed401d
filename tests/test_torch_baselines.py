"""The port's baselines (``repro_torch.core.baselines``) and
``data.synthetic.swiss_roll`` against the JAX package, on the CPU.

Each test hands both packages the same numpy inputs or the JAX package's
own draws:

* LINE: one step from the same y with JAX's edge batch and negatives;
  within atol 1e-6 + rtol 1e-5 of JAX's ``line_step`` (JAX scatters
  autodiff's gradient in XLA's order, the port in stream order); two
  runs of ``line_layout`` from one seed are bitwise equal, and every
  step adds its gradient with one ``scatter_add_ordered``;
* t-SNE and symmetric SNE: 10 iterations of ``tsne_layout`` from JAX's
  y0 at N = 300; y within 1e-4 of max|y| (the (N, N) sums and the W @ y
  product are summed in other orders than XLA's), the KL within rtol
  1e-5;
* NN-Descent: from JAX's random initial graph, ids equal slot for slot,
  distances within the ``test_torch_knn.py`` tolerance;
* VP-tree: ``vptree_knn``, whose tree both packages build with
  ``default_rng(0)``, ids exactly JAX's;
* ``swiss_roll``: the formula fed JAX's draws, within rtol 1e-6, labels
  equal.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn as jknn
from repro.core import perplexity as jperp
from repro.core import sampler as jsamp
from repro.core.baselines import line as jline
from repro.core.baselines import nn_descent as jnnd
from repro.core.baselines import tsne as jtsne
from repro.core.baselines import vptree as jvp
from repro.data import synthetic as jsyn
from repro_torch.core import layout_engine, metrics
from repro_torch.core import sampler as tsamp
from repro_torch.core.baselines import line as tline
from repro_torch.core.baselines import nn_descent as tnnd
from repro_torch.core.baselines import tsne as ttsne
from repro_torch.core.baselines import vptree as tvp
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops

N, D, K = 300, 16, 10


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True)
def _autotune_off(monkeypatch):
    monkeypatch.setenv("AUTOTUNE", "off")


@pytest.fixture(scope="module")
def graph():
    """A 4-cluster mixture, its exact KNN graph, weights and labels."""
    x, labels = jsyn.gaussian_mixture(jax.random.key(1), N, D, 4)
    idx, dist = jknn.brute_force_knn(x, K)
    w = jperp.edge_weights(idx, dist, 5.0)
    return (np.asarray(x), np.asarray(labels), np.asarray(idx),
            np.asarray(dist), np.asarray(w))


@pytest.fixture(scope="module")
def jax_samplers(graph):
    _, _, idx, _, w = graph
    return (jsamp.build_edge_sampler(idx, w, impl="host"),
            jsamp.build_negative_sampler(idx, w, impl="host"))


@pytest.mark.parametrize("rho0,t_frac,batch", [(0.025, 0.0, 256),
                                               (0.025, 0.37, 256),
                                               (1.0, 0.0, 1024),
                                               (1.0, 0.99995, 64)])
def test_line_step_matches_jax(graph, jax_samplers, rho0, t_frac, batch):
    """JAX's draws (``split(key)`` into the edge and negative keys, as its
    ``line_step`` does) through the port's update; rho0 = 1.0 clips."""
    jes, jns = jax_samplers
    key = jax.random.key(7)
    y = np.asarray(jax.random.normal(jax.random.key(8), (N, 2))) * 0.5
    want = np.asarray(jline.line_step(
        jnp.asarray(y), key, jnp.float32(t_frac), edge_sampler=jes,
        neg_sampler=jns, n_negatives=5, batch=batch, rho0=rho0))
    ke, kn = jax.random.split(key)
    i, j = jes.sample(ke, batch)
    negs = jns.sample(kn, (batch, 5))
    got = tline.line_update(T(y), T(i), T(j), T(negs),
                            layout_engine.step_lr(rho0, t_frac)).numpy()
    assert np.abs(want - y).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_line_layout_bitwise_and_one_scatter_a_step(graph, monkeypatch):
    _, _, idx, _, w = graph
    es = tsamp.build_edge_sampler(T(idx), T(w))
    ns = tsamp.build_negative_sampler(T(idx), T(w))
    scatters = []
    real = ops.scatter_add_ordered

    def spy(y, i, u):
        scatters.append(i.shape[0])
        return real(y, i, u)

    monkeypatch.setattr(ops, "scatter_add_ordered", spy)
    runs = [tline.line_layout(torch.Generator().manual_seed(3), es, ns, N,
                              samples_per_node=200, batch=128)
            for _ in range(2)]
    (y1, steps), (y2, _) = runs
    assert steps == 200 * N // 128
    assert scatters == [128 * 7] * (2 * steps)       # i, j and 5 negatives
    assert torch.equal(y1, y2) and bool(torch.isfinite(y1).all())
    assert float(y1.abs().max()) > 1e-2          # moved from its N(0, 1e-6)


@pytest.mark.parametrize("student_t,lr", [(True, 200.0), (False, 20.0)])
def test_tsne_layout_matches_jax(graph, student_t, lr):
    """10 iterations, 5 of them exaggerated, from JAX's y0 (its default
    key); symmetric SNE at fig5's lr of 20."""
    _, _, idx, _, w = graph
    y_j, kl_j = jtsne.tsne_layout(idx, w, n_iter=10, lr=lr, exag_iters=5,
                                  student_t=student_t, key=jax.random.key(0))
    y0 = np.asarray(jax.random.normal(jax.random.key(0), (N, 2))) * 1e-4
    y_t, kl_t = ttsne.tsne_layout(T(idx), T(w), n_iter=10, lr=lr,
                                  exag_iters=5, student_t=student_t, y0=y0)
    y_j = np.asarray(y_j)
    assert np.isfinite(y_j).all() and np.abs(y_j).max() > 1e-3
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=0,
                               atol=1e-4 * np.abs(y_j).max())
    assert len(kl_t) == len(kl_j) == 1
    np.testing.assert_allclose(kl_t, kl_j, rtol=1e-5)


def test_tsne_pieces_match_jax(graph):
    """The dense P and one gradient with its KL, each mode."""
    _, _, idx, _, w = graph
    P_j = np.asarray(jtsne._p_matrix(idx, w, N))
    P_t = ttsne._p_matrix(T(idx), T(w), N)
    np.testing.assert_allclose(P_t.numpy(), P_j, rtol=1e-6, atol=1e-12)
    y = np.asarray(jax.random.normal(jax.random.key(4), (N, 2)))
    for student_t in (True, False):
        g_j, kl_j = jtsne._grad(jnp.asarray(y), jnp.asarray(P_j), student_t)
        g_t, kl_t = ttsne._grad(T(y), P_t, student_t)
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0,
                                   atol=1e-5 * np.abs(g_j).max())
        assert float(kl_t) == pytest.approx(float(kl_j), rel=1e-5)


def test_tsne_separates_the_clusters(graph):
    """300 iterations (fig5's count) from the port's own draw: 5-NN
    accuracy >= 0.9 (JAX's run from its key: 0.84; the points' own: 1.0),
    and the KL read at iterations 0, 100 and 200 only."""
    _, labels, idx, _, w = graph
    y, kls = ttsne.tsne_layout(T(idx), T(w), n_iter=300,
                               generator=torch.Generator().manual_seed(0))
    assert len(kls) == 3 and all(np.isfinite(kls))
    assert metrics.knn_classifier_accuracy(y, labels) >= 0.9


@pytest.mark.parametrize("iters", [1, 3])
def test_nn_descent_matches_jax(graph, iters):
    x = graph[0]
    key = jax.random.key(0)
    k1, _ = jax.random.split(key)
    init = jnnd.random_knn_init(jnp.asarray(x), K, k1)
    want = jnnd.nn_descent(jnp.asarray(x), K, iters=iters, key=key)
    got = tnnd.nn_descent(T(x), K, iters=iters,
                          init=(T(init[0]), T(init[1])))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6,
                               atol=1e-6 * float((x * x).sum(1).max()))


@pytest.mark.parametrize("tile", [7, 8192])
def test_random_knn_init_distances(graph, tile):
    """Random ids from the generator (the same seed, the same graph) and
    their true distances, row tile by row tile."""
    x = T(graph[0])
    idx, dist = tnnd.random_knn_init(x, K, torch.Generator().manual_seed(5),
                                     tile=tile)
    idx2, _ = tnnd.random_knn_init(x, K, torch.Generator().manual_seed(5))
    assert torch.equal(idx, idx2) and idx.dtype == torch.int32
    want = ((x[idx.long()] - x[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(dist.numpy(), want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("n_query,eps", [(40, 0.0), (25, 0.5)])
def test_vptree_knn_matches_jax(graph, n_query, eps):
    x = graph[0]
    want = jvp.vptree_knn(x, K, eps=eps, n_query=n_query)
    got = tvp.vptree_knn(x, K, eps=eps, n_query=n_query)
    np.testing.assert_array_equal(got, want)
    if eps == 0.0:          # exact: the brute-force graph, up to ties
        exact = graph[2][:n_query]
        hits = np.mean([len(set(a) & set(b)) / K
                        for a, b in zip(got, exact)])
        assert hits >= 0.99


def test_swiss_roll_formula_matches_jax():
    key, n, d = jax.random.key(5), 500, 6
    want_x, want_l = jsyn.swiss_roll(key, n, d, 0.05)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (jax.random.uniform(k1, (n,)), jax.random.uniform(k2, (n,)),
             jax.random.normal(k3, (n, 3)),
             jax.random.normal(jax.random.fold_in(key, 9), (n, d - 3)))
    x, labels = tsyn.swiss_roll_from(*(np.asarray(a) for a in draws), 0.05)
    np.testing.assert_allclose(x, np.asarray(want_x), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(labels, np.asarray(want_l))


@pytest.mark.parametrize("d", [3, 10])
def test_swiss_roll_from_seed(d):
    x, labels = tsyn.swiss_roll(0, 400, d)
    x2, _ = tsyn.swiss_roll(0, 400, d)
    assert x.shape == (400, d) and x.dtype == np.float32
    assert np.array_equal(x, x2)
    assert labels.dtype == np.int64 and set(labels.tolist()) <= {0, 1, 2, 3}
    assert np.abs(x[:, 3:]).max(initial=0) < 0.1      # the small padding
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert np.all(np.isfinite(x))
