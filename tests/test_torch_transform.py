"""The port's out-of-sample transform and insert against the JAX package,
on the CPU.

The graph-side pieces are held id for id to JAX on the same numpy inputs:
``query_neighbors`` (one streaming top-k), ``_insert_merge``,
``neighbor_explore(rows=...)`` and ``knn_insert`` at ``explore_sample=0``
(distances within rtol 1e-5: the port sums row norms in another order
than XLA).  The projection draws its edges from a ``torch.Generator``,
whose numbers differ from JAX's, so it is held to its contract and to
JAX's quality: on a JAX fit carried over with ``repro_torch.convert``,
the corpus rows keep their bits, the fitted carrier is unchanged, and
the held-out 5-NN accuracy is within 0.05 of JAX's own transform.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import LargeVis as JaxLargeVis
from repro import LargeVisConfig as JaxConfig
from repro.configs.largevis_default import RoutingConfig as JaxRouting
from repro.core import knn as jknn
from repro.core import neighbor_explore as jexplore
from repro.core import transform as jtr
from repro.data.synthetic import mnist_like
import repro_torch
from repro_torch import LargeVisConfig, RoutingConfig, convert
from repro_torch.core import neighbor_explore as texplore
from repro_torch.core import transform as ttr

KEY = jax.random.key(0)
N_CORPUS, N_QUERY = 400, 120
# tests/test_transform.py's fixture
FIXTURE = dict(n_neighbors=12, n_trees=4, samples_per_node=2000,
               batch_size=128, perplexity=10.0, transform_steps=48)


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def data():
    x, labels = mnist_like(KEY, N_CORPUS + N_QUERY, 16, 5)
    return np.asarray(x), np.asarray(labels)


@pytest.fixture(scope="module")
def graph(data):
    """JAX's exact 12-NN graph of the corpus."""
    x, _ = data
    idx, dist = jknn.brute_force_knn(jnp.asarray(x[:N_CORPUS]), k=12)
    return np.asarray(idx), np.asarray(dist)


@pytest.fixture(scope="module")
def jax_model(data):
    x, _ = data
    cfg = JaxConfig(**FIXTURE, routing=JaxRouting(autotune="off"))
    with warnings.catch_warnings():
        # its device alias tables need jax.experimental.enable_x64, which
        # JAX 0.9 removed; the fit demotes to the host tables and warns
        warnings.simplefilter("ignore")
        return JaxLargeVis(cfg=cfg).fit(jnp.asarray(x[:N_CORPUS]),
                                        jax.random.key(1))


def _port_model(jax_model, **routing):
    cfg = LargeVisConfig(**FIXTURE, routing=RoutingConfig(**routing))
    model = repro_torch.LargeVis(cfg, device="cpu")
    model.result_ = convert.result_from_numpy(
        convert.result_to_numpy(jax_model.result_), cfg, device="cpu")
    return model


def _knn_accuracy(y_corpus, labels_corpus, y_query, labels_query, k=5):
    """Classify each query by the majority label of its k nearest corpus
    points in the layout (tests/test_transform.py's measure)."""
    d = np.sum((y_query[:, None, :] - y_corpus[None, :, :]) ** 2, axis=-1)
    nn = np.argsort(d, axis=1, kind="stable")[:, :k]
    pred = np.array([np.bincount(v).argmax() for v in labels_corpus[nn]])
    return float(np.mean(pred == labels_query))


def _assert_graph(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# graph side
# ---------------------------------------------------------------------------

def test_query_neighbors_equal_jax(data):
    x, _ = data
    want = jtr.query_neighbors(jnp.asarray(x[N_CORPUS:]),
                               jnp.asarray(x[:N_CORPUS]), 12)
    got = ttr.query_neighbors(T(x[N_CORPUS:]), T(x[:N_CORPUS]), 12)
    assert got[0].dtype == torch.int32 and tuple(got[0].shape) == (120, 12)
    _assert_graph(got, want)


@pytest.mark.parametrize("q", [120, 7])
def test_insert_merge_equal_jax(data, graph, q):
    """Both the overflowing reverse cap (120 queries, r_cap 12) and a cap
    below K (7 queries)."""
    x, _ = data
    idx, dist = graph
    xn = x[N_CORPUS:N_CORPUS + q]
    qc_idx, qc_dist = jtr.query_neighbors(jnp.asarray(xn),
                                          jnp.asarray(x[:N_CORPUS]), 12)
    qc_idx, qc_dist = np.asarray(qc_idx), np.asarray(qc_dist)
    if q == 120:        # some corpus row is in more than r_cap query lists
        assert np.bincount(qc_idx.reshape(-1)).max() > 12
    want = jtr._insert_merge(
        jnp.asarray(x[:N_CORPUS]), jnp.asarray(idx), jnp.asarray(dist),
        jnp.asarray(xn), jnp.asarray(qc_idx), jnp.asarray(qc_dist), k=12)
    got = ttr._insert_merge(T(x[:N_CORPUS]), T(idx), T(dist), T(xn),
                            T(qc_idx), T(qc_dist), k=12)
    _assert_graph(got[:2], want[:2])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert bool(got[2].any())


def test_neighbor_explore_rows_equal_jax(data):
    """tests/test_transform.py's corrupted graph: only ``rows`` change,
    and they change as JAX's do."""
    x, _ = data
    x = x[:200]
    idx, dist = jknn.brute_force_knn(jnp.asarray(x), k=8)
    idx, dist = np.array(idx), np.array(dist)
    bad = np.arange(0, 200, 7, dtype=np.int32)
    idx[bad] = np.arange(8, dtype=np.int32)
    diff = x[bad][:, None, :] - x[None, :8, :]
    dist[bad] = np.sum(diff * diff, axis=-1)
    want = jexplore.neighbor_explore(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(dist), iters=2,
        key=jax.random.key(3), rows=jnp.asarray(bad))
    got = texplore.neighbor_explore(T(x), T(idx), T(dist), iters=2,
                                    rows=T(bad))
    _assert_graph(got, want)
    untouched = np.setdiff1d(np.arange(200), bad)
    np.testing.assert_array_equal(got[0].numpy()[untouched], idx[untouched])
    assert float(got[1][bad].mean()) < float(dist[bad].mean())


def test_knn_insert_equal_jax(data, graph):
    x, _ = data
    idx, dist = graph
    cfg = JaxConfig(**FIXTURE, routing=JaxRouting(autotune="off"))
    want = jtr.knn_insert(jnp.asarray(x[:N_CORPUS]), jnp.asarray(idx),
                          jnp.asarray(dist), jnp.asarray(x[N_CORPUS:]),
                          key=jax.random.key(7), cfg=cfg)
    got = ttr.knn_insert(T(x[:N_CORPUS]), T(idx), T(dist), T(x[N_CORPUS:]),
                         cfg=LargeVisConfig(**FIXTURE))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert tuple(got[1].shape) == (N_CORPUS + N_QUERY, 12)
    _assert_graph(got[1:], want[1:])


# ---------------------------------------------------------------------------
# projection and the estimator
# ---------------------------------------------------------------------------

def test_transform_of_converted_jax_fit(data, jax_model, monkeypatch):
    """Corpus rows keep their bits inside the projection, the carrier is
    unchanged, the split route gives the fused route's bits, and the
    held-out accuracy is within 0.05 of JAX's own transform."""
    x, labels = data
    model = _port_model(jax_model)
    y_before = model.result_.y.clone()
    seen = []
    apply = ttr.apply_edge_batch

    def spy(y, *args, **kw):
        seen.append((y, kw["n_frozen"]))
        return apply(y, *args, **kw)

    monkeypatch.setattr(ttr, "apply_edge_batch", spy)
    y_query = model.transform(x[N_CORPUS:])
    monkeypatch.undo()
    assert [n for _, n in seen] == [N_CORPUS] * FIXTURE["transform_steps"]
    # every step updates the one [corpus; queries] tensor in place
    y_full = seen[0][0]
    assert all(y is y_full for y, _ in seen)
    np.testing.assert_array_equal(
        y_full[:N_CORPUS].numpy().view(np.uint32),
        y_before.numpy().view(np.uint32))
    assert torch.equal(model.result_.y, y_before)
    assert tuple(y_query.shape) == (N_QUERY, 2)
    assert bool(torch.isfinite(y_query).all())
    split = _port_model(jax_model, layout_step="split")
    assert torch.equal(split.transform(x[N_CORPUS:]), y_query)

    y_corpus = y_before.numpy()
    acc = _knn_accuracy(y_corpus, labels[:N_CORPUS], y_query.numpy(),
                        labels[N_CORPUS:])
    jax_acc = _knn_accuracy(y_corpus, labels[:N_CORPUS],
                            np.asarray(jax_model.transform(
                                jnp.asarray(x[N_CORPUS:]))),
                            labels[N_CORPUS:])
    assert acc >= jax_acc - 0.05, (acc, jax_acc)


def test_insert_grows_the_model(data, jax_model):
    """insert() returns the new points' coordinates, grows every carrier
    field, leaves the fitted rows' bits alone, and the grown model
    transforms; an empty insert changes nothing."""
    x, _ = data
    model = _port_model(jax_model)
    y_before = model.result_.y.clone()
    assert tuple(model.insert(x[:0]).shape) == (0, 2)
    assert torch.equal(model.result_.y, y_before)
    y_new = model.insert(x[N_CORPUS:])
    assert tuple(y_new.shape) == (N_QUERY, 2)
    r = model.result_
    n_all = N_CORPUS + N_QUERY
    assert r.x.shape[0] == r.y.shape[0] == n_all
    assert tuple(r.knn_idx.shape) == tuple(r.weights.shape) == (n_all, 12)
    assert r.neg_sampler.n_nodes == n_all
    assert r.edge_sampler.n_edges == n_all * 12
    np.testing.assert_array_equal(r.y[:N_CORPUS].numpy().view(np.uint32),
                                  y_before.numpy().view(np.uint32))
    assert torch.equal(r.y[N_CORPUS:], y_new)
    rows = torch.arange(n_all)[:, None]
    assert bool((r.knn_idx != rows).all())
    assert bool((r.knn_dist.diff(dim=1) >= 0).all())
    assert bool(torch.isfinite(model.transform(x[:3])).all())
    with pytest.raises(ValueError):
        model.insert(x[:5, :3])


def test_transform_before_fit_raises():
    with pytest.raises(repro_torch.NotFittedError):
        repro_torch.LargeVis(device="cpu").transform(np.zeros((2, 3)))
