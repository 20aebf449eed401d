"""The port end to end on the CPU, against the JAX package's fit.

On the 2000-point fixture of ``tests/test_layout_engine.py``
(``n_neighbors=15, n_trees=4, n_explore_iters=2, window=32,
perplexity=10, samples_per_node=2000``) the port's fit reaches the
package's quality bar (KNN-classifier accuracy >= 0.95), and its graph,
built from the same points and hyperplanes, recovers >= 0.99 of the JAX
graph.  A JAX fit carried over with ``repro_torch.convert`` lays out to
the same bar.  Plus the package rules: the entry points default to CUDA
and raise without it, and nothing in ``repro_torch`` imports JAX or the
``repro`` package.
"""
import ast
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.largevis_default import LargeVisConfig as JaxConfig
from repro.configs.largevis_default import RoutingConfig as JaxRouting
from repro.core.largevis import largevis as jax_largevis
from repro.data.synthetic import gaussian_mixture
import repro_torch
from repro_torch import LargeVisConfig, convert
from repro_torch.core import knn as tknn
from repro_torch.core import metrics
from repro_torch.core.largevis import layout_graph
from torch_threads import few_threads

KEY = jax.random.key(0)
FIXTURE = dict(n_neighbors=15, n_trees=4, n_explore_iters=2, window=32,
               perplexity=10.0, samples_per_node=2000, batch_size=4096)
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def data():
    x, labels = gaussian_mixture(KEY, 2000, 32, 8)
    return np.asarray(x), np.asarray(labels)


@pytest.fixture(scope="module")
def jax_fit(data):
    """The JAX package's fit of the fixture, its layout cut to 10 samples
    per node (the tests read its graph, weights and samplers), and the
    hyperplanes its forest drew."""
    x, _ = data
    cfg = JaxConfig(**{**FIXTURE, "samples_per_node": 10},
                    routing=JaxRouting(autotune="off"))
    with warnings.catch_warnings():
        # its device alias tables need jax.experimental.enable_x64, which
        # JAX 0.9 removed; the fit demotes to the host tables and warns
        warnings.simplefilter("ignore")
        res = jax_largevis(jnp.asarray(x), KEY, cfg=cfg)
    kg, _ = jax.random.split(KEY)
    depth = 5                                 # _auto_depth(2000, 64)
    proj = jax.random.normal(kg, (32, FIXTURE["n_trees"] * depth),
                             jnp.float32)
    return res, np.asarray(proj)


def test_fit_quality_and_graph_recall_vs_jax(data, jax_fit):
    x, labels = data
    with few_threads():
        res = repro_torch.largevis(x, cfg=LargeVisConfig(**FIXTURE),
                                   device="cpu", proj=jax_fit[1])
    assert res.y.shape == (2000, 2) and bool(torch.isfinite(res.y).all())
    acc = metrics.knn_classifier_accuracy(res.y, labels, k=5)
    assert acc >= 0.95, acc
    recall = tknn.knn_recall(res.knn_idx,
                             torch.from_numpy(np.array(jax_fit[0].knn_idx)))
    assert recall >= 0.99, recall
    assert set(res.timings) == {"knn_s", "weights_s", "sampler_s",
                                "layout_s"}


def test_layout_of_converted_jax_state(data, jax_fit):
    """JAX's fitted state, carried over, lays out to the same bar; the
    conversion round-trips bitwise."""
    _, labels = data
    arrays = convert.result_to_numpy(jax_fit[0])
    cfg = LargeVisConfig(**FIXTURE)
    state = convert.result_from_numpy(arrays, cfg, device="cpu")
    with few_threads():
        res, _ = layout_graph(state.knn_idx, state.weights, cfg=cfg,
                              device="cpu")
    acc = metrics.knn_classifier_accuracy(res.y, labels, k=5)
    assert acc >= 0.95, acc
    back = convert.result_to_numpy(state)
    assert set(back) == set(arrays)
    for name, arr in arrays.items():
        assert back[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(back[name], arr, err_msg=name)


def test_estimator_matches_functional_and_checks_input():
    x, _ = gaussian_mixture(jax.random.key(5), 300, 8, 3)
    x = np.asarray(x)
    cfg = LargeVisConfig(n_neighbors=10, n_trees=2, window=16,
                         perplexity=5.0, samples_per_node=50)
    model = repro_torch.LargeVis(cfg, device="cpu")
    with pytest.raises(repro_torch.NotFittedError):
        model.embedding_
    emb = model.fit_transform(x)
    assert torch.equal(emb, repro_torch.largevis(x, cfg=cfg,
                                                 device="cpu").y)
    bad = x.copy()
    bad[3, 1] = np.nan
    for arr in (bad, x[0], x[:0]):
        with pytest.raises(ValueError):
            model.fit(arr)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((16, 4), np.float32)
    for device in ("cuda", None):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            repro_torch.largevis(x, device=device)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.LargeVis().fit(x)


def test_unported_routes_raise():
    """The split route and the autograd prob_fn run; unknown names raise
    ValueError, as in the JAX package; ``distributed=True``, once a route
    still to port, runs: with no process group, on a world of one (gloo
    on the CPU), its exact ring is the brute-force graph."""
    from repro_torch.core import layout_engine
    z = torch.arange(8.0).reshape(4, 2)
    i = torch.tensor([0, 1], dtype=torch.int32)
    j = torch.tensor([2, 3], dtype=torch.int32)
    n = torch.tensor([[3], [0]], dtype=torch.int32)
    for kw in (dict(layout_step="split"), dict(prob_fn="exp_quadratic")):
        y = layout_engine.apply_edge_batch(z.clone(), i, j, n, n.float(),
                                           0.1, **kw)
        assert bool(torch.isfinite(y).all()) and not torch.equal(y, z)
    for kw in (dict(prob_fn="inv_exp"), dict(layout_step="tiled")):
        with pytest.raises(ValueError):
            layout_engine.apply_edge_batch(z, i, j, n, n.float(), 0.1, **kw)
    import torch.distributed as dist
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(40, 3)).astype(np.float32))
    cfg = LargeVisConfig(distributed=True, n_neighbors=5, n_trees=0,
                         n_explore_iters=0)
    assert not dist.is_initialized()
    try:
        got = tknn.build_knn_graph(x, cfg)
        want = tknn.brute_force_knn(x, 5)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_import_leaves_jax_out():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                               'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_no_jax_or_repro_import_in_the_port():
    offenders = []
    for path in sorted((SRC / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.name}:{node.lineno} {name}")
    assert not offenders, offenders


def test_synthetic_data_is_seeded():
    from repro_torch.data.synthetic import gaussian_mixture as gm
    from repro_torch.data.synthetic import mnist_like
    for make, args in ((gm, (64, 5, 3)), (mnist_like, (64, 12, 4))):
        x, labels = make(7, *args)
        assert x.shape == args[:2] and x.dtype == np.float32
        assert labels.dtype == np.int64 and labels.max() < args[2]
        x2, labels2 = make(7, *args)
        np.testing.assert_array_equal(x, x2)
        np.testing.assert_array_equal(labels, labels2)
        assert not np.array_equal(x, make(8, *args)[0])
