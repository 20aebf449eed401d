"""The port's chunked layout dispatch against the per-step loop and the
JAX package, on the CPU.

On the card a chunk of ``steps_per_dispatch`` steps is one CUDA graph
replay (``layout_engine.StepChunks``); ``chip_smoke.py`` holds the
replays bitwise to the loop there.  On the CPU the same unit runs its
steps one after another, so what is held here is everything around the
graph: the device lr table (bitwise ``step_lr`` and the JAX schedule),
the chunk schedule and ``dispatch_steps`` (JAX's for positive values),
the layout and the projection through chunks bitwise equal to the loop
on both routes with a remainder chunk, the callback's cadence (JAX's),
the launch counts of replays, the fixture's quality, and the ordered
scan that the alias tables take on CUDA.

Tolerances: the ordered scan groups its sums differently from
``torch.cumsum``, so prefix t of each is within t f64 ulps of the exact
sum and the two within twice that of each other; the alias
marginals within 1e-6 of the probabilities and of the numpy Vose
oracle's, as ``test_torch_graph`` holds the CPU tables.  Everything else
is bitwise.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.largevis_default import LargeVisConfig as JaxConfig
from repro.configs.largevis_default import RoutingConfig as JaxRouting
from repro.core import layout as jlayout
from repro.core import layout_engine as jengine
from repro.core import sampler as jsamp
from repro.data.synthetic import gaussian_mixture
import repro_torch
from repro_torch import LargeVisConfig, RoutingConfig
from repro_torch.core import layout, layout_engine, metrics
from repro_torch.core import sampler as tsamp
from repro_torch.core import transform as ttr
from repro_torch.kernels import largevis_grad, largevis_step, ops
from torch_threads import few_threads

FIXTURE = dict(n_neighbors=15, n_trees=4, n_explore_iters=2, window=32,
               perplexity=10.0, samples_per_node=2000, batch_size=4096)


def T(x):
    return torch.from_numpy(np.array(x))


def _graph(N=400, K=8, seed=0):
    """A random weighted K-NN graph on N nodes (no self edges)."""
    rng = np.random.default_rng(seed)
    idx = (np.arange(N)[:, None] + rng.integers(1, N, (N, K))) % N
    w = rng.random((N, K)).astype(np.float32) ** 2
    return idx.astype(np.int32), w


def _samplers(N=400, K=8, seed=0):
    idx, w = _graph(N, K, seed)
    return (tsamp.build_edge_sampler(T(idx), T(w)),
            tsamp.build_negative_sampler(T(idx), T(w)))


# ---------------------------------------------------------------------------
# the lr table and the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [244_140, 1, 7, 33, 101])
def test_lr_table_equals_step_lr_and_jax_bitwise(steps):
    for rho0 in (1.0, 0.37):
        got = layout_engine.lr_table(rho0, steps, "cpu").numpy()
        assert got.dtype == np.float32 and got.shape == (steps,)
        want = np.array([layout_engine.step_lr(rho0, t / steps)
                         for t in range(steps)], np.float32)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        # the JAX chunk loop's schedule: t/steps on the host, rounded to
        # f32, then rho0 * max(1 - t_frac, 1e-4) in f32
        t_fracs = jnp.asarray(np.arange(steps) / steps, jnp.float32)
        jax_lr = np.asarray(rho0 * jnp.maximum(1.0 - t_fracs, 1e-4))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      jax_lr.view(np.uint32))


@pytest.mark.parametrize("steps", [1, 39, 100, 240, 244_140])
@pytest.mark.parametrize("H", [1, 7, 100, 300])
def test_chunk_schedule_covers_each_step_once(steps, H):
    sched = layout_engine.chunk_schedule(steps, H)
    covered = np.concatenate([np.arange(t0, t0 + h) for t0, h in sched])
    np.testing.assert_array_equal(covered, np.arange(steps))
    assert all(h == H for _, h in sched[:-1]) and 0 < sched[-1][1] <= H
    assert len(sched) == -(-steps // H)


def test_dispatch_steps_matches_jax():
    for requested in (1, 2, 40, 100, 1000):
        for n, b in ((2000, 1000), (100_000, 4096)):
            assert layout_engine.dispatch_steps(
                requested, n_nodes=n, batch=b) == jengine.dispatch_steps(
                    requested, n_nodes=n, batch=b) == requested
    # 0 asks the JAX package's autotuner; the port has none: the loop
    assert layout_engine.dispatch_steps(0, n_nodes=2000, batch=1000) == 0


# ---------------------------------------------------------------------------
# chunked equals the loop
# ---------------------------------------------------------------------------

def _layout(cfg, callback=None, seed=3):
    es, ns = _samplers()
    gen = torch.Generator().manual_seed(seed)
    return layout.run_layout(gen, es, ns, 400, cfg, device="cpu",
                             callback=callback)


@pytest.mark.parametrize("route", ["fused", "split"])
def test_chunked_layout_equals_loop_bitwise(route):
    """24 steps (batch capped at N/2 = 200, 12 samples per node): chunks
    of 10, 10 and a remainder of 4 against the loop, and against a loop of
    ``sgd_edge_step`` with host-float lrs from ``step_lr``."""
    base = dict(samples_per_node=12, batch_size=4096,
                routing=RoutingConfig(layout_step=route))
    chunked = _layout(LargeVisConfig(steps_per_dispatch=10, **base))
    loop = _layout(LargeVisConfig(steps_per_dispatch=0, **base))
    assert (chunked.steps, chunked.steps_per_dispatch,
            chunked.dispatches) == (24, 10, 3)
    assert (loop.steps, loop.steps_per_dispatch, loop.dispatches) == (24, 1,
                                                                      24)
    assert torch.equal(chunked.y, loop.y)

    es, ns = _samplers()
    gen = torch.Generator().manual_seed(3)
    y = torch.randn((400, 2), generator=gen) * 1e-4
    for t in range(24):
        y = layout_engine.sgd_edge_step(
            y, gen, t / 24, edge_sampler=es, neg_sampler=ns, n_negatives=5,
            batch=200, layout_step=route)
    assert torch.equal(chunked.y, y)


def test_split_and_fused_chunked_layouts_agree():
    cfgs = [LargeVisConfig(samples_per_node=12, steps_per_dispatch=10,
                           routing=RoutingConfig(layout_step=route))
            for route in ("fused", "split")]
    assert torch.equal(_layout(cfgs[0]).y, _layout(cfgs[1]).y)


def _project(spd, route="auto", q=40):
    rng = np.random.default_rng(7)
    x = T(rng.standard_normal((300, 8)).astype(np.float32))
    y = T(rng.standard_normal((300, 2)).astype(np.float32))
    x_new = T(rng.standard_normal((q, 8)).astype(np.float32))
    cfg = LargeVisConfig(n_neighbors=10, perplexity=5.0,
                         steps_per_dispatch=spd,
                         routing=RoutingConfig(layout_step=route))
    _, ns = _samplers(N=300)
    gen = torch.Generator().manual_seed(11)
    y_new, _ = ttr.project(x_new, x=x, y=y, generator=gen, cfg=cfg,
                           neg_sampler=ns)
    return y_new, gen.get_state()


@pytest.mark.parametrize("route", ["fused", "split"])
def test_project_chunked_equals_loop_bitwise(route):
    """The 48 projection steps in one chunk (the default), in chunks of 10
    (remainder 8) and one by one: the same queries' coordinates and the
    same generator state after."""
    want, want_gen = _project(0, route)
    for spd in (100, 10, 48):
        got, got_gen = _project(spd, route)
        assert torch.equal(got, want), spd
        assert torch.equal(got_gen, want_gen), spd
    assert bool(torch.isfinite(want).all())


def test_query_draw_is_multinomials():
    """``sample_query_edges`` draws the positive as ``torch.multinomial(p,
    1)`` does (argmax of p / Exp(1)), from the same generator state and
    leaving it where multinomial does, without multinomial's host-side
    check."""
    rng = np.random.default_rng(2)
    p = T(rng.random((500, 12)).astype(np.float32) ** 3)
    p = p / p.sum(1, keepdim=True)
    nn_idx = T(rng.integers(0, 900, (500, 12)).astype(np.int32))
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    j, _, _ = ttr.sample_query_edges(g1, p, nn_idx,
                                     ttr.uniform_node_sampler(900, "cpu"), 0)
    cols = torch.multinomial(p, 1, generator=g2)
    assert torch.equal(j, torch.gather(nn_idx, 1, cols)[:, 0])
    assert torch.equal(g1.get_state(), g2.get_state())


def test_device_scalar_lr_equals_float_lr():
    rng = np.random.default_rng(5)
    N, B, M = 60, 300, 5
    y = T((rng.standard_normal((N, 2)) * 3).astype(np.float32))
    i = T(rng.integers(0, N, B).astype(np.int32))
    j = T(rng.integers(0, N, B).astype(np.int32))
    negs = T(rng.integers(0, N, (B, M)).astype(np.int32))
    mask = ((negs != i[:, None]) & (negs != j[:, None])).float()
    lr = layout_engine.lr_table(1.0, 7, "cpu")[3]
    for route in ("fused", "split"):
        for n_frozen in (0, 20):
            kw = dict(layout_step=route, n_frozen=n_frozen)
            got = layout_engine.apply_edge_batch(y.clone(), i, j, negs, mask,
                                                 lr, **kw)
            want = layout_engine.apply_edge_batch(y.clone(), i, j, negs,
                                                  mask, float(lr), **kw)
            assert torch.equal(got, want), (route, n_frozen)
            assert torch.equal(got[:n_frozen], y[:n_frozen])


def test_unit_refuses_a_chunk_longer_than_h():
    unit = layout_engine.StepChunks(lambda y, g, lr: None,
                                    torch.zeros(3, 2), 4)
    with pytest.raises(ValueError):
        unit.run(None, torch.zeros(5))
    assert unit.run_all(None, torch.zeros(9)) == 3


# ---------------------------------------------------------------------------
# callback, launch counts, quality
# ---------------------------------------------------------------------------

def test_callback_runs_the_loop_at_jax_cadence():
    """A callback selects the per-step loop and is called at the steps
    the JAX package's loop calls it at, on the same step count."""
    seen = []
    res = _layout(LargeVisConfig(samples_per_node=60, steps_per_dispatch=10),
                  callback=lambda t, steps, y: seen.append((t, steps,
                                                            y.shape)))
    assert (res.steps_per_dispatch, res.dispatches) == (1, res.steps)

    idx, w = _graph()
    jes = jsamp.build_edge_sampler(idx, w, impl="host")
    jns = jsamp.build_negative_sampler(idx, w, impl="host")
    jseen = []
    cfg = JaxConfig(samples_per_node=60, steps_per_dispatch=10,
                    routing=JaxRouting(autotune="off"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres = jlayout.run_layout(
            jax.random.key(0), jes, jns, 400, cfg,
            callback=lambda t, steps, y: jseen.append((t, steps, y.shape)))
    assert jres.steps == res.steps == 120
    assert [t for t, _, _ in seen] == [t for t, _, _ in jseen] == list(
        range(0, 120, 6))
    assert all(s == 120 and tuple(shape) == (400, 2)
               for _, s, shape in seen + jseen)


def test_callback_reaches_the_layout_through_the_api():
    x, _ = gaussian_mixture(jax.random.key(5), 300, 8, 3)
    x = np.asarray(x)
    cfg = LargeVisConfig(n_neighbors=10, n_trees=2, window=16,
                         perplexity=5.0, samples_per_node=50)
    seen = []
    model = repro_torch.LargeVis(cfg, device="cpu")
    emb = model.fit_transform(x, callback=lambda t, s, y: seen.append(t))
    r = model.result_
    assert r.steps == 100 and (r.steps_per_dispatch, r.dispatches) == (1, 100)
    assert seen == list(range(0, 100, 5))
    chunked = repro_torch.largevis(x, cfg=cfg, device="cpu")
    assert (chunked.steps_per_dispatch, chunked.dispatches) == (100, 1)
    assert torch.equal(chunked.y, emb)


def test_launch_counts_add_up_across_replays():
    """A capture's counts come back off (it launches nothing); each replay
    adds them once; a capture that fails leaves the counts as they were."""
    ops.reset_launch_counts()
    largevis_step.fused_edge_step.launches = 7

    def record():                       # what the wrappers count in capture
        largevis_step.fused_edge_step.launches += 100
        largevis_grad.largevis_grads.launches += 3

    made = ops.capture_launches(record)
    assert made == {"fused_edge_step": 100, "largevis_grads": 3}
    assert ops.launch_counts()["fused_edge_step"] == 7
    for _ in range(2441):
        ops.add_launches(made)
    counts = ops.launch_counts()
    assert counts["fused_edge_step"] == 7 + 244_100
    assert counts["largevis_grads"] == 3 * 2441
    assert counts["topk_sqdist"] == 0

    def broken():
        largevis_step.fused_edge_step.launches += 5
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError):
        ops.capture_launches(broken)
    assert ops.launch_counts() == counts
    ops.reset_launch_counts()


def test_fixture_quality_through_the_chunked_path():
    """The 2000-point fixture at the default 100 steps a dispatch: 4,000
    steps (batch capped at 1,000) in 40 chunks, accuracy >= 0.95 as in
    test_torch_pipeline."""
    x, labels = gaussian_mixture(jax.random.key(0), 2000, 32, 8)
    with few_threads():
        res = repro_torch.largevis(np.asarray(x),
                                   cfg=LargeVisConfig(**FIXTURE),
                                   device="cpu")
    assert (res.steps, res.steps_per_dispatch, res.dispatches) == (4000, 100,
                                                                   40)
    acc = metrics.knn_classifier_accuracy(res.y, np.asarray(labels), k=5)
    assert acc >= 0.95, acc


# ---------------------------------------------------------------------------
# the ordered scan of the alias tables (CUDA's route, run on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 1023, 1024, 1025, 5000, 70_001])
def test_ordered_cumsum_is_fixed_and_close_to_cumsum(n):
    rng = np.random.default_rng(n)
    x = T(rng.random(n) * 10.0 ** rng.integers(-6, 3, n))
    got = tsamp.ordered_cumsum(x)
    assert got.dtype == torch.float64 and got.shape == (n,)
    assert torch.equal(got, tsamp.ordered_cumsum(x.clone()))
    want = torch.cumsum(x, 0)
    # either sum of t + 1 terms is within t ulps of the exact prefix
    bound = 2 * torch.arange(1, n + 1) * np.finfo(np.float64).eps * want
    assert bool(((got - want).abs() <= bound).all())
    assert bool((got.diff() >= 0).all())          # nondecreasing
    if n <= 1024:                                 # one row: left to right
        assert torch.equal(got, want)


def _probs():
    rng = np.random.default_rng(0)
    sparse = rng.random(500) * (rng.random(500) < 0.3)
    return {"uniform-random": rng.random(2000),
            "zipf": 1.0 / np.arange(1, 3001) ** 1.1,
            "sparse-with-zeros": sparse, "one-hot": np.eye(1, 64)[0],
            "constant": np.ones(100), "single": np.ones(1),
            "wide": rng.random(40_000) ** 4}


@pytest.mark.parametrize("name", list(_probs()))
def test_ordered_alias_tables_keep_the_marginals(name):
    """The tables the card builds (``ordered=True``), built on the CPU:
    the same twice, and their per-index marginals within 1e-6 of the
    probabilities and of the numpy Vose oracle's."""
    probs = _probs()[name].astype(np.float32)
    thr, ali = tsamp._alias_pairing(T(probs), ordered=True)
    thr2, ali2 = tsamp._alias_pairing(T(probs), ordered=True)
    assert torch.equal(thr, thr2) and torch.equal(ali, ali2)
    assert thr.dtype == torch.float32 and ali.dtype == torch.int32
    got = tsamp.alias_marginals(thr, ali)
    np.testing.assert_allclose(got, probs.astype(np.float64) / probs.sum(),
                               atol=1e-6)
    np.testing.assert_allclose(got, tsamp.alias_marginals(
        *tsamp.build_alias(probs)), atol=1e-6)
