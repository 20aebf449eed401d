"""The port's projection server against the JAX package, on the CPU.

``repro_torch.launch.serve_projection.ProjectionEngine`` is held piece by
piece to ``repro.launch.serve_projection`` on the same numpy inputs: the
admit block's prefill, the per-slot lr, and the lockstep step's update
fed the draws that JAX's ``sample_query_edges`` made.  The engine's own
draws come from a ``torch.Generator``, whose numbers differ from JAX's,
so the whole engine is held to JAX's quality on one JAX fit carried
across, and to its contract: the corpus keeps its bits, and the request,
quarantine and retry semantics of ``tests/test_chaos_serving.py`` and
``tests/test_transform.py``'s engine tests, ported here.  On the card
the step is one CUDA graph replay; ``chip_smoke.py`` holds it bitwise to
the eager step there.

Tolerances:
* prefill: ids equal; p within rtol 1e-5, atol 1e-8 (the JAX prefill is
  jitted, and XLA fuses the bisection's entropy differently; the bound
  of ``test_torch_graph``'s ``calibrate_p``); y0, the p-weighted mean,
  within rtol 1e-5, atol 1e-6;
* the per-slot lr and the step's update: bitwise, against JAX's line and
  split route evaluated *eagerly* (jitted, XLA multiplies by 1/steps in
  the lr, held within rho0 * 2^-23, and contracts FMAs in the step);
* the whole engine against JAX's: 5-NN accuracy of the served queries
  within 0.05; corpora bitwise;
* everything else bitwise.
"""
import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.largevis_default import LargeVisConfig as JaxConfig
from repro.configs.largevis_default import RoutingConfig as JaxRouting
from repro.core import layout_engine as jengine
from repro.core import transform as jtr
from repro.core.largevis import largevis as jax_largevis
from repro.data.synthetic import mnist_like
from repro.launch import serve_projection as jsp
from repro_torch import LargeVisConfig, RoutingConfig, convert, largevis
from repro_torch.launch import serve_projection as tsp
from repro_torch.launch.serve_projection import (ProjectionEngine,
                                                 ProjectRequest,
                                                 QueueFullError)
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.fault_tolerance import FaultInjector


def T(x):
    return torch.from_numpy(np.array(x))


# tests/test_chaos_serving.py's corpus and config
N, D = 400, 16
CFG = LargeVisConfig(n_neighbors=8, n_trees=2, n_explore_iters=1, window=16,
                     perplexity=6.0, samples_per_node=200, batch_size=128,
                     steps_per_dispatch=20, transform_steps=12)


@pytest.fixture(scope="module")
def model():
    """The port's own fit of the chaos corpus, on the CPU."""
    x = np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)
    return largevis(x, cfg=CFG, device="cpu")


def _queries(q=16, seed=5):
    return np.random.default_rng(seed).normal(size=(q, D)).astype(np.float32)


def _drain(model, reqs, **engine_kw):
    eng = ProjectionEngine(model, slots=8, seed=3, **engine_kw)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng


# ---------------------------------------------------------------------------
# (a)-(d): the pieces against JAX's
# ---------------------------------------------------------------------------

def _corpus(n=300, d=16, s=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((n, s)) * 5.0).astype(np.float32))


def test_prefill_block_matches_jax():
    """One admit block of 24 rows, the last 9 padding (zeros), k = 12."""
    x, y = _corpus()
    xq = np.random.default_rng(1).standard_normal((24, 16)).astype(
        np.float32)
    xq[15:] = 0.0
    kw = dict(k=12, perplexity=6.0, iters=64)
    jn, jpl, jy0 = jsp._prefill_block(jnp.asarray(xq), jnp.asarray(x),
                                      jnp.asarray(y), **kw)
    tn, tp, ty0 = tsp._prefill_block(T(xq), T(x), T(y), **kw)
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tp.numpy(), np.exp(np.asarray(jpl)),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(ty0.numpy(), np.asarray(jy0), rtol=1e-5,
                               atol=1e-6)


def _jax_slot_lr(ages, steps, rho0):
    """``repro/launch/serve_projection.py:103-104``."""
    t_frac = ages.astype(jnp.float32) / steps
    return rho0 * jnp.maximum(1.0 - t_frac, 1e-4)


@pytest.mark.parametrize("steps", [1, 7, 12, 16, 48, 100, 1000])
def test_slot_lr_equals_jax_bitwise(steps):
    """Ages 0..steps-1, and three past the end (a slot whose retire was
    interrupted takes JAX's floor): bitwise the line as JAX evaluates it
    eagerly, f32 division.  Jitted, XLA on the CPU turns the division by
    the constant ``steps`` into a multiply by its reciprocal, which moves
    some entries by about one f32 ulp of t/steps: within rho0 * 2^-23
    of the port's."""
    ages = np.arange(steps + 3, dtype=np.int32)
    jitted = jax.jit(_jax_slot_lr, static_argnums=(1, 2))
    for rho0 in (1.0, 0.37):
        got = tsp.slot_lr(tsp.slot_lr_table(rho0, steps, "cpu"),
                          T(ages)).numpy()
        assert got.dtype == np.float32
        want = np.asarray(_jax_slot_lr(jnp.asarray(ages), steps, rho0))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        np.testing.assert_allclose(
            got, np.asarray(jitted(jnp.asarray(ages), steps, rho0)),
            rtol=0, atol=rho0 * 2.0 ** -23)


def _slot_state(n=300, S=64, K=8, steps=12, seed=2):
    """A [corpus; slots] embedding, slot neighborhoods and p, ages (some
    at and past the end) and about half the slots active."""
    rng = np.random.default_rng(seed)
    y_full = (rng.standard_normal((n + S, 2)) * 4.0).astype(np.float32)
    nn_idx = rng.integers(0, n, (S, K)).astype(np.int32)
    logits = rng.standard_normal((S, K)).astype(np.float32)
    p_log = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    ages = rng.integers(0, steps + 2, S).astype(np.int32)
    active = rng.random(S) < 0.5
    return y_full, nn_idx, p_log.astype(np.float32), ages, active


@pytest.mark.parametrize("route", ["fused", "split"])
def test_apply_of_jax_draws_bitwise(route):
    """The port's step update fed JAX's draws (``sample_query_edges`` of a
    JAX key) against the JAX engine's step body run eagerly: y_full and
    ages bitwise; the corpus and every inactive slot's row keep their
    bits; the active rows move."""
    n, S, M, steps, rho0 = 300, 64, 5, 12, 1.0
    y_full, nn_idx, p_log, ages, active = _slot_state(n, S, steps=steps)
    j, negs, mask = jtr.sample_query_edges(
        jax.random.key(3), jnp.asarray(p_log), jnp.asarray(nn_idx),
        jtr.uniform_node_sampler(n), M)
    i = (n + np.arange(S)).astype(np.int32)
    # serve_projection.py:100-109, eagerly
    jj = jnp.where(jnp.asarray(active), j, jnp.asarray(i))
    mm = mask * jnp.asarray(active)[:, None].astype(jnp.float32)
    lr = _jax_slot_lr(jnp.asarray(ages), steps, rho0)
    want = np.asarray(jengine.apply_edge_batch(
        jnp.asarray(y_full), jnp.asarray(i), jj, negs, mm, lr,
        fused_step=False, n_frozen=n))
    want_ages = ages + active.astype(np.int32)

    y, a = T(y_full), T(ages)
    tsp._lockstep_apply(y, T(i), T(j), T(negs), T(mask), a, T(active),
                        tsp.slot_lr_table(rho0, steps, "cpu"), n_frozen=n,
                        layout_step=route)
    np.testing.assert_array_equal(y.numpy(), want)
    np.testing.assert_array_equal(a.numpy(), want_ages)
    np.testing.assert_array_equal(y.numpy()[:n], y_full[:n])
    idle = n + np.flatnonzero(~active)
    busy = n + np.flatnonzero(active)
    np.testing.assert_array_equal(y.numpy()[idle].view(np.uint32),
                                  y_full[idle].view(np.uint32))
    assert (y.numpy()[busy] != y_full[busy]).any(axis=1).all()


@pytest.mark.parametrize("route", ["fused", "split"])
def test_inactive_slot_rows_unchanged_through_an_engine_step(model, route):
    """3 requests on 8 slots, the 5 idle rows holding coordinates a past
    request left: one engine step keeps them bitwise."""
    cfg = dataclasses.replace(CFG, routing=RoutingConfig(layout_step=route))
    eng = ProjectionEngine(model, slots=8, seed=3, cfg=cfg)
    for r, xq in enumerate(_queries(3)):
        eng.submit(ProjectRequest(r, xq))
    eng._admit()
    idle = N + np.arange(3, 8)
    eng.y_full[idle] = torch.from_numpy(np.random.default_rng(4).normal(
        size=(5, 2)).astype(np.float32) * 3.0)
    before = eng.y_full.clone()
    assert eng.step()
    assert torch.equal(eng.y_full[idle], before[idle])
    assert torch.equal(eng.y_full[:N], before[:N])
    assert not torch.equal(eng.y_full[N:N + 3], before[N:N + 3])
    assert eng.ages.tolist() == [1, 1, 1, 0, 0, 0, 0, 0]


def test_graph_dispatch_draws_what_the_eager_steps_draw(model, monkeypatch):
    """The card's dispatch on the CPU, with stand-ins for the CUDA graph
    calls: the first step runs through ``warm_up``, the second captures
    once, every later step replays through ``layout_engine.replay``'s
    generator hand-over, and the results are bitwise the eager engine's,
    a step fault and its retry included."""
    calls = {"warm_up": 0, "capture": 0}

    class Graph:
        def __init__(self, fn):
            self.replay = fn

    def warm_up(fn, device):
        calls["warm_up"] += 1
        fn()

    def capture(fn, generator):
        calls["capture"] += 1
        return Graph(fn), {}

    monkeypatch.setattr(tsp.layout_engine, "warm_up", warm_up)
    monkeypatch.setattr(tsp.layout_engine, "capture", capture)
    q = _queries(12)
    ref = _drain(model, [ProjectRequest(rid=i, x=q[i]) for i in range(12)])
    eng = ProjectionEngine(model, slots=8, seed=3,
                           fault=FaultInjector({"step": {7: "exception"}}))
    eng._use_graph, eng._gen = True, torch.Generator()
    for i in range(12):
        eng.submit(ProjectRequest(rid=i, x=q[i]))
    n = eng.run()
    assert calls == {"warm_up": 1, "capture": 1}
    assert eng.faults_retried == 1 and eng.graph_replays == n - 2
    ref_y = {r.rid: r.y for r in ref.completed}
    assert len(eng.completed) == 12
    for r in eng.completed:
        assert np.array_equal(r.y, ref_y[r.rid]), r.rid


# ---------------------------------------------------------------------------
# (e): tests/test_chaos_serving.py, against the port
# ---------------------------------------------------------------------------

def test_poisoned_queries_quarantined_healthy_bitwise_unaffected(model):
    """Interleave NaN queries with healthy ones: the bad ones complete
    with errors in ``quarantined``; every healthy request's coordinates
    are bitwise what a fault-free, healthy-only run produces."""
    q = _queries(12)
    ref = _drain(model, [ProjectRequest(rid=i, x=q[i]) for i in range(12)])
    ref_y = {r.rid: r.y for r in ref.completed}
    assert len(ref_y) == 12 and not ref.quarantined

    eng = ProjectionEngine(model, slots=8, seed=3)
    bad_rids = []
    for i in range(12):
        assert eng.submit(ProjectRequest(rid=i, x=q[i]))
        if i % 3 == 0:
            bad = ProjectRequest(rid=100 + i,
                                 x=np.full(D, np.nan, np.float32))
            assert not eng.submit(bad)
            bad_rids.append(bad.rid)
    eng.run()
    assert sorted(r.rid for r in eng.quarantined) == bad_rids
    assert all(r.error is not None and r.y is None
               for r in eng.quarantined)
    assert len(eng.completed) == 12
    for r in eng.completed:
        assert np.array_equal(r.y, ref_y[r.rid]), r.rid


def test_wrong_dim_query_quarantined(model):
    eng = ProjectionEngine(model, slots=4)
    assert not eng.submit(ProjectRequest(rid=0, x=np.zeros(D + 3,
                                                           np.float32)))
    assert eng.quarantined[0].error and "dim" in eng.quarantined[0].error


def test_corpus_bitwise_frozen_under_chaos(model):
    """Slot rows NaN'd mid-flight cannot leak into the fitted corpus.  The
    step site's payload comes back as a new tensor, which the engine
    copies into its resident embedding (the buffer a captured step
    reads) instead of rebinding it."""
    corpus_before = model.y.clone()

    def corrupt_slots(y_full):
        y = y_full.clone()
        y[N + 2] = float("nan")
        y[N + 5] = float("nan")
        return y

    fi = FaultInjector({"step": {4: corrupt_slots, 9: "exception"}})
    eng = ProjectionEngine(model, slots=8, seed=3, fault=fi)
    resident = eng.y_full
    for i, x in enumerate(_queries(20)):
        eng.submit(ProjectRequest(rid=i, x=x))
    eng.run()
    assert eng.y_full is resident
    assert torch.equal(eng.y_full[:N], corpus_before)
    assert eng.faults_retried == 1
    assert len(eng.quarantined) == 2
    assert all("non-finite" in r.error for r in eng.quarantined)
    assert len(eng.completed) + len(eng.quarantined) == 20


def test_step_exception_retry_is_bitwise_transparent(model):
    """An injected step exception is retried by run() with zero state
    drift — final coordinates bitwise match a fault-free drain."""
    q = _queries(10)
    ref = _drain(model, [ProjectRequest(rid=i, x=q[i]) for i in range(10)])
    fi = FaultInjector({"step": {0: "exception", 5: "exception"}})
    eng = _drain(model, [ProjectRequest(rid=i, x=q[i]) for i in range(10)],
                 fault=fi)
    assert eng.faults_retried == 2
    ref_y = {r.rid: r.y for r in ref.completed}
    assert len(eng.completed) == 10
    for r in eng.completed:
        assert np.array_equal(r.y, ref_y[r.rid])


def test_prefill_corruption_contained_to_its_slot(model):
    """NaN one admitted row's init coords: only that request retires
    with an error; co-admitted requests complete bitwise-clean."""
    q = _queries(6)
    ref = _drain(model, [ProjectRequest(rid=i, x=q[i]) for i in range(6)])
    ref_y = {r.rid: r.y for r in ref.completed}

    def poison_row0(payload):
        nn_idx, p, y0 = payload
        y0 = y0.clone()
        y0[0] = float("nan")
        return nn_idx, p, y0

    fi = FaultInjector({"prefill": {0: poison_row0}})
    eng = _drain(model, [ProjectRequest(rid=i, x=q[i]) for i in range(6)],
                 fault=fi)
    assert [r.rid for r in eng.quarantined] == [0]
    assert "non-finite" in eng.quarantined[0].error
    assert sorted(r.rid for r in eng.completed) == [1, 2, 3, 4, 5]
    for r in eng.completed:
        assert np.array_equal(r.y, ref_y[r.rid])


def test_slot_step_budget_retires_stuck_slot(model):
    """A slot that cannot finish inside its budget is force-retired with
    an error instead of pinning the slot forever."""
    eng = ProjectionEngine(model, slots=4, seed=3, slot_step_budget=5)
    assert eng.slot_step_budget < eng.steps
    for i, x in enumerate(_queries(4)):
        eng.submit(ProjectRequest(rid=i, x=x))
    eng.run()
    assert len(eng.quarantined) == 4
    assert all("budget" in r.error for r in eng.quarantined)
    assert all(r is None for r in eng.requests)
    assert not eng.active.any()


def test_default_budget_never_trips_healthy_traffic(model):
    eng = _drain(model, [ProjectRequest(rid=i, x=x)
                         for i, x in enumerate(_queries(30))])
    assert not eng.quarantined and len(eng.completed) == 30


def test_queue_backpressure(model):
    eng = ProjectionEngine(model, slots=2, max_queue=3)
    for i in range(3):
        eng.submit(ProjectRequest(rid=i, x=_queries(1)[0]))
    with pytest.raises(QueueFullError):
        eng.submit(ProjectRequest(rid=99, x=_queries(1)[0]))
    eng.run()
    assert len(eng.completed) == 3


# ---------------------------------------------------------------------------
# (f): the whole engine against JAX's, on one JAX fit carried across
# ---------------------------------------------------------------------------

N_CORPUS, N_QUERY = 400, 120
FIT = dict(n_neighbors=12, n_trees=4, samples_per_node=2000, batch_size=128,
           perplexity=10.0, transform_steps=16)


@pytest.fixture(scope="module")
def jax_fit():
    x, labels = mnist_like(jax.random.key(0), N_CORPUS + N_QUERY, 16, 5)
    cfg = JaxConfig(**FIT, routing=JaxRouting(autotune="off"))
    with warnings.catch_warnings():
        # its device alias tables need jax.experimental.enable_x64, which
        # JAX 0.9 removed; the fit demotes to the host tables and warns
        warnings.simplefilter("ignore")
        res = jax_largevis(jnp.asarray(x[:N_CORPUS]), jax.random.key(1),
                           cfg=cfg)
    return np.asarray(x), np.asarray(labels), res


@pytest.fixture(scope="module")
def port_fit(jax_fit):
    """The JAX fit as the port's ``LargeVisResult`` on the CPU."""
    cfg = LargeVisConfig(**FIT)
    return convert.result_from_numpy(convert.result_to_numpy(jax_fit[2]),
                                     cfg, device="cpu")


def _knn_accuracy(y_corpus, labels_corpus, y_query, labels_query, k=5):
    d = ((y_query[:, None, :] - y_corpus[None, :, :]) ** 2).sum(-1)
    nn = np.argsort(d, axis=1, kind="stable")[:, :k]
    votes = labels_corpus[nn]
    pred = np.array([np.bincount(v).argmax() for v in votes])
    return float((pred == labels_query).mean())


def _serve(engine, xq):
    reqs = [ProjectRequest(i, xq[i]) for i in range(xq.shape[0])]
    for r in reqs:
        engine.submit(r)
    n_steps = engine.run()
    assert all(r.done and r.error is None for r in reqs)
    return np.stack([r.y for r in reqs]), n_steps


def test_engine_quality_matches_jax_engine(jax_fit, port_fit):
    """120 queries through 32 slots, each engine on the same fit: 5-NN
    accuracy within 0.05 of each other; both corpora bitwise frozen."""
    x, labels, jres = jax_fit
    xq, lq = x[N_CORPUS:], labels[N_CORPUS:]
    y_corpus = np.asarray(jres.y)
    jeng = jsp.ProjectionEngine(jres, slots=32, seed=2)
    j_y, _ = _serve(jeng, xq)
    teng = ProjectionEngine(port_fit, slots=32, seed=2)
    t_y, _ = _serve(teng, xq)
    assert np.isfinite(t_y).all()
    np.testing.assert_array_equal(np.asarray(jeng.y_full[:N_CORPUS]),
                                  y_corpus)
    np.testing.assert_array_equal(teng.y_full[:N_CORPUS].numpy(), y_corpus)
    acc_j = _knn_accuracy(y_corpus, labels[:N_CORPUS], j_y, lq)
    acc_t = _knn_accuracy(y_corpus, labels[:N_CORPUS], t_y, lq)
    assert acc_t >= 0.8, acc_t
    assert abs(acc_t - acc_j) <= 0.05, (acc_t, acc_j)


# tests/test_transform.py's two engine tests, against the port

def test_projection_engine_round_trip(jax_fit, port_fit):
    """More requests than slots: everything retires with finite coords,
    latencies are recorded, and the corpus stays bit-frozen."""
    x = jax_fit[0]
    y_ref = port_fit.y.numpy().copy()
    eng = ProjectionEngine(port_fit, slots=16, seed=2)
    reqs = [ProjectRequest(i, x[N_CORPUS + i % N_QUERY]) for i in range(50)]
    for r in reqs:
        eng.submit(r)
    n_steps = eng.run()
    assert all(r.done for r in reqs)
    ys = np.stack([r.y for r in reqs])
    assert np.isfinite(ys).all()
    assert all(r.latency >= 0 for r in reqs)
    assert n_steps >= FIT["transform_steps"]
    np.testing.assert_array_equal(eng.y_full[:N_CORPUS].numpy().view(
        np.uint32), y_ref.view(np.uint32))


def test_projection_engine_deterministic(jax_fit, port_fit):
    """Same seed + same submission order -> bitwise-identical results."""
    x = jax_fit[0]

    def serve():
        eng = ProjectionEngine(port_fit, slots=8, seed=4)
        return _serve(eng, x[N_CORPUS:N_CORPUS + 12])[0]

    a, b = serve(), serve()
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_split_route_engine_equals_fused(port_fit, jax_fit):
    """The engine on the split route returns the fused route's bits."""
    xq = jax_fit[0][N_CORPUS:N_CORPUS + 40]
    out = {}
    for route in ("fused", "split"):
        cfg = LargeVisConfig(**FIT, routing=RoutingConfig(layout_step=route))
        out[route] = _serve(ProjectionEngine(port_fit, slots=16, seed=6,
                                             cfg=cfg), xq)[0]
    np.testing.assert_array_equal(out["fused"], out["split"])


# ---------------------------------------------------------------------------
# (g): the fault injector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", ["bogus", "layout_rounds",
                                  "calibrate_shard", "knn_ring_step:x"])
def test_fault_injector_rejects_sites_the_port_never_fires(site):
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector({site: {0: "exception"}})


def test_every_planned_site_fires(model):
    """A plan on the server's four sites: each fires, with the hit it
    names."""
    assert ft.FAULT_SITES == {"submit", "prefill", "retire", "step",
                              "stage:graph", "stage:weights",
                              "stage:samplers", "layout_chunk",
                              "layout_saved", "layout_round"}
    sites = {"submit", "prefill", "retire", "step"}
    plan = {site: {1: (lambda payload: payload)} for site in sites}
    fi = FaultInjector(plan)
    eng = _drain(model, [ProjectRequest(rid=i, x=x)
                         for i, x in enumerate(_queries(12))], fault=fi)
    assert sorted(fi.log) == sorted((s, 1, "callable") for s in sites)
    assert len(eng.completed) == 12


def test_poison_walks_tensors_arrays_and_containers():
    payload = (torch.arange(3, dtype=torch.int32), torch.ones(2, 2),
               [np.zeros(3, np.float32), np.arange(2)],
               {"y": torch.zeros(1, dtype=torch.float64), "tag": "x"},
               ProjectRequest(0, np.zeros(2, np.float32)))
    out = ft._poison(payload)
    assert isinstance(out, tuple) and isinstance(out[2], list)
    assert torch.equal(out[0], payload[0])
    assert torch.isnan(out[1]).all() and out[1].shape == (2, 2)
    assert np.isnan(out[2][0]).all() and np.array_equal(out[2][1],
                                                        np.arange(2))
    assert torch.isnan(out[3]["y"]).all() and out[3]["tag"] == "x"
    assert out[4] is payload[4]


def test_nan_step_spec_poisons_the_resident_embedding(model):
    """A "nan" spec at the step site: its payload, y_full, comes back
    all NaN and is copied into the resident buffer, so every request in
    flight is quarantined."""
    fi = FaultInjector({"step": {2: "nan"}})
    eng = ProjectionEngine(model, slots=4, seed=3, fault=fi)
    resident = eng.y_full
    for i, x in enumerate(_queries(3)):
        eng.submit(ProjectRequest(rid=i, x=x))
    eng.run()
    assert eng.y_full is resident and torch.isnan(resident).all()
    assert len(eng.quarantined) == 3 and not eng.completed


# ---------------------------------------------------------------------------
# (h): the device
# ---------------------------------------------------------------------------

def test_engine_raises_without_cuda_unless_asked_for_the_cpu(model,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = types.SimpleNamespace(x=model.x.numpy(), y=model.y.numpy(),
                                   cfg=CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ProjectionEngine(arrays, slots=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ProjectionEngine(model, slots=4, device="cuda")
    eng = ProjectionEngine(arrays, slots=4, device="cpu")
    assert eng.device.type == "cpu" and eng.neg_sampler.n_nodes == N
    # a model of CPU tensors runs where its tensors are
    assert ProjectionEngine(model, slots=4).device.type == "cpu"
