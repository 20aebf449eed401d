"""The layout's health guard, rollback, degraded mode and watchdog in the
port, on the CPU (``tests/test_robustness.py:47-215`` of the JAX package
at its own size, N=400).

Divergence is driven through the fault injector's ``nan`` payload at the
``layout_chunk`` site, so the probe, the rollback (y and the generator
restored in place), the lr backoff and the give-up path all run on the
real chunk loop.  The demotion patches the fused edge step to raise.
``layout_health``, ``Watchdog`` and the backed-off lr are held to the
JAX package's on the same inputs.
"""
import dataclasses
import os
import signal
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layout import layout_health as jax_layout_health
from repro.runtime.fault_tolerance import Watchdog as JaxWatchdog
from repro_torch.configs.largevis_default import (HealthConfig,
                                                  LargeVisConfig,
                                                  RoutingConfig)
from repro_torch.core import layout_engine
from repro_torch.core import sampler as sampler_lib
from repro_torch.core.layout import layout_health, run_layout
from repro_torch.kernels import ops
from repro_torch.runtime.fault_tolerance import (DegradedModeWarning,
                                                 DivergenceWarning,
                                                 FaultInjector,
                                                 InjectedFault,
                                                 LayoutDivergedError,
                                                 PreemptionGuard, Watchdog)

N = 400
CFG = LargeVisConfig(n_neighbors=8, n_trees=2, n_explore_iters=1, window=16,
                     perplexity=6.0, samples_per_node=200, batch_size=128,
                     steps_per_dispatch=20)
STEPS = 200 * N // 128                  # 625: 31 chunks of 20, then 5


@pytest.fixture(scope="module")
def samplers():
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, N, (N, 8)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (N, 8)).astype(np.float32))
    return (sampler_lib.build_edge_sampler(idx, w),
            sampler_lib.build_negative_sampler(idx, w))


def _layout(samplers, cfg, **kw):
    es, ns = samplers
    gen = torch.Generator().manual_seed(3)
    return run_layout(gen, es, ns, N, cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def plain(samplers):
    return _layout(samplers, CFG)


def _warned(log, cls):
    return [w for w in log if issubclass(w.category, cls)]


# ---------------------------------------------------------------------------
# health probe + rollback
# ---------------------------------------------------------------------------

def _probe_cases():
    rng = np.random.default_rng(1)
    y = rng.normal(size=(64, 2)).astype(np.float32) * 10
    nan_rows = y.copy()
    nan_rows[[3, 17]] = np.nan
    mixed = y.copy()
    mixed[0, 1], mixed[5, 0], mixed[9, 1] = np.nan, np.inf, -np.inf
    all_bad = np.full((4, 3), np.nan, np.float32)
    neg_max = np.array([[1.0, -2.0], [3.0, -4.5]], np.float32)
    return {"finite": y, "nan_rows": nan_rows, "mixed": mixed,
            "all_nonfinite": all_bad, "negative_max": neg_max}


@pytest.mark.parametrize("name", sorted(_probe_cases()))
def test_layout_health_matches_jax(name):
    y = _probe_cases()[name]
    nf, mx = layout_health(torch.from_numpy(y))
    jnf, jmx = jax_layout_health(jnp.asarray(y))
    assert int(nf) == int(jnf)
    assert np.float32(mx.item()) == np.float32(jmx)
    assert nf.dtype == torch.int64 and mx.dtype == torch.float32


def test_divergence_rolls_back_with_backoff(samplers):
    cfg = dataclasses.replace(CFG, health=HealthConfig(max_rollbacks=3))
    fi = FaultInjector({"layout_chunk": {1: "nan"}})
    with pytest.warns(DivergenceWarning) as wlog:
        r = _layout(samplers, cfg, fault=fi)
    warned = _warned(wlog, DivergenceWarning)
    assert len(warned) == 1
    w = warned[0].message
    assert (w.step, w.rollback_to, w.nonfinite) == (40, 20, 2 * N)
    assert r.rollbacks == 1 and r.rho0_scale == 0.5
    assert bool(torch.isfinite(r.y).all())
    # the full sample budget still ran despite the replayed chunk
    assert r.steps == STEPS and r.steps * 128 == r.edge_samples
    assert r.dispatches == 32 + 1


def test_rollback_restores_y_and_generator(samplers):
    """A rollback is a replay from the last healthy chunk: with the lr
    backoff at 1.0 the result is bitwise the run without the fault."""
    clean = _layout(samplers, dataclasses.replace(
        CFG, health=HealthConfig())).y
    cfg = dataclasses.replace(CFG, health=HealthConfig(lr_backoff=1.0))
    with pytest.warns(DivergenceWarning):
        r = _layout(samplers, cfg,
                    fault=FaultInjector({"layout_chunk": {4: "nan"}}))
    assert r.rollbacks == 1 and torch.equal(r.y, clean)


def test_norm_blowup_triggers_rollback(samplers):
    cfg = dataclasses.replace(CFG, health=HealthConfig(max_abs=1e3))

    def blowup(y):
        y[0, 0] = 1e9                  # finite, but way past max_abs
        return y

    fi = FaultInjector({"layout_chunk": {2: blowup}})
    with pytest.warns(DivergenceWarning):
        r = _layout(samplers, cfg, fault=fi)
    assert r.rollbacks == 1
    assert float(r.y.abs().max()) < 1e3


def test_persistent_divergence_raises(samplers):
    cfg = dataclasses.replace(CFG, health=HealthConfig(max_rollbacks=2))
    fi = FaultInjector({"layout_chunk": {i: "nan" for i in range(50)}})
    with pytest.raises(LayoutDivergedError):
        with pytest.warns(DivergenceWarning):
            _layout(samplers, cfg, fault=fi)


def test_healthy_run_unaffected_by_health_guard(samplers, plain):
    """The guard observes only: same bits as an unguarded run."""
    cfg = dataclasses.replace(CFG, health=HealthConfig())
    r1 = _layout(samplers, cfg)
    assert torch.equal(plain.y, r1.y)
    assert r1.rollbacks == 0 and r1.rho0_scale == 1.0


def test_lr_table_after_backoff_is_scaled_step_lr_and_jax_line(
        samplers, monkeypatch):
    """After a rollback the chunks take a new table at rho0 * 0.5:
    bitwise ``step_lr`` at the scaled rho0, and bitwise the JAX step's
    ``rho0 * jnp.maximum(1.0 - t_frac, 1e-4)`` evaluated eagerly."""
    seen = []
    real_run = layout_engine.StepChunks.run

    def spy(self, generator, lrs):
        seen.append(lrs.clone())
        return real_run(self, generator, lrs)

    monkeypatch.setattr(layout_engine.StepChunks, "run", spy)
    rho0 = 0.7
    cfg = dataclasses.replace(CFG, rho0=rho0, health=HealthConfig())
    with pytest.warns(DivergenceWarning):
        r = _layout(samplers, cfg,
                    fault=FaultInjector({"layout_chunk": {1: "nan"}}))
    assert r.rho0_scale == 0.5
    lrs = torch.cat(seen[:1] + seen[2:])     # the rolled-back chunk left out
    assert lrs.shape == (STEPS,)
    t_frac = jnp.asarray(np.arange(STEPS) / STEPS, jnp.float32)
    for t, scale in ((range(0, 20), 1.0), (range(20, STEPS), 0.5)):
        got = lrs[t.start:t.stop].numpy()
        want = np.array([layout_engine.step_lr(rho0 * scale, i / STEPS)
                         for i in t], np.float32)
        jax_line = np.asarray((rho0 * scale) * jnp.maximum(
            1.0 - t_frac, 1e-4))[t.start:t.stop]
        assert np.array_equal(got, want)
        assert np.array_equal(got, jax_line)


# ---------------------------------------------------------------------------
# degraded-mode routing
# ---------------------------------------------------------------------------

def test_fused_step_demotes_to_split_on_backend_failure(
        samplers, monkeypatch):
    """A fused-kernel failure in the first chunk demotes the run to the
    split route with ONE DegradedModeWarning; the result is the split
    route's bits (which are the fused route's, in the port)."""
    want = _layout(samplers, dataclasses.replace(
        CFG, routing=RoutingConfig(layout_step="split"))).y
    real = ops.largevis_edge_step
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:             # mid-chunk: y already moved
            raise RuntimeError("no kernel image is available")
        return real(*a, **kw)

    monkeypatch.setattr(ops, "largevis_edge_step", flaky)
    with pytest.warns(DegradedModeWarning) as wlog:
        r = _layout(samplers, CFG, fault=FaultInjector())
    warned = _warned(wlog, DegradedModeWarning)
    assert len(warned) == 1
    assert (warned[0].message.from_impl, warned[0].message.to_impl) == (
        "fused", "split")
    assert calls["n"] == 3               # nothing fused after the demotion
    assert torch.equal(r.y, want)


def test_injected_fault_is_not_demoted(samplers, monkeypatch):
    def injected(*a, **kw):
        raise InjectedFault("layout_chunk", 0)

    monkeypatch.setattr(ops, "largevis_edge_step", injected)
    with pytest.raises(InjectedFault):
        _layout(samplers, CFG)


def test_failure_after_the_first_chunk_is_not_demoted(samplers,
                                                      monkeypatch):
    real = ops.largevis_edge_step
    calls = {"n": 0}

    def late(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 25:            # in the second chunk
            raise RuntimeError("late failure")
        return real(*a, **kw)

    monkeypatch.setattr(ops, "largevis_edge_step", late)
    with pytest.raises(RuntimeError, match="late failure"):
        _layout(samplers, CFG)


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_flags_straggler_dispatch(samplers):
    """run_layout times every synced dispatch; a chunk stalled at its
    fault site (inside the timed window) lands in result.stragglers."""
    def stall(y):
        time.sleep(0.05)
        return y

    r = _layout(samplers, CFG,
                fault=FaultInjector({"layout_chunk": {20: stall}}))
    assert [s for s in r.stragglers if s[1] >= 0.05][0][0] == 21 * 20


@pytest.mark.parametrize("seed", range(4))
def test_watchdog_observe_matches_jax(seed):
    rng = np.random.default_rng(seed)
    dts = rng.lognormal(-4.0, 0.6, size=300)
    dts[rng.integers(0, 300, 6)] *= 20
    ours, theirs = Watchdog(threshold=3.0), JaxWatchdog(threshold=3.0)
    flags = [(ours.observe(i, float(dt)), theirs.observe(i, float(dt)))
             for i, dt in enumerate(dts)]
    assert all(a == b for a, b in flags)
    assert ours.stragglers == theirs.stragglers and ours.stragglers


# ---------------------------------------------------------------------------
# preemption guard
# ---------------------------------------------------------------------------

def test_preemption_guard_defers_to_the_loop():
    """Undeferred, a signal runs the save in the handler, as the JAX
    package's guard does; deferred, the handler only records the signal,
    and finish() runs the save."""
    saves = []
    guard = PreemptionGuard(lambda: saves.append(len(saves)),
                            signals=(signal.SIGUSR1,))
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        assert saves == [0] and guard.pending is None
        guard.defer()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert saves == [0] and guard.pending == signal.SIGUSR1
        guard.finish()
        assert saves == [0, 1] and guard.pending is None
        assert guard.triggered and guard.deferred
    finally:
        guard.restore_handlers()


def test_on_chunk_sees_every_boundary(samplers, plain):
    seen = []
    r = _layout(samplers, CFG, on_chunk=lambda t, steps, y: seen.append(
        (t, steps, y.clone())))
    assert [t for t, _, _ in seen] == list(range(20, STEPS, 20)) + [STEPS]
    assert torch.equal(seen[-1][2], plain.y) and torch.equal(r.y, plain.y)


def test_explicit_resume_from_y0(samplers, plain):
    """``y0``/``start_step`` with the generator where the step finds it
    continue the trajectory bitwise."""
    es, ns = samplers
    gen = torch.Generator().manual_seed(3)
    state = {}

    def grab(t, steps, y):
        if t == 200:
            state.update(y=y.clone(), rng=gen.get_state())

    run_layout(gen, es, ns, N, CFG, device="cpu", on_chunk=grab)
    gen2 = torch.Generator()
    gen2.set_state(state["rng"])
    r = run_layout(gen2, es, ns, N, CFG, device="cpu", y0=state["y"],
                   start_step=200)
    assert r.steps == STEPS - 200 and torch.equal(r.y, plain.y)
