"""Crash-safe resume of the port's fit, on the CPU (``tests/test_resume.py``
of the JAX package at its own size, N=384, d=16).

Kill the pipeline at every stage boundary and mid-layout, rerun the SAME
call, and require the final embedding to be bitwise the uninterrupted
run's.  Bitwise is attainable because every stage is a function of
``(x, cfg)``, the layout checkpoint holds the layout generator's state
beside y (the port's counterpart of JAX's ``fold_in(kr, t)``), the lr
positions are a table indexed by the step, and checkpoints round-trip
f32 exactly.  One real ``SIGKILL`` and one ``SIGTERM`` (through the
``PreemptionGuard`` that ``largevis()`` arms) run in subprocesses.
"""
import dataclasses
import os
import shutil
import signal
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs.largevis_default import CheckpointConfig as JaxCkpt
from repro.configs.largevis_default import LargeVisConfig as JaxConfig
from repro.core.largevis import largevis as jax_largevis
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs.largevis_default import (CheckpointConfig,
                                                  LargeVisConfig)
from repro_torch.core.largevis import largevis
from repro_torch.runtime.fault_tolerance import FaultInjector, InjectedFault

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N, D = 384, 16
SMALL = dict(n_neighbors=8, n_trees=2, n_explore_iters=1, window=16,
             perplexity=6.0, samples_per_node=120, batch_size=64,
             steps_per_dispatch=10)
CFG = LargeVisConfig(**SMALL)


def _x():
    return np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)


def _fit(cfg, **kw):
    return largevis(_x(), cfg=cfg, device="cpu", **kw)


def _ckpt_cfg(tmp_path, base=CFG, **kw):
    return dataclasses.replace(
        base, checkpoint=CheckpointConfig(directory=str(tmp_path / "ckpt"),
                                          every_chunks=1, **kw))


@pytest.fixture(scope="module")
def baseline():
    """Uninterrupted fit (no checkpointing): the bitwise oracle."""
    return _fit(CFG).y


# ---------------------------------------------------------------------------
# in-process crash matrix (exception faults)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site,hit", [
    ("stage:graph", 0),
    ("stage:weights", 0),
    ("stage:samplers", 0),
    ("layout_saved", 0),         # after the first layout chunk committed
    ("layout_saved", 2),         # mid-layout
    ("layout_chunk", 5),         # after a chunk, before its checkpoint
])
def test_resume_bitwise_after_crash(tmp_path, baseline, site, hit):
    cfg = _ckpt_cfg(tmp_path)
    fi = FaultInjector({site: {hit: "exception"}})
    with pytest.raises(InjectedFault):
        _fit(cfg, fault=fi)
    assert fi.log == [(site, hit, "exception")]
    r = _fit(cfg)
    assert torch.equal(r.y, baseline)


def test_resume_skips_completed_stages(tmp_path, baseline, monkeypatch):
    """After a crash past the samplers boundary the rerun restores the
    graph, weights and samplers: it finishes with their build functions
    ripped out, and resumes the layout where it stopped."""
    lv = sys.modules["repro_torch.core.largevis"]
    cfg = _ckpt_cfg(tmp_path)
    with pytest.raises(InjectedFault):
        _fit(cfg, fault=FaultInjector({"layout_saved": {3: "exception"}}))

    def boom(*a, **kw):
        raise AssertionError("stage recomputed despite a valid checkpoint")

    monkeypatch.setattr(lv.knn_lib, "build_knn_graph", boom)
    monkeypatch.setattr(lv.perp_lib, "edge_weights", boom)
    monkeypatch.setattr(lv.sampler_lib, "build_edge_sampler", boom)
    monkeypatch.setattr(lv.sampler_lib, "build_negative_sampler", boom)
    r = _fit(cfg)
    assert torch.equal(r.y, baseline)
    assert r.steps == 720 - 40       # resumed after its 4th chunk


def test_fingerprint_rejects_foreign_checkpoint(tmp_path, baseline):
    """A directory written by a DIFFERENT run (other data) is refused
    with a warning and every stage recomputes."""
    cfg = _ckpt_cfg(tmp_path)
    other = np.random.default_rng(9).normal(size=(N, D)).astype(np.float32)
    largevis(other, cfg=cfg, device="cpu")           # fills the directory
    with pytest.warns(RuntimeWarning, match="different run"):
        r = _fit(cfg)
    assert torch.equal(r.y, baseline)


def test_fingerprint_rejects_another_seed(tmp_path, baseline):
    """The generators' entry states are part of the fingerprint."""
    cfg = _ckpt_cfg(tmp_path)
    _fit(dataclasses.replace(cfg, seed=5))
    with pytest.warns(RuntimeWarning, match="different run"):
        r = _fit(cfg)
    assert torch.equal(r.y, baseline)


def test_resume_false_ignores_checkpoints(tmp_path, baseline):
    cfg = _ckpt_cfg(tmp_path)
    with pytest.raises(InjectedFault):
        _fit(cfg, fault=FaultInjector({"layout_saved": {2: "exception"}}))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r = _fit(_ckpt_cfg(tmp_path, resume=False))   # full recompute
    assert torch.equal(r.y, baseline) and r.steps == 720


def test_completed_run_resumes_to_same_result(tmp_path, baseline):
    """Rerunning after a completed checkpointed fit reloads the final
    layout: same bits, no layout steps."""
    cfg = _ckpt_cfg(tmp_path)
    first = _fit(cfg)
    assert torch.equal(first.y, baseline)
    r = _fit(cfg)
    assert torch.equal(r.y, baseline) and r.steps == 0


def test_torn_layout_checkpoint_is_ignored(tmp_path, baseline):
    """A crash inside a checkpoint write (no _COMMITTED): the resume falls
    back to the previous committed chunk and still lands on the oracle."""
    cfg = _ckpt_cfg(tmp_path, keep=3)
    with pytest.raises(InjectedFault):
        _fit(cfg, fault=FaultInjector({"layout_saved": {2: "exception"}}))
    layout_dir = tmp_path / "ckpt" / "layout"
    steps = ck.all_steps(layout_dir)
    assert steps == [10, 20, 30]
    (layout_dir / f"step_{steps[-1]}" / "_COMMITTED").unlink()
    r = _fit(cfg)
    assert torch.equal(r.y, baseline) and r.steps == 720 - 20


def test_checkpoint_only_run_is_bitwise_and_saves_off_thread(tmp_path,
                                                             baseline):
    """No fault, health or on_chunk: the saves go through the writer
    thread, every ``every_chunks`` chunks and at the end."""
    cfg = dataclasses.replace(CFG, checkpoint=CheckpointConfig(
        directory=str(tmp_path / "ckpt"), every_chunks=4, keep=3))
    r = _fit(cfg)
    assert torch.equal(r.y, baseline)
    assert ck.all_steps(tmp_path / "ckpt" / "layout") == [640, 680, 720]
    tree, step = ck.restore(tmp_path / "ckpt" / "layout")
    assert step == 720 and np.array_equal(tree["y"], baseline.numpy())
    assert tree["rng"].dtype == np.uint8


def test_jax_written_stages_are_refused_and_recomputed(tmp_path, baseline):
    """A stage directory written by the JAX package reads cleanly (the
    tree codec is shared) but its fingerprint hashes a JAX key, not the
    port's generators: each stage is refused with the warning and
    recomputed."""
    d = str(tmp_path / "ckpt")
    jcfg = JaxConfig(**SMALL, checkpoint=JaxCkpt(directory=d,
                                                 every_chunks=1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # its host-demoted alias tables
        jax_largevis(_x(), jax.random.key(7), cfg=jcfg)
    assert sorted(os.listdir(d)) == ["graph", "layout", "samplers",
                                     "weights"]
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        r = _fit(_ckpt_cfg(tmp_path))
    refused = sorted(str(w.message).split("'")[1] for w in log
                     if "different run" in str(w.message))
    assert refused == ["graph", "layout", "samplers"]  # weights: not read
    assert torch.equal(r.y, baseline)


# ---------------------------------------------------------------------------
# real signals in a subprocess (no cleanup, no flushing)
# ---------------------------------------------------------------------------

_WORKER = r"""
import dataclasses, os, signal, sys
sys.path.insert(0, SRC)
import numpy as np
from repro_torch.configs.largevis_default import (CheckpointConfig,
                                                  LargeVisConfig)
from repro_torch.core.largevis import largevis
from repro_torch.runtime.fault_tolerance import FaultInjector

cfg = LargeVisConfig(n_neighbors=8, n_trees=2, n_explore_iters=1, window=16,
                     perplexity=6.0, samples_per_node=120, batch_size=64,
                     steps_per_dispatch=10)
if os.environ.get("RESUME_CKPT"):
    cfg = dataclasses.replace(cfg, checkpoint=CheckpointConfig(
        directory=os.environ["RESUME_CKPT"],
        every_chunks=int(os.environ["RESUME_EVERY"])))
x = np.random.default_rng(0).normal(size=(384, 16)).astype(np.float32)
site, hit = os.environ.get("RESUME_SITE"), int(os.environ["RESUME_HIT"])
spec = os.environ.get("RESUME_SPEC")
if spec == "sigterm":          # a preemption notice, delivered mid-layout
    def spec(y):
        os.kill(os.getpid(), signal.SIGTERM)
        return y
fault = FaultInjector({site: {hit: spec}}) if site else None
res = largevis(x, cfg=cfg, device="cpu", fault=fault)
np.save(os.environ["RESUME_OUT"], res.y.numpy())
print("WORKER_DONE", res.steps)
"""


def _run_worker(tmp_path, out_name, *, site=None, hit=0, spec="kill",
                ckpt=None, every=1):
    env = dict(os.environ,
               RESUME_OUT=str(tmp_path / out_name),
               RESUME_SITE=site or "", RESUME_HIT=str(hit),
               RESUME_SPEC=spec, RESUME_EVERY=str(every),
               RESUME_CKPT=str(ckpt) if ckpt else "")
    script = _WORKER.replace("SRC", repr(os.path.join(REPO, "src")))
    return subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def clean_subprocess(tmp_path_factory):
    """An uninterrupted fit in a subprocess of its own."""
    d = tmp_path_factory.mktemp("clean")
    done = _run_worker(d, "clean.npy")
    assert done.returncode == 0, done.stderr[-2000:]
    return np.load(d / "clean.npy")


def test_sigkill_mid_layout_resume_bitwise(tmp_path, clean_subprocess):
    """A REAL SIGKILL two committed layout chunks in, restart, bitwise an
    uninterrupted subprocess run."""
    ckpt = tmp_path / "ckpt"
    killed = _run_worker(tmp_path, "na.npy", site="layout_saved", hit=2,
                         ckpt=ckpt)
    assert killed.returncode == -signal.SIGKILL, (killed.returncode,
                                                  killed.stderr[-2000:])
    resumed = _run_worker(tmp_path, "resumed.npy", ckpt=ckpt)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "WORKER_DONE 690" in resumed.stdout
    assert np.array_equal(np.load(tmp_path / "resumed.npy"),
                          clean_subprocess)


def test_sigterm_preemption_saves_and_resumes_bitwise(tmp_path,
                                                      clean_subprocess):
    """SIGTERM mid-layout with no cadence save due: the PreemptionGuard
    that ``largevis()`` armed holds the signal to the end of the chunk it
    arrived in, writes that boundary, then the process dies by the
    signal; the rerun resumes from that save."""
    ckpt = tmp_path / "ckpt"
    term = _run_worker(tmp_path, "na.npy", site="layout_chunk", hit=2,
                       spec="sigterm", ckpt=ckpt, every=1000)
    assert term.returncode == -signal.SIGTERM, (term.returncode,
                                                term.stderr[-2000:])
    # the guard's save: the boundary after the third chunk, in which the
    # signal arrived
    assert ck.all_steps(ckpt / "layout") == [30]
    resumed = _run_worker(tmp_path, "resumed.npy", ckpt=ckpt, every=1000)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "WORKER_DONE 690" in resumed.stdout
    assert np.array_equal(np.load(tmp_path / "resumed.npy"),
                          clean_subprocess)


def test_preemption_in_a_checkpoint_only_run(tmp_path, baseline,
                                            monkeypatch):
    """A signal that lands inside a chunk of a checkpoint-only run (the
    saves on the writer thread) is held to that chunk's boundary, which
    is saved after the writer's queue; the fit goes on, and the save is
    a state that resumes bitwise."""
    from repro_torch.core import layout_engine
    from repro_torch.runtime.fault_tolerance import PreemptionGuard
    cfg = _ckpt_cfg(tmp_path)
    cfg = dataclasses.replace(cfg, checkpoint=dataclasses.replace(
        cfg.checkpoint, every_chunks=1000))
    run, calls = layout_engine.StepChunks.run, []

    def signalled(self, generator, lrs):
        run(self, generator, lrs)
        calls.append(len(calls))
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGUSR1)

    monkeypatch.setattr(layout_engine.StepChunks, "run", signalled)
    guard = PreemptionGuard(signals=(signal.SIGUSR1,)).activate()
    try:
        r = _fit(cfg)
    finally:
        guard.restore_handlers()
    assert torch.equal(r.y, baseline)
    assert guard.triggered and guard.pending is None
    layout_dir = tmp_path / "ckpt" / "layout"
    assert ck.all_steps(layout_dir) == [30, 720]
    shutil.rmtree(layout_dir / "step_720")
    monkeypatch.setattr(layout_engine.StepChunks, "run", run)
    resumed = _fit(cfg)
    assert resumed.steps == 720 - 30
    assert torch.equal(resumed.y, baseline)


def test_guard_is_disarmed_after_the_fit(tmp_path):
    """The fit restores the signal handlers it replaced."""
    from repro_torch.runtime.fault_tolerance import PreemptionGuard
    before = signal.getsignal(signal.SIGTERM)
    _fit(_ckpt_cfg(tmp_path))
    assert signal.getsignal(signal.SIGTERM) is before
    assert PreemptionGuard.active() is None
