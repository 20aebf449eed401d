"""The port's distributed fit on the CPU: the local-SGD layout, the shard
fault sites and the mesh retry, elastic resume, the mesh's pieces.

World sizes 1, 2 and 4 of gloo processes (``tests/torch_dist_ranks.py``:
one spawn a world size, every check's data from it; the world of 2 runs
first, and the others resume its layout checkpoint).  Held:

* the local-SGD layout: at world 1 it is ``run_layout``, and the
  sharded samplers give the flat samplers' trajectory bitwise; at every
  world two runs from one seed are bitwise equal, and every rank holds
  the same replica;
* the 2000-point quality fixture (``tests/test_layout_engine.py``'s
  config, at the default ``sync_every`` of one step) fitted by
  ``largevis(distributed=True)``: 5-NN accuracy >= 0.95 at P = 1, 2
  and 4;
* the fault sites: the registry is the JAX package's; ``fire_per_shard``
  turns an injected exception into ``ShardFailedError``; through
  ``largevis()`` a shard fault at any sharded stage halves the mesh with
  exactly one ``DegradedModeWarning`` and completes on every rank, and
  at one shard it propagates;
* elastic resume: a layout checkpoint killed after its second save
  resumes at the same P bitwise an uninterrupted run, and at another P
  from the round boundary of its committed samples with exactly one
  ``TopologyChangeWarning``;
* the row layout helpers are the JAX package's, the topology tag names
  the mesh's real shard count, and no module of ``repro_torch`` imports
  JAX (the new ones listed by name).
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.runtime import fault_tolerance as jft
from repro.runtime import sharding as jsh
from repro_torch.checkpoint import largevis_state as lvs
from repro_torch.configs.largevis_default import (CheckpointConfig,
                                                  LargeVisConfig)
from repro_torch.core import knn as tknn
from repro_torch.core import perplexity as tperp
from repro_torch.data.synthetic import gaussian_mixture
from repro_torch.launch.mesh import DataMesh
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime import sharding as tsh

SRC = Path(__file__).resolve().parents[1] / "src"
LAYOUT_CFG = dict(n_neighbors=10, n_trees=4, perplexity=5.0,
                  samples_per_node=100, batch_size=64, sync_every=4,
                  steps_per_dispatch=4)
FIXTURE_CFG = dict(n_neighbors=15, n_trees=4, n_explore_iters=2, window=32,
                   perplexity=10.0, samples_per_node=2000, batch_size=4096)
EVERY = 20                    # layout checkpoint cadence, in dispatches


@pytest.fixture(scope="module")
def graph():
    """A 403-point graph and its weights (one shard, the CPU)."""
    x, _ = gaussian_mixture(4, 403, 16, 4)
    idx, dist = tknn.brute_force_knn(torch.from_numpy(x), 10)
    w = tperp.edge_weights(idx, dist, 5.0)
    fx, labels = gaussian_mixture(0, 2000, 32, 8)
    return {"x": x, "idx": idx.numpy(), "w": w.numpy(),
            "fixture": {"x": fx, "labels": labels, "cfg": FIXTURE_CFG}}


_WORLDS: dict = {}


def _sites(P):
    if P == 1:
        return ["knn_ring_step:0"]
    return [f"knn_ring_step:{P - 1}", "calibrate_shard:0",
            "symmetrize_exchange:1", "local_sgd_round:0"]


def world(P, graph, tmp_path_factory):
    """The ranks' results of world size P; the world of 2 runs first and
    leaves its killed layout checkpoint for the others to resume."""
    if P in _WORLDS:
        return _WORLDS[P]
    foreign = None
    if P != 2:
        two = world(2, graph, tmp_path_factory)
        foreign = str(tmp_path_factory.mktemp(f"from2_to{P}") / "ckpt")
        shutil.copytree(two["ckpt_dir"], foreign)
    tmp = tmp_path_factory.mktemp(f"l{P}")
    pl = dict(graph, layout_cfg=LAYOUT_CFG, fault_sites=_sites(P),
              ckpt_dir=str(tmp / "ckpt"), every=EVERY, foreign=foreign)
    out = ranks.run_world("layout_world", P, tmp, pl)
    for r in out[1:]:                       # every rank holds the result
        for key, v in out[0].items():
            np.testing.assert_array_equal(r[key], v, err_msg=key)
    _WORLDS[P] = dict(out[0], ckpt_dir=pl["ckpt_dir"])
    return _WORLDS[P]


WORLD_SIZES = [1, 2, 4]


@pytest.mark.parametrize("P", WORLD_SIZES)
def test_local_sgd_bitwise_runs_and_samplers(P, graph, tmp_path_factory):
    got = world(P, graph, tmp_path_factory)
    np.testing.assert_array_equal(got["y_sharded"], got["y_sharded2"])
    assert np.isfinite(got["y_sharded"]).all()
    steps, dispatches, samples = got["steps_sharded"]
    n = graph["idx"].shape[0]
    assert samples <= LAYOUT_CFG["samples_per_node"] * n
    if P == 1:      # the sharded samplers are the flat ones at one shard,
        # and a world of one is run_layout, steps_per_dispatch a dispatch
        np.testing.assert_array_equal(got["y_flat"], got["y_sharded"])
        np.testing.assert_array_equal(got["y_run_layout"], got["y_sharded"])
        assert dispatches == -(-steps // LAYOUT_CFG["steps_per_dispatch"])
    else:           # a round a dispatch, a sync after each
        assert steps % LAYOUT_CFG["sync_every"] == 0
        assert dispatches == steps // LAYOUT_CFG["sync_every"]
        assert not np.array_equal(got["y_flat"], got["y_sharded"])


@pytest.mark.parametrize("P", WORLD_SIZES)
def test_fixture_accuracy(P, graph, tmp_path_factory):
    got = world(P, graph, tmp_path_factory)
    assert float(got["fixture_acc"]) >= 0.95, float(got["fixture_acc"])
    assert np.isfinite(got["fixture_y"]).all()


@pytest.mark.parametrize("P", WORLD_SIZES)
def test_estimator_and_forest_stage(P, graph, tmp_path_factory):
    """``LargeVis(distributed=True).fit`` is ``largevis()``; under
    ``routing.knn_stage="forest"`` the graph is the single-device
    forest's and the sharded weights are bitwise the flat ones."""
    got = world(P, graph, tmp_path_factory)
    np.testing.assert_array_equal(got["fit_y"], got["largevis_y"])
    assert np.isfinite(got["fit_y"]).all()
    for f in ("idx", "dist", "w"):
        np.testing.assert_array_equal(got[f"forest_{f}"], got[f"flat_{f}"])


@pytest.mark.parametrize("P", WORLD_SIZES)
def test_mesh_retry(P, graph, tmp_path_factory):
    got = world(P, graph, tmp_path_factory)
    for site in _sites(P):
        warned = [str(m) for m in got[f"fault_warn_{site}"] if str(m)]
        if P == 1:                          # nothing to shed: it propagates
            shard = site.rsplit(":", 1)[1]
            assert str(got[f"fault_err_{site}"]) == f"knn:{shard}"
            assert warned == []
            continue
        assert str(got[f"fault_err_{site}"]) == ""
        assert len(warned) == 1, (site, warned)
        assert f"'mesh[{P}]' -> 'mesh[{P // 2}]'" in warned[0], warned
        assert np.isfinite(got[f"fault_y_{site}"]).all()


@pytest.mark.parametrize("P", WORLD_SIZES)
def test_elastic_resume(P, graph, tmp_path_factory):
    got = world(P, graph, tmp_path_factory)
    assert bool(got["killed"])
    # the same shard count: bitwise the uninterrupted run, no warning
    np.testing.assert_array_equal(got["resumed_y"], got["whole_y"])
    assert int(got["resumed_warn"]) == 0
    if P == 2:
        return
    # world 2's checkpoint: from its last round boundary, one warning
    warned = [str(m) for m in got["foreign_warn"] if str(m)]
    assert len(warned) == 1, warned
    assert warned[0].startswith("TopologyChangeWarning: layout checkpoint "
                                f"written on a 2-shard mesh resumed on {P}")
    assert np.isfinite(got["foreign_y"]).all()
    assert 0 < int(got["foreign_steps"])
    assert not np.array_equal(got["foreign_y"], got["whole_y"])


def test_fault_site_registry_matches_jax():
    assert ft.FAULT_SITES == jft.FAULT_SITES
    assert ft.SHARDED_FAULT_SITES == jft.SHARDED_FAULT_SITES
    for site in ("knn_ring_step:0", "local_sgd_round:12", "layout_round",
                 "knn_ring_step", "knn_ring_step:x", "bogus:1",
                 "calibrate_shard:-1", "stage:graph"):
        assert ft._valid_site(site) == jft._valid_site(site), site
    with pytest.raises(ValueError, match="unknown fault site"):
        ft.FaultInjector({"symmetrize_exchange": {0: "exception"}})


def test_fire_per_shard():
    assert ft.fire_per_shard(None, "calibrate_shard", 3,
                             stage="calibrate") is None
    fi = ft.FaultInjector({"local_sgd_round:1": {0: lambda dt: dt * 10}})
    out = ft.fire_per_shard(fi, "local_sgd_round", 3, stage="layout",
                            payloads=[1.0, 1.0, 1.0])
    assert out == [1.0, 10.0, 1.0]
    fi = ft.FaultInjector({"calibrate_shard:2": {0: "exception"}})
    with pytest.raises(ft.ShardFailedError) as e:
        ft.fire_per_shard(fi, "calibrate_shard", 3, stage="calibrate")
    assert (e.value.stage, e.value.shard) == ("calibrate", 2)
    assert isinstance(e.value.cause, ft.InjectedFault)
    assert [s for s, _, _ in fi.log] == ["calibrate_shard:2"]
    # the hit counts persist: a second pass fires nothing
    ft.fire_per_shard(fi, "calibrate_shard", 3, stage="calibrate")
    w = ft.TopologyChangeWarning("layout", 4, 2, 7)
    assert (w.saved_shards, w.new_shards, w.resumed_at) == (4, 2, 7)


@pytest.mark.parametrize("n,P", [(403, 1), (403, 2), (403, 3), (403, 4),
                                 (256, 4), (5, 8)])
def test_row_layout_matches_jax(n, P):
    assert tsh.rows_per_shard(n, P) == jsh.rows_per_shard(n, P)
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got = tsh.pad_rows(torch.from_numpy(x), P).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsh.pad_rows(x, P)))
    n_loc = tsh.rows_per_shard(n, P)
    for r in range(P):
        mesh = DataMesh(None, r, P, torch.device("cpu"), "gloo", r, P)
        np.testing.assert_array_equal(tsh.shard_rows(torch.from_numpy(x),
                                                     mesh).numpy(),
                                      got[r * n_loc:(r + 1) * n_loc])


def test_topology_tag_and_restore_onto_a_mesh(tmp_path):
    cfg = LargeVisConfig(distributed=True, data_shards=0)
    mesh = DataMesh(None, 1, 3, torch.device("cpu"), "gloo", 1, 3)
    assert lvs.topology_tag(cfg, 403, mesh) == {
        "distributed": True, "data_shards": 3, "n_rows": 403}
    assert lvs.topology_tag(dataclasses.replace(cfg, distributed=False),
                            403, mesh)["data_shards"] == 1
    ck = lvs.StageCheckpointer(CheckpointConfig(str(tmp_path)), "fp")
    idx = torch.arange(403 * 2, dtype=torch.int32).reshape(403, 2)
    ck.save("graph", {"idx": idx},
            extra={"topology": lvs.topology_tag(cfg, 403, mesh)})
    tree, _, extra = ck.restore("graph", mesh=mesh)
    assert torch.equal(tree["idx"], idx)        # global, on the mesh device
    assert extra["topology"]["data_shards"] == 3
    # a degenerate tag (more shards than rows) is skipped with a warning
    ck.save("weights", {"w": torch.zeros(2, 2)}, extra={"topology": {
        "distributed": True, "data_shards": 4, "n_rows": 2}})
    with pytest.warns(RuntimeWarning, match="cannot re-shard"):
        assert ck.restore("weights", mesh=mesh) is None


def test_distributed_modules_import_no_jax():
    new = ["repro_torch.launch.mesh", "repro_torch.runtime.sharding",
           "repro_torch.core.knn_sharded", "repro_torch.optim.grad_compress",
           "repro_torch.launch.steps", "repro_torch.launch.train",
           "repro_torch.models.attention", "repro_torch.models.moe",
           "repro_torch.models.layers", "repro_torch.models.lm",
           "repro_torch.models.factory", "repro_torch.convert",
           "repro_torch.launch.serve_mesh"]
    code = ("import importlib, sys\n"
            f"for m in {new!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
