"""The port's checkpoints against the JAX package's, on the CPU.

* The tree-structure codec (``repro_torch.checkpoint.treedef``) is byte
  for byte JAX's ``PyTreeDef.serialize_using_proto`` for every tree the
  port writes (the graph, weights, samplers and layout stages, and the
  fitted-model file with and without its optional keys), and reads JAX's
  bytes back; it refuses any tree that is not a dict of arrays.
* The checkpointer keeps the v2 contract: bitwise round trip, commit
  marker, CRC fallback, schema check, keep-k rotation — and a directory
  written by either package's ``save`` restores in the other's
  ``restore``, leaves bitwise.
* A model saved by the JAX package's ``save_result`` loads through
  ``repro_torch.LargeVis.load``, and one saved by the port loads through
  JAX's ``load_result``: arrays, sampler tables and config fields equal.
"""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.checkpoint import largevis_state as jlvs
from repro.configs.largevis_default import CheckpointConfig as JaxCkpt
from repro.configs.largevis_default import HealthConfig as JaxHealth
from repro.configs.largevis_default import LargeVisConfig as JaxConfig
from repro.core.largevis import largevis as jax_largevis
import repro_torch
from repro_torch import LargeVisConfig
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.checkpoint import largevis_state as lvs
from repro_torch.checkpoint import treedef
from repro_torch.configs.largevis_default import (CheckpointConfig,
                                                  HealthConfig)
from repro_torch.core.largevis import largevis

N, D = 200, 8
SMALL = dict(n_neighbors=6, n_trees=2, n_explore_iters=1, window=8,
             perplexity=4.0, samples_per_node=20, batch_size=64,
             steps_per_dispatch=10)

_EDGE = {"src": 0, "dst": 0, "threshold": 0, "alias": 0}
_NEG = {"threshold": 0, "alias": 0}
_RESULT = {"y": 0, "knn_idx": 0, "knn_dist": 0, "weights": 0}
# the structures of every tree the port writes (the layout's as the JAX
# package writes it too, which the port must read)
TREES = {
    "graph": {"idx": 0, "dist": 0},
    "weights": {"w": 0},
    "samplers": {"edge": _EDGE, "neg": _NEG},
    "layout": {"y": 0, "rng": 0},
    "layout_jax": {"y": 0},
    "result": {**_RESULT, "x": 0, "samplers": {"edge": _EDGE, "neg": _NEG}},
    "result_no_x": {**_RESULT, "samplers": {"edge": _EDGE, "neg": _NEG}},
    "result_no_samplers": {**_RESULT, "x": 0},
    "result_bare": dict(_RESULT),
    "result_jax": {**_RESULT, "x": 0, "key_data": 0,
                   "samplers": {"edge": _EDGE, "neg": _NEG}},
}


def _numbered(tree, it=None):
    """The tree with its leaves numbered in sorted-key order."""
    it = iter(range(10**6)) if it is None else it
    return {k: (_numbered(v, it) if isinstance(v, dict) else next(it))
            for k, v in sorted(tree.items())}


@pytest.mark.parametrize("name", sorted(TREES))
def test_codec_is_jax_proto_bytewise(name):
    tree = _numbered(TREES[name])
    leaves, proto = treedef.flatten(tree)
    jdef = jax.tree_util.tree_structure(tree)
    assert proto == jdef.serialize_using_proto()
    assert leaves == jax.tree_util.tree_leaves(tree)
    # JAX reads the port's bytes, the port reads JAX's
    back = type(jdef).deserialize_using_proto(jax.tree_util.default_registry,
                                              proto)
    assert back == jdef
    assert treedef.unflatten(jdef.serialize_using_proto(), leaves) == tree


@pytest.mark.parametrize("tree", [[1, 2], (1,), None, 3, {1: 0},
                                  {"a": [0]}, {"a": None}, {"a": (0, 1)}],
                         ids=["list", "tuple", "none", "leaf", "int_key",
                              "list_leaf", "none_leaf", "tuple_leaf"])
def test_codec_refuses_non_dict_trees(tree):
    with pytest.raises(TypeError):
        treedef.flatten(tree)


@pytest.mark.parametrize("tree", [[0, 1], (0,), {"a": [0, 1]}],
                         ids=["list", "tuple", "dict_of_list"])
def test_codec_refuses_jax_non_dict_bytes(tree):
    proto = jax.tree_util.tree_structure(tree).serialize_using_proto()
    with pytest.raises(ValueError):
        treedef.unflatten(proto, jax.tree_util.tree_leaves(tree))


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(64, 32))
                                  .astype(np.float32)),
            "nested": {"b": np.arange(17, dtype=np.int32),
                       "scale": np.float32(3.5),
                       "rng": torch.from_numpy(rng.integers(
                           0, 256, 16).astype(np.uint8))},
            "stack": rng.normal(size=(4, 8, 8))}


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    a, b = ck.to_host(a), ck.to_host(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_save_restore_bitwise(tmp_path):
    t = _tree()
    ck.save(tmp_path, 10, t)
    got, step = ck.restore(tmp_path)
    assert step == 10 and _equal(t, got)
    assert isinstance(got["w"], np.ndarray)


def test_uncommitted_checkpoint_ignored(tmp_path):
    ck.save(tmp_path, 1, _tree(1))
    ck.save(tmp_path, 2, _tree(2))
    (tmp_path / "step_2" / "_COMMITTED").unlink()
    assert ck.all_steps(tmp_path) == [1]
    got, step = ck.restore(tmp_path)
    assert step == 1 and _equal(got, _tree(1))
    with pytest.raises(FileNotFoundError):
        ck.restore(tmp_path, 2)


def test_crc_corruption_falls_back_and_explicit_step_raises(tmp_path):
    ck.save(tmp_path, 1, _tree(1))
    ck.save(tmp_path, 2, _tree(2))
    shard = tmp_path / "step_2" / "shard_0.npz"
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    with pytest.warns(RuntimeWarning, match="corrupt"):
        got, step = ck.restore(tmp_path)
    assert step == 1 and _equal(got, _tree(1))
    with pytest.raises(ck.CheckpointCorruptError, match="CRC"):
        ck.restore(tmp_path, 2)


def test_schema_mismatch_and_rotation(tmp_path):
    for s in range(1, 8):
        ck.save(tmp_path, s, _tree(s), keep=3, schema="largevis-stage-x")
    assert ck.all_steps(tmp_path) == [5, 6, 7]
    got, step = ck.restore(tmp_path, expect_schema="largevis-stage-x")
    assert step == 7 and _equal(got, _tree(7))
    with pytest.raises(ValueError, match="schema"):
        ck.restore(tmp_path, expect_schema="largevis-stage-y")


def test_newer_format_refused(tmp_path):
    ck.save(tmp_path, 1, _tree())
    meta_p = tmp_path / "step_1" / "meta.json"
    meta = json.loads(meta_p.read_text())
    meta["version"] = ck.FORMAT_VERSION + 1
    meta_p.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="newer"):
        ck.restore(tmp_path, 1)


def test_validate_rejects_into_the_fallback_walk(tmp_path):
    ck.save(tmp_path, 1, _tree(1), extra_meta={"ok": True})
    ck.save(tmp_path, 2, _tree(2), extra_meta={"ok": False})

    def validate(meta):
        if not meta["extra"]["ok"]:
            raise ValueError("not ok")

    with pytest.warns(RuntimeWarning, match="incompatible"):
        _, step = ck.restore(tmp_path, validate=validate)
    assert step == 1
    with pytest.raises(ck.CheckpointIncompatibleError):
        ck.restore(tmp_path, 2, validate=validate)


def test_jax_written_directory_restores_in_the_port(tmp_path):
    t = {"a": jnp.arange(12.0).reshape(3, 4),
         "b": {"c": jnp.asarray([1, 2, 3], jnp.int32),
               "d": jax.random.key_data(jax.random.key(5))}}
    jck.save(tmp_path, 3, t, schema="largevis-stage-graph",
             extra_meta={"fingerprint": "x"})
    got, step, meta = ck.restore(
        tmp_path, expect_schema="largevis-stage-graph", return_meta=True)
    assert step == 3 and meta["extra"] == {"fingerprint": "x"}
    assert _equal(jax.tree.map(np.asarray, t), got)


def test_port_written_directory_restores_in_jax(tmp_path):
    t = _tree(4)
    ck.save(tmp_path, 5, t, schema="largevis-stage-layout",
            extra_meta={"rollbacks": 1})
    got, step, meta = jck.restore(
        tmp_path, expect_schema="largevis-stage-layout", return_meta=True)
    assert step == 5 and meta["extra"] == {"rollbacks": 1}
    assert _equal(t, jax.tree.map(np.asarray, got))


# ---------------------------------------------------------------------------
# fitted models, both ways
# ---------------------------------------------------------------------------

def _x():
    return np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_result():
    with warnings.catch_warnings():
        # JAX 0.9 removed jax.experimental.enable_x64: its device alias
        # tables demote to the host build with a DegradedModeWarning
        warnings.simplefilter("ignore")
        return jax_largevis(jnp.asarray(_x()), jax.random.key(1),
                            cfg=JaxConfig(**SMALL))


@pytest.fixture(scope="module")
def port_result():
    return largevis(_x(), cfg=LargeVisConfig(**SMALL), device="cpu")


_SHARED = ("y", "knn_idx", "knn_dist", "weights", "x")


def _same_model(a, b):
    for f in _SHARED:
        assert _equal(np.asarray(getattr(a, f)), ck.to_host(getattr(b, f))), f
    for s in ("edge_sampler", "neg_sampler"):
        sa, sb = getattr(a, s), getattr(b, s)
        for f in ("threshold", "alias") + (("src", "dst")
                                           if s == "edge_sampler" else ()):
            assert _equal(np.asarray(getattr(sa, f)),
                          ck.to_host(getattr(sb, f))), (s, f)
    assert a.edge_sampler.n_edges == b.edge_sampler.n_edges
    assert a.neg_sampler.n_nodes == b.neg_sampler.n_nodes
    assert a.edge_samples == b.edge_samples
    assert a.timings == pytest.approx(b.timings)


def test_jax_saved_model_loads_in_the_port(tmp_path, jax_result):
    jlvs.save_result(tmp_path / "m", jax_result)
    model = repro_torch.LargeVis.load(tmp_path / "m", device="cpu")
    r = model.result_
    _same_model(jax_result, r)
    assert r.y.device.type == "cpu" and model.device == torch.device("cpu")
    # every config field the port has holds the JAX fit's value
    jd = jlvs.cfg_to_dict(jax_result.cfg)
    for k, v in lvs.cfg_to_dict(r.cfg).items():
        assert v == jd[k], k
    # the carried model still answers transform
    y_new = model.transform(_x()[:5] + 0.01)
    assert y_new.shape == (5, 2) and bool(torch.isfinite(y_new).all())


def test_port_saved_model_loads_in_jax(tmp_path, port_result):
    m = repro_torch.LargeVis(cfg=port_result.cfg, device="cpu")
    m.result_ = port_result
    m.save(tmp_path / "m")
    r = jlvs.load_result(tmp_path / "m")
    _same_model(r, port_result)
    assert r.key is None
    pd = lvs.cfg_to_dict(port_result.cfg)
    for k, v in jlvs.cfg_to_dict(r.cfg).items():
        assert v == pd[k], k


def test_port_save_load_roundtrip_bitwise(tmp_path, port_result):
    m = repro_torch.LargeVis(device="cpu")
    m.result_ = port_result
    m.save(tmp_path / "m")
    back = repro_torch.LargeVis.load(tmp_path / "m", device="cpu")
    _same_model(back.result_, port_result)
    assert back.cfg == port_result.cfg
    if not torch.cuda.is_available():      # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            repro_torch.LargeVis.load(tmp_path / "m")


def test_result_schema_is_checked(tmp_path):
    ck.save(tmp_path / "m", 0, {"y": np.zeros((2, 2), np.float32)},
            schema="largevis-stage-layout")
    with pytest.raises(ValueError, match="schema"):
        repro_torch.LargeVis.load(tmp_path / "m", device="cpu")


@pytest.mark.parametrize("with_robustness", [False, True])
def test_cfg_to_dict_matches_jax(with_robustness):
    kw = dict(SMALL, seed=3, rho0=0.7)
    cfg = LargeVisConfig(**kw)
    jcfg = JaxConfig(**kw)
    if with_robustness:
        cfg = dataclasses.replace(
            cfg, checkpoint=CheckpointConfig("d", every_chunks=3),
            health=HealthConfig(max_abs=10.0))
        jcfg = dataclasses.replace(
            jcfg, checkpoint=JaxCkpt("d", every_chunks=3),
            health=JaxHealth(max_abs=10.0))
    d, jd = lvs.cfg_to_dict(cfg), jlvs.cfg_to_dict(jcfg)
    assert set(d) == set(jd)            # the JAX aliases are dropped there
    assert d == jd
    assert lvs.cfg_from_dict(jd) == cfg
    assert jlvs.cfg_from_dict(d) == jcfg
    # the fingerprint's cfg part leaves out checkpoint and topology
    g = torch.Generator().manual_seed(0)
    moved = dataclasses.replace(cfg, checkpoint=CheckpointConfig("e"),
                                data_shards=4)
    assert lvs.run_fingerprint(None, g, moved) == lvs.run_fingerprint(
        None, g, cfg)
    assert lvs.run_fingerprint(None, g, dataclasses.replace(
        cfg, rho0=0.5)) != lvs.run_fingerprint(None, g, cfg)


def test_fingerprint_binds_data_and_generator_state():
    cfg = LargeVisConfig(**SMALL)
    x = torch.from_numpy(_x())
    g0, g1 = (torch.Generator().manual_seed(s) for s in (0, 1))
    fp = lvs.run_fingerprint(x, g0, cfg)
    assert fp == lvs.run_fingerprint(x.clone(), torch.Generator()
                                     .manual_seed(0), cfg)
    assert fp != lvs.run_fingerprint(x, g1, cfg)
    x2 = x.clone()
    x2[0, 0] += 1.0                    # row 0 is in the strided sample
    assert fp != lvs.run_fingerprint(x2, g0, cfg)
    # a numpy array and a tensor of the same data fingerprint alike
    assert fp == lvs.run_fingerprint(_x(), g0, cfg)


def test_async_writer_commits_in_order_and_reraises(tmp_path):
    from repro_torch.runtime.fault_tolerance import Watchdog
    ckpt = lvs.StageCheckpointer(CheckpointConfig(str(tmp_path)), "fp")
    dog = Watchdog()
    w = lvs.AsyncStageWriter(ckpt, watchdog=dog)
    y = torch.zeros(8, 2)
    for s in range(1, 6):
        y += 1.0                       # the snapshot, not the live buffer
        w.submit("layout", {"y": y, "rng": torch.arange(4,
                                                        dtype=torch.uint8)},
                 step=s, keep=2, extra={"rollbacks": 0})
    w.close()
    assert ck.all_steps(tmp_path / "layout") == [4, 5]
    tree, step, extra = ckpt.load("layout")
    assert step == 5 and float(tree["y"][0, 0]) == 5.0
    assert extra == {"fingerprint": "fp", "rollbacks": 0}
    tree, _ = ck.restore(tmp_path / "layout", 4)
    assert float(tree["y"][0, 0]) == 4.0
    w2 = lvs.AsyncStageWriter(ckpt)
    w2.submit("layout", {"y": y, "bad": [1]}, step=9)   # the codec refuses
    with pytest.raises(TypeError):
        w2.close()
