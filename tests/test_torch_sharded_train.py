"""The port's sharded trainer against one device and the JAX package, on
the CPU over gloo.

``optim/grad_compress.py``: ``q`` and ``scale`` bit for bit JAX's when fed
JAX's uniform draws, ``compression_ratio`` JAX's, and JAX's own bounds
(``tests/test_checkpoint.py::test_grad_compression_bounds_and_ef``) on the
port's draws.  ``runtime/sharding.py``: ``param_pspec``,
``params_shardings`` and ``batch_shardings`` JAX's for all ten
architectures at full size (shapes only: JAX's ``param_specs`` carried
into the port's layout on the meta device) on ``(data, model)`` meshes of
(1, 1), (2, 1), (4, 1) and (2, 2), training and not.

One world of two gloo processes (``tests/torch_dist_ranks.py``) runs the
rest, and the world of one runs in this process:

- two ``make_train_step`` steps of a reduced qwen and a reduced mixtral
  (MoE, each rank's capacity from its own tokens) at one microbatch a rank
  give the bits of one device's steps at two microbatches: the losses, the
  parameters, the moments gathered; each rank's moments are its blocks of
  them.  At two microbatches a rank they are held to one device at four
  within ``test_torch_train.py::test_train_step_matches_jax``'s
  tolerances (the sums associate differently), and the first step's loss
  and parameters to JAX's ``make_train_step`` at two microbatches the
  same way;
- ``restore(shardings=)``: the ranks' blocks concatenate to the saved
  arrays (JAX's ``test_elastic_restore_new_sharding``);
- ``train(production=True)`` across worlds (JAX's
  ``test_restart_bit_identical``): a world-1 save resumed at world 2 and a
  world-2 save resumed at world 1 give the uninterrupted run's losses; the
  world-2 save is the world-1 save's file, leaf for leaf, read by the JAX
  package's ``restore``;
- ``make_host_mesh`` clamps ``data`` and then ``model`` to the world as
  JAX's clamps them to the devices, in JAX's row-major rank layout;
- a SIGTERM to one rank: both ranks save the step reached once and exit
  by the signal.

Tolerances (f32): losses within 1e-5 relative; moments within 1e-4 of each
leaf's largest magnitude; parameters within 1e-6 of their largest
magnitude plus twice the step's lr.
"""
import contextlib
import signal
import subprocess
import sys
import threading
import types
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.checkpoint import checkpointer as jck
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import input_specs
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.launch.steps import pick_microbatches as jpick
from repro.models import param_specs
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.runtime import sharding as jsh
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy,
                                 train_state_to_numpy)
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_data_mesh, make_host_mesh
from repro_torch.launch.steps import make_train_step, pick_microbatches
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim.adamw import AdamWConfig, _schedule, adamw_init
from repro_torch.runtime import sharding as tsh
from torch_dist_ranks import HOST_MESH_ASKS, run_world
from torch_lm_parity import cfgs, params, tokens

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["qwen1.5-0.5b", "mixtral-8x7b"]
B, S = 4, 16
MESHES = [(1, 1), (2, 1), (4, 1), (2, 2)]
# train(production=True): STEPS uninterrupted; a save at SAVE_EVERY, the
# run cut at CUT and resumed to STEPS
STEPS, SAVE_EVERY, CUT = 4, 2, 3
TRAIN = dict(arch="qwen1.5-0.5b", batch=4, seq=16, save_every=SAVE_EVERY,
             opt_cfg=AdamWConfig(lr=1e-2, warmup_steps=1))


@contextlib.contextmanager
def world_of_one():
    """A world of one made by ``make_data_mesh`` in this process, taken
    down after (other tests of this worker make their own)."""
    was = dist.is_initialized()
    try:
        yield
    finally:
        if not was and dist.is_initialized():
            dist.destroy_process_group()


def _tree(got, prefix):
    """The nested dict under ``prefix`` of a rank's flat result."""
    out = {}
    for k, v in got.items():
        if k.startswith(prefix + "/"):
            node = out
            *up, leaf = k[len(prefix) + 1:].split("/")
            for u in up:
                node = node.setdefault(u, {})
            node[leaf] = v
    return out


def _bitwise(got, want, where=()):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _bitwise(got[k], want[k], where + (k,))
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, where
    assert got.tobytes() == want.tobytes(), where


def _close(got, want, tol, where=()):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _close(got[k], want[k], tol, where + (k,))
        return
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, where
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) / scale < tol, where


def _params_close(got, want, lr):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-6 * float(np.abs(b).max()) + 2 * lr),
        got, want)


def _scaled_routers(t):
    if isinstance(t, dict):
        return {k: (v * np.float32(100) if k == "router" else
                    _scaled_routers(v)) for k, v in t.items()}
    return t


# ---------------------------------------------------------------------------
# the compressor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1000,), (64, 64), (2049,), ()])
def test_quantize_leaf_matches_jax_on_its_noise(shape):
    key = jax.random.key(11)
    g = np.asarray(jax.random.normal(key, shape)) * np.float32(7.0)
    k = jax.random.fold_in(key, 1)
    jq, js = jgc._quantize_leaf(jnp.asarray(g), k)
    blocks = -(-max(g.size, 1) // jgc.BLOCK)
    u = np.asarray(jax.random.uniform(k, (blocks, jgc.BLOCK)))
    tq, ts = tgc._quantize_leaf(torch.from_numpy(np.array(g)),
                                torch.from_numpy(np.array(u)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    jd = np.asarray(jgc._dequantize_leaf(jq, js, shape))
    td = tgc._dequantize_leaf(tq, ts, shape).numpy()
    assert td.shape == shape
    np.testing.assert_array_equal(td.view(np.uint32), jd.view(np.uint32))


def test_compression_ratio_matches_jax():
    shapes = {"a": (1000,), "b": (64, 64), "c": (2049,), "d": ()}
    want = jgc.compression_ratio({k: jnp.zeros(s) for k, s in
                                  shapes.items()})
    assert tgc.compression_ratio({k: torch.zeros(s) for k, s in
                                  shapes.items()}) == want
    assert tgc.BLOCK == jgc.BLOCK


def test_compression_bounds_and_ef():
    """JAX's bounds on the port's draws: each leaf's error within one
    quantization unit of its largest magnitude, the ratio under 0.27, and
    the mean of 20 error-fed rounds within one unit of the gradient."""
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.standard_normal(1000).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal((64, 64))
                               .astype(np.float32) * 10)}
    gen = torch.Generator().manual_seed(0)
    deq = tgc.decompress(tgc.compress(g, gen), g)
    for k in g:
        scale = float(g[k].abs().max())
        assert float((g[k] - deq[k]).abs().max()) <= scale / 127.0 + 1e-6
    assert tgc.compression_ratio(g) < 0.27
    ef, acc = None, {k: torch.zeros_like(v) for k, v in g.items()}
    for _ in range(20):
        deq, ef = tgc.compressed_grads_with_ef(g, ef, gen)
        acc = {k: acc[k] + deq[k] for k in acc}
    for k in g:
        drift = float((acc[k] / 20.0 - g[k]).abs().max())
        assert drift <= float(g[k].abs().max()) / 127.0 + 1e-5, drift


# ---------------------------------------------------------------------------
# the partition rules
# ---------------------------------------------------------------------------

def _jax_paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jax_paths(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_match_jax(name):
    """Every leaf of the full-size architecture: the port's
    ``param_pspec`` on JAX's stacked leaf is JAX's, and
    ``params_shardings`` over the port's module tree names each layer by
    its JAX path and gives JAX's spec without the leading None."""
    jcfg, tcfg = jget_config(name), get_config(name)
    jspecs = param_specs(jcfg)
    meta = lm_params_from_numpy(jax.tree.map(
        lambda s: torch.empty(s.shape, device="meta"), jspecs), tcfg,
        "meta")
    leaves = _jax_paths(jspecs)
    period = len(tcfg.block_pattern)
    for shape in MESHES:
        amesh = AbstractMesh(shape, ("data", "model"))
        sizes = dict(amesh.shape)
        for train in (True, False):
            want = _jax_paths(jsh.params_shardings(jspecs, amesh,
                                                   train=train))
            for path, leaf in leaves.items():
                stacked = "blocks/" in path or "_layers/" in path
                got = tsh.param_pspec(path, leaf.shape, sizes, train=train,
                                      stacked=stacked)
                assert got == tuple(want[path].spec), (path, shape, train)
            specs = tsh.params_shardings(meta, tcfg, sizes, train=train)
            assert list(specs) == [n for n, _ in meta.named_parameters()]
            for pname, p in meta.named_parameters():
                path, stacked = tsh.jax_path(pname, period)
                jspec = tuple(want[path].spec)
                assert tuple(leaves[path].shape)[int(stacked):] == \
                    tuple(p.shape), pname
                assert specs[pname] == (jspec[1:] if stacked else jspec), \
                    (pname, shape, train)


def test_batch_specs_match_jax():
    """Tokens, labels and encoder frames at batches that cover the DP axes
    and batches that do not; a decode cache raises."""
    for name in ("qwen1.5-0.5b", "whisper-tiny"):
        jcfg = jget_config(name)
        for gb in (1, 2, 3, 4, 8):
            specs = input_specs(jcfg, JShapeConfig("c", "train", 64, gb))
            for shape in MESHES:
                amesh = AbstractMesh(shape, ("data", "model"))
                want = jsh.batch_shardings(specs, amesh, global_batch=gb)
                got = tsh.batch_shardings(specs, dict(amesh.shape),
                                          global_batch=gb)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k] == tuple(want[k].spec), (name, gb, shape)
    # a decode cache's leaves take JAX's cache layout
    leaf = jax.ShapeDtypeStruct((2, 2, 8, 4, 16), jnp.float32)
    for gb in (1, 2):
        for shape in MESHES:
            amesh = AbstractMesh(shape, ("data", "model"))
            want = jsh.batch_shardings({"cache": {"pos0": {"k": leaf}}},
                                       amesh, global_batch=gb)
            got = tsh.batch_shardings(
                {"cache": {"pos0": {"k": torch.empty(leaf.shape)}}},
                dict(amesh.shape), global_batch=gb)
            assert got["cache"]["pos0"]["k"] == \
                tuple(want["cache"]["pos0"]["k"].spec), (gb, shape)


def test_pick_microbatches_with_a_mesh_matches_jax():
    for P in (1, 2, 4):
        amesh = AbstractMesh((P, 1), ("data", "model"))
        mesh = types.SimpleNamespace(size=P)
        for seq, gb in ((4096, 4), (128, 8), (4096, 6), (2048, 256),
                        (4096, 1)):
            assert pick_microbatches(ShapeConfig("c", "train", seq, gb),
                                     mesh=mesh) == \
                jpick(amesh, JShapeConfig("c", "train", seq, gb))


# ---------------------------------------------------------------------------
# world 1 (one device, and a world of one here) and world 2 (spawned)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    """JAX's reduced weights (MoE routers scaled by 100, as
    ``test_torch_train.py`` holds the MoE gradients) and two batches."""
    out = {}
    for name in ARCHS:
        jcfg, tcfg = cfgs(name, total_routing=False)
        jp, _ = params(jcfg, tcfg, seed=5)
        out[name] = (jcfg, tcfg,
                     _scaled_routers(jax.tree.map(np.asarray, jp)))
    batches = [tokens(B, S + 1, 512, seed=20 + i) for i in range(2)]
    return out, batches


def _one_device(tcfg, jp, batches, micro):
    """Two one-device steps at ``micro`` microbatches: the loss and the
    train state (JAX layout) after each."""
    p = lm_params_from_numpy(jp, tcfg, "cpu")
    st = adamw_init(p)
    step = make_train_step(tcfg, ShapeConfig("c", "train", S, B),
                           microbatches=micro)
    out = []
    for toks in batches:
        t = torch.from_numpy(toks)
        p, st, loss = step(p, st, {"tokens": t[:, :-1], "labels": t[:, 1:]})
        out.append((float(loss), train_state_to_numpy(p, st, tcfg)))
    return out


def _train(**kw):
    return ttrain.train(**TRAIN, device="cpu", log_every=10**6, **kw)


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    """The world-2 ranks' results, beside what world 1 gives: one device
    at 2 and 4 microbatches; the uninterrupted run; a world-1 save at
    ``SAVE_EVERY`` (cut at ``CUT``) for world 2 to resume, and world 2's
    save resumed at world 1 after."""
    weights, batches = setup
    tmp = tmp_path_factory.mktemp("sharded_train")
    one = {(name, m): _one_device(tcfg, jp, batches, m)
           for name, (_, tcfg, jp) in weights.items() for m in (2, 4)}
    ref = dict(_train(steps=STEPS, resume=False, microbatches=2,
                      ckpt_dir=str(tmp / "ref"))[2])
    with world_of_one():
        _train(steps=CUT, resume=False, microbatches=2, production=True,
               ckpt_dir=str(tmp / "world1"))
    rng = np.random.default_rng(3)
    payload = {
        "params": {name: jp for name, (_, _, jp) in weights.items()},
        "batches": batches, "ckpt": tmp, "steps": STEPS, "cut": CUT,
        "train": dict(TRAIN, microbatches=1),
        "tree": {"w": rng.standard_normal((64, 32)).astype(np.float32),
                 "nested": {"b": np.arange(17, dtype=np.int32),
                            "scale": np.float32(3.5)},
                 "stack": rng.standard_normal((4, 8, 8))
                 .astype(np.float32)}}
    ranks = run_world("sharded_train_world", 2, tmp, payload)
    with world_of_one():
        _, _, resumed1 = _train(steps=STEPS, microbatches=2,
                                production=True,
                                ckpt_dir=str(tmp / "world2"))
    return {"one": one, "ranks": ranks, "ref": ref, "tmp": tmp,
            "payload": payload, "resumed1": dict(resumed1)}


@pytest.mark.parametrize("name", ARCHS)
def test_world2_one_microbatch_is_world1_bitwise(world2, name):
    """Each rank's losses, parameters and gathered moments after each of
    two steps: the bits of one device's steps at two microbatches."""
    for rank in world2["ranks"]:
        for i, (loss, state) in enumerate(world2["one"][(name, 2)]):
            assert float(rank[f"{name}/m1/loss{i}"]) == loss, (i, loss)
            _bitwise(_tree(rank, f"{name}/m1/state{i}"), state)


@pytest.mark.parametrize("name", ARCHS)
def test_world2_two_microbatches_within_tolerance(world2, name):
    """Two microbatches a rank against one device at four: the sums
    associate differently, so within the module's tolerances."""
    lr = float(_schedule(AdamWConfig(), torch.tensor(2)))
    for rank in world2["ranks"]:
        for i, (loss, state) in enumerate(world2["one"][(name, 4)]):
            np.testing.assert_allclose(float(rank[f"{name}/m2/loss{i}"]),
                                       loss, rtol=1e-5)
            got = _tree(rank, f"{name}/m2/state{i}")
            _params_close(got["params"], state["params"], lr)
            _close(got["opt"]["m"], state["opt"]["m"], 1e-4)


def test_ranks_hold_the_same_parameters(world2):
    r0, r1 = world2["ranks"]
    for name in ARCHS:
        for m in (1, 2):
            _bitwise(_tree(r0, f"{name}/m{m}/final"),
                     _tree(r1, f"{name}/m{m}/final"))


@pytest.mark.parametrize("name", ARCHS)
def test_rank_moments_are_its_blocks(world2, name):
    """A rank's ``m`` holds its block along each leaf's FSDP dimension
    (JAX's spec at (2, 1)), half the leaf where it shards; the blocks of
    the two ranks are the gathered moments' halves."""
    tcfg = get_config(name + "-reduced")
    sizes = {"data": 2, "model": 1}
    owns = [_tree(r, f"{name}/m1/own_m1") for r in world2["ranks"]]
    whole = _tree(world2["ranks"][0], f"{name}/m1/state1")["opt"]["m"]
    sharded = 0
    for path, leaf in _jax_paths(whole).items():
        stacked = "blocks/" in path or "_layers/" in path
        spec = tsh.param_pspec(path, leaf.shape, sizes, train=True,
                               stacked=stacked)
        d = tsh.data_dim(spec)
        parts = [_jax_paths(o)[path] for o in owns]
        if d is None:
            for part in parts:
                _bitwise(part, leaf)
            continue
        sharded += 1
        assert parts[0].shape[d] * 2 == leaf.shape[d], path
        _bitwise(np.concatenate(parts, axis=d), leaf)
    assert sharded > len(_jax_paths(whole)) // 2
    assert tcfg.d_model % 2 == 0


@pytest.mark.parametrize("name", ARCHS)
def test_world2_step_matches_jax(world2, setup, name):
    """World 2's first step (one microbatch a rank) against JAX's
    ``make_train_step`` at two microbatches on the same batch from the same
    weights, its activation policy patched off as in
    ``test_torch_train.py::test_train_step_matches_jax``: the loss and the
    parameters within that test's tolerances.  (The moments are held
    bitwise to the port's one-device step above; against JAX, the reduced
    mixtral's one-device moments on these weights fall just outside the
    1e-4 of ``test_train_step_matches_jax``: MoE routing near a tie,
    ROADMAP Queue 3.)"""
    weights, batches = setup
    jcfg, _, jp = weights[name]
    jstep, *_ = jmake_train_step(jcfg, jmake_host_mesh(),
                                 JShapeConfig("c", "train", S, B),
                                 microbatches=2)
    toks = batches[0]
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    jparams = jax.tree.map(jnp.asarray, jp)
    with mock.patch.object(jsh, "activation_policy",
                           lambda *a, **kw: contextlib.nullcontext()):
        jparams, jstate, jloss = jax.jit(jstep)(
            jparams, jadamw.adamw_init(jparams), jb)
    lr = float(_schedule(AdamWConfig(), torch.tensor(1)))
    for rank in world2["ranks"]:
        np.testing.assert_allclose(float(rank[f"{name}/m1/loss0"]),
                                   float(jloss), rtol=1e-5)
        got = _tree(rank, f"{name}/m1/state0")
        _params_close(got["params"], jax.tree.map(np.asarray, jparams), lr)


def test_restore_shardings_gives_each_rank_its_block(world2, tmp_path):
    """World 2: the ranks' blocks along ``"data"`` concatenate to the saved
    arrays, unsharded leaves come back whole; a world of one here gets
    every leaf whole (JAX's ``test_elastic_restore_new_sharding``)."""
    tree = world2["payload"]["tree"]
    r0, r1 = world2["ranks"]
    for k, axis in (("w", 0), ("stack", 1)):
        assert r0[f"restored/{k}"].shape[axis] * 2 == tree[k].shape[axis]
        _bitwise(np.concatenate([r0[f"restored/{k}"], r1[f"restored/{k}"]],
                                axis=axis), tree[k])
    for r in (r0, r1):
        _bitwise(r["restored/nested/b"], tree["nested"]["b"])
        _bitwise(r["restored/nested/scale"], np.asarray(tree["nested"]
                                                        ["scale"]))
    ck.save(tmp_path, 1, tree)
    with world_of_one():
        mesh = make_data_mesh(0, device="cpu")
        sh = {"w": (mesh, ("data", None)),
              "nested": {"b": (mesh, (None,)), "scale": (mesh, ())},
              "stack": (mesh, (None, None, None))}
        got, step = ck.restore(tmp_path, shardings=sh)
    assert step == 1 and torch.is_tensor(got["w"])
    _bitwise(got["w"].numpy(), tree["w"])
    _bitwise(got["stack"].numpy(), tree["stack"])
    with pytest.raises(ValueError, match="shardings"):
        ck.restore(tmp_path, shardings={"w": sh["w"]})


def test_production_resumes_across_worlds(world2):
    """``train(production=True)``: a world-1 save (cut at ``CUT``) resumed
    at world 2, and a world-2 save resumed at world 1, give the
    uninterrupted run's losses bitwise from the save on; the world-2
    fresh run gives them before the cut."""
    ref = world2["ref"]
    after = list(range(SAVE_EVERY, STEPS))
    for rank in world2["ranks"]:
        resumed = {int(s): x for s, x in rank["resumed_losses"]}
        assert sorted(resumed) == after
        assert all(resumed[s] == ref[s] for s in after), (resumed, ref)
        fresh = {int(s): x for s, x in rank["fresh_losses"]}
        assert sorted(fresh) == list(range(CUT))
        assert all(fresh[s] == ref[s] for s in fresh), (fresh, ref)
    assert sorted(world2["resumed1"]) == after
    assert all(world2["resumed1"][s] == ref[s] for s in after)


def test_world2_checkpoint_is_world1s_file_in_jax(world2):
    """The JAX package's ``restore`` reads the world-2 save into whole
    leaves of JAX's train state, bit for bit the world-1 save of the same
    step."""
    tmp = world2["tmp"]
    got, step = jck.restore(str(tmp / "world2"), SAVE_EVERY)
    want, _ = jck.restore(str(tmp / "world1"), SAVE_EVERY)
    assert step == SAVE_EVERY
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert sorted(got) == ["opt", "params"]
    jax.tree.map(lambda a, b: _bitwise(np.asarray(a), np.asarray(b)),
                 got, want)
    tcfg = get_config("qwen1.5-0.5b-reduced")
    whole = lm_params_to_numpy(lm_params_from_numpy(
        jax.tree.map(np.asarray, got["opt"]["m"]), tcfg, "cpu"), tcfg)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a).shape, np.asarray(b).shape), whole,
        jax.tree.map(np.asarray, got["params"]))


def test_make_host_mesh_clamps_as_jax_and_refuses_tp(world2):
    """JAX clamps ``data`` to the devices, then ``model`` to ``devices //
    data``; the port clamps to the world (1 here, 2 in the spawned world),
    and mesh rank r is JAX's device (r // M, r % M), row-major."""
    from repro.launch import mesh as jmesh
    for n, ranks in ((1, None), (2, world2["ranks"])):
        with mock.patch.object(jmesh.jax, "devices", lambda: [None] * n), \
                mock.patch.object(jmesh, "make_mesh",
                                  lambda shape, axes: dict(zip(axes, shape))):
            want = {ask: jmesh.make_host_mesh(*ask)
                    for ask in HOST_MESH_ASKS}
        if ranks is None:
            with world_of_one():
                for ask, w in want.items():
                    assert make_host_mesh(*ask, device="cpu").shape == w
            continue
        for r, rank in enumerate(ranks):
            for (data, model), w in want.items():
                D, M, d, m = rank[f"host_mesh_{data}x{model}"].tolist()
                assert {"data": D, "model": M} == w, (data, model)
                if r < D * M:
                    assert (d, m) == (r // M, r % M), (r, data, model)


def test_sigterm_to_one_rank_saves_once_and_both_exit(tmp_path):
    """World 2 over gloo in two processes; rank 1 gets a SIGTERM after
    rank 0 has logged step 2.  The ranks agree at that step's end: rank 0
    writes one checkpoint, at the step reached, and both die by SIGTERM."""
    code = (f"import datetime, sys; sys.path.insert(0, {str(REPO / 'src')!r})"
            "\nimport torch, torch.distributed as dist\n"
            "torch.set_num_threads(2)\n"
            "rank = int(sys.argv[1])\n"
            f"dist.init_process_group('gloo', init_method="
            f"'file://{tmp_path}/store', rank=rank, world_size=2, "
            "timeout=datetime.timedelta(seconds=60))\n"
            "from repro_torch.launch.train import train\n"
            "train('qwen1.5-0.5b', steps=100000, batch=2, seq=16, "
            f"ckpt_dir={str(tmp_path / 'ckpt')!r}, save_every=100000, "
            "log_every=1 if rank == 0 else 10**9, production=True, "
            "device='cpu')\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=subprocess.PIPE, text=True)
             for r in (0, 1)]
    timers = [threading.Timer(120.0, p.kill) for p in procs]
    for t in timers:
        t.start()
    seen, out1 = [], ""
    try:
        for line in procs[0].stdout:
            if line.startswith("step"):
                seen.append(int(line.split()[1]))
                if seen[-1] == 2:
                    procs[1].send_signal(signal.SIGTERM)
        procs[0].wait(timeout=60)
        out1 = procs[1].communicate(timeout=60)[0]
    finally:
        for t in timers:
            t.cancel()
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [-signal.SIGTERM] * 2, out1
    steps = ck.all_steps(tmp_path / "ckpt")
    assert steps == [seen[-1] + 1] and steps[0] >= 3, (steps, seen)
    tree, step = ck.restore(tmp_path / "ckpt")
    assert int(tree["opt"]["step"]) == step
    assert "preemption" in out1
