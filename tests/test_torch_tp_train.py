"""The port's tensor-parallel trainer against one device and the JAX
package, on the CPU over gloo: parameters, gradients and both moments
held as each rank's blocks by JAX's training rules (FSDP over
``"data"``, heads, ff and vocab over ``"model"``), each period's leaves
gathered over ``"data"`` inside the step, the vocab-parallel loss.

One world of four gloo processes for the whole file
(``tests/torch_dist_ranks.py::tp_train_world``) forms (2, 2) and (1, 4)
meshes in turn.  Meanwhile this process computes the references once:
the port at world 1 (no mesh) at two microbatches, and JAX's
``make_train_step`` at two microbatches on one device, its activation
policy patched off as ``tests/test_torch_train.py`` does.  Reduced
qwen (tied table, QKV bias), llama3 (GQA), gemma3 (window, local:global,
QK-norm, embed scale) and mixtral (MoE, routers scaled by 100 as the
other training tests hold MoE) take two steps of batch 4 x 16 on each
mesh, the microbatches a rank set so that each step is two microbatches
in all (one a rank on (2, 2), two on (1, 4), where the reduced configs'
2 kv heads do not divide the model axis and each rank picks its query
heads' kv heads by index); phi3, chameleon and dbrx one step on each.
Reduced jamba (mamba's inner blocks, re-blocked from ``w_in``'s block by
one exchange a layer; attention; the MoE), xlstm (the mLSTM's and
sLSTM's heads) and whisper (heads and ff over "model", with encoder
frames in the batch) take two steps on both meshes too, and a reduced
xLSTM with 2 heads (xlstm-125m's 4 at model 16), whose heads do not
divide model 4 and run whole on every rank, two steps on (1, 4), and so does a
reduced whisper with a vocab of 509, which divides neither model size:
its table stays whole over "model", the loss takes the whole logits and
the table's gradient is not summed over "model" (whisper-tiny's 51,865
on the card).  xlstm's (2, 2) save is resumed at world 1.

Held: the losses and the gathered parameters and moments against world
1; the first step's loss, parameters and both moments against JAX's
(the moments hold the gradients); each rank's
parameter and moment blocks (and, for the three one-step archs, the
blocks as cut) are JAX's training blocks of the gathered leaves; two runs
on (2, 2) bitwise; a (2, 2) save read by JAX's ``restore`` is world 1's
file leaf for leaf; a (2, 2) save resumed at world 1 and a world-1 save
resumed on (2, 2) give the uninterrupted run's next loss, and so does
``train(production=True, mesh_shape=(2, 2))``'s save resumed by
``train()`` at world 1;
``make_step`` trains all ten architectures at model 2;
``owned_blocks`` cuts by each axis's own size and index; the gradient
norm's rows give the same bits however they are split.

Tolerances (f32, ``tests/test_torch_sharded_train.py``'s): losses within
1e-5 relative; moments within 1e-4 of each leaf's largest magnitude;
parameters within 1e-6 of their largest magnitude plus twice the step's
lr (the rank-order sums over ``"model"`` add the heads' and ff slices'
partial products in another order than one device).  jamba's moments
are held within 1e-3, ``tests/test_torch_train.py``'s bound for jamba's
gradients on one device: against JAX the doubling scan multiplies in
another order than ``lax.associative_scan``, and against world 1 the
selective products summed over "model" in rank order move the small
gradients of ``d_skip`` and ``conv_w`` (sums over the tokens that mostly
cancel) by about 1e-4 of their largest.
"""
import contextlib
import types
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint import checkpointer as jck
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import param_specs
from repro.optim import adamw as jadamw
from repro.runtime import sharding as jsh
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import (lm_params_from_numpy, opt_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import DataMesh
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.adamw import AdamWConfig, _schedule, adamw_init
from repro_torch.runtime import sharding as tsh
from torch_dist_ranks import start_world
from torch_lm_parity import cfgs, normal, params, tokens
from torch_threads import few_threads

MAIN = ("qwen1.5-0.5b", "llama3-8b", "gemma3-12b", "mixtral-8x7b")
OTHER = ("phi3-medium-14b", "chameleon-34b", "dbrx-132b")
DECODERS = MAIN + OTHER
# the reduced whisper with a vocab that divides neither model size: its
# table stays whole over "model", the loss takes the whole logits
ODD = "whisper-tiny-odd-vocab"
# query heads that do not divide model 4, whole on every rank (trained on
# (1, 4) only): whisper's 6 and a GQA decoder's 6 over 2 kv heads
WHOLE_HEADS = ("whisper-tiny-6-heads", "llama3-8b-6-heads")
# mLSTM/sLSTM heads that do not divide model 4 (xlstm-125m's 4 at model
# 16), whole on every rank (trained on (1, 4) only)
XLSTM_WHOLE = "xlstm-125m-2-heads"
VARIANTS = {ODD: ("whisper-tiny", {"vocab_size": 509}),
            WHOLE_HEADS[0]: ("whisper-tiny", {"n_heads": 6,
                                              "n_kv_heads": 6}),
            WHOLE_HEADS[1]: ("llama3-8b", {"n_heads": 6, "n_kv_heads": 2}),
            XLSTM_WHOLE: ("xlstm-125m", {"n_heads": 2})}
ON_MODEL_4 = WHOLE_HEADS + (XLSTM_WHOLE,)
RECURRENT = ("jamba-v0.1-52b", "xlstm-125m", "whisper-tiny", ODD)
TWO_STEPS = MAIN + RECURRENT     # two steps, two runs on (2, 2)
ALL = DECODERS + RECURRENT
MOMENT_TOL = {"jamba-v0.1-52b": 1e-3}           # else 1e-4
RESUME_22 = "xlstm-125m"       # its (2, 2) save resumed at world 1
MESHES = [(2, 2), (1, 4)]
B, S, STEPS = 4, 16, 2
RESUME = "qwen1.5-0.5b"        # three world-1 steps; saves after two
# train() on (2, 2) and at world 1: 3 steps, a save after 2
TRAIN = dict(arch="qwen1.5-0.5b", batch=4, seq=16, steps=3, save_every=2,
             opt_cfg=AdamWConfig(lr=1e-2, warmup_steps=1))
# the world's steps take about 60 s on an idle 8-core host, and twice that
# or more beside a parallel run of the whole suite: the hang deadline
WORLD_DEADLINE_S = 360


def _scaled_routers(t):
    if isinstance(t, dict):
        return {k: (v * np.float32(100) if k == "router" else
                    _scaled_routers(v)) for k, v in t.items()}
    return t


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


def _paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _bitwise(got, want):
    got, want = _paths(got), _paths(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _close(got, want, tol):
    got, want = _paths(got), _paths(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        err = float(np.abs(got[k].astype(np.float64) - want[k]).max())
        assert err / scale < tol, (k, err / scale)


def _params_close(got, want, lr):
    got, want = _paths(got), _paths(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=0,
            atol=1e-6 * float(np.abs(want[k]).max()) + 2 * lr, err_msg=k)


def _lr(step: int) -> float:
    return float(_schedule(AdamWConfig(), torch.tensor(step)))


def _tag(name, mesh):
    return f"{name}@{mesh[0]}x{mesh[1]}"


def _batch(toks, frames=None):
    t = torch.from_numpy(toks)
    b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if frames is not None:
        b["encoder_frames"] = torch.from_numpy(frames)
    return b


# ---------------------------------------------------------------------------
# the world, and the references computed here meanwhile
# ---------------------------------------------------------------------------

def _frames(tcfg):
    """The encoder-decoder's frames (the batch's rows), from a seed; None
    for a decoder."""
    if not tcfg.is_encoder_decoder:
        return None
    return normal((B, tcfg.enc_positions, tcfg.d_model), seed=5)


def _cfgs(name):
    """Both packages' reduced configs of ``name`` or of its variant."""
    base, kw = VARIANTS.get(name, (name, {}))
    return cfgs(base, total_routing=False, **kw)


def _batches(vocab):
    """Three batches of tokens below ``vocab``, from seeds."""
    return [tokens(B, S + 1, vocab, seed=40 + i) for i in range(3)]


def _world1(tcfg, jp, batches, steps):
    """The port at world 1 (no mesh), two microbatches a step: the loss
    and the train state (JAX layout) after each step, and the state
    itself after each."""
    p = lm_params_from_numpy(jp, tcfg, "cpu")
    st = adamw_init(p)
    step = tsteps.make_train_step(tcfg, ShapeConfig("c", "train", S, B),
                                  microbatches=2)
    out = []
    for toks in batches[:steps]:
        p, st, loss = step(p, st, _batch(toks, _frames(tcfg)))
        out.append((float(loss), train_state_to_numpy(p, st, tcfg)))
    return out


def _no_policy():
    """JAX's activation policy patched to a null context for the steps
    run under it (its sharding constraints name make_mesh's Explicit
    axes and fail under JAX 0.9), once for all the threads that run
    them: a patch a thread would restore the real policy under another
    thread's step when the two overlap."""
    return mock.patch.object(jsh, "activation_policy",
                             lambda *a, **kw: contextlib.nullcontext())


def _jax_step(jcfg, jp, toks, frames=None):
    """JAX's first step at two microbatches: (loss, parameters, first
    moments, second moments); run under :func:`_no_policy`."""
    jstep, *_ = jmake_train_step(jcfg, jmake_host_mesh(),
                                 JShapeConfig("c", "train", S, B),
                                 microbatches=2)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    if frames is not None:
        jb["encoder_frames"] = jnp.asarray(frames)
    jparams = jax.tree.map(jnp.asarray, jp)
    jparams, jopt, jloss = jax.jit(jstep)(jparams, jadamw.adamw_init(jparams),
                                          jb)
    return (float(jloss),) + tuple(jax.tree.map(np.asarray, t) for t in
                                   (jparams, jopt["m"], jopt["v"]))


@pytest.fixture(scope="module", autouse=True)
def world_started(tmp_path_factory):
    """The world and the references, started in a thread before the
    file's first test, so that the tests that need neither run
    meanwhile."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_world, tmp_path_factory)


@pytest.fixture(scope="module")
def world(world_started):
    return world_started.result()


def _world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    weights, jcfgs, tcfgs, batches_of = {}, {}, {}, {}
    with few_threads(), ThreadPoolExecutor(4) as pool:   # XLA off the GIL
        made = {name: pool.submit(params, *_cfgs(name), seed=10 + i)
                for i, name in enumerate(ALL + ON_MODEL_4)}
        for name in ALL + ON_MODEL_4:
            jcfg, tcfg = _cfgs(name)
            jp, _ = made[name].result()
            weights[name] = _scaled_routers(jax.tree.map(np.asarray, jp))
            jcfgs[name], tcfgs[name] = jcfg, tcfg
            batches_of[name] = _batches(tcfg.vocab_size)
        batches = batches_of[RESUME]
        # the world-1 save that the world resumes on (2, 2)
        w1 = _world1(tcfgs[RESUME], weights[RESUME], batches, 2)
        ck.save(tmp / "world1", 2, w1[-1][1])
    cases = []
    for name in ALL:
        for mesh in MESHES:
            main = name in TWO_STEPS
            saves = {RESUME: ["mesh"], RESUME_22: ["mesh_" + RESUME_22]}
            cases.append({
                "tag": _tag(name, mesh), "name": name, "cfg": tcfgs[name],
                "mesh": mesh, "micro": 2 // mesh[0],
                "steps": STEPS if main else 1,
                "runs": 2 if main and mesh == (2, 2) else 1,
                "batches": batches_of[name],
                "saves": [str(tmp / d) for d in saves.get(name, ())
                          if mesh == (2, 2)]})
    cases += [{"tag": _tag(name, (1, 4)), "name": name, "cfg": tcfgs[name],
               "mesh": (1, 4), "micro": 2, "steps": STEPS, "runs": 1,
               "batches": batches_of[name], "saves": []}
              for name in ON_MODEL_4]
    payload = {"cases": cases, "weights": weights, "batches": batches,
               "B": B, "S": S, "frames": _frames(tcfgs["whisper-tiny"]),
               "resume": {"cfg": tcfgs[RESUME], "dir": str(tmp / "world1"),
                          "step": 2},
               "train": dict(TRAIN, resume=False, microbatches=1,
                             ckpt_dir=str(tmp / "train22"))}
    wait = start_world("tp_train_world", 4, tmp, payload,
                       deadline_s=WORLD_DEADLINE_S)
    with few_threads(), _no_policy(), \
            ThreadPoolExecutor(4) as pool:            # XLA off the GIL
        jax_runs = {n: pool.submit(_jax_step, jcfgs[n], weights[n],
                                   batches_of[n][0], _frames(tcfgs[n]))
                    for n in TWO_STEPS + ON_MODEL_4}
        one = {n: _world1(tcfgs[n], weights[n], batches_of[n],
                          3 if n in (RESUME, RESUME_22) else
                          STEPS if n in TWO_STEPS + ON_MODEL_4 else 1)
               for n in ALL + ON_MODEL_4}
        jax_ref = {n: r.result() for n, r in jax_runs.items()}
    ranks = wait()
    return {"ranks": ranks, "one": one, "jax": jax_ref, "tmp": tmp,
            "weights": weights, "cfgs": tcfgs, "jcfgs": jcfgs,
            "batches": batches}


# ---------------------------------------------------------------------------
# the steps against world 1 and JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", TWO_STEPS)
def test_tp_steps_match_world1(world, name, mesh):
    """Every rank's losses, and the state gathered whole after each of
    two steps, against world 1 at two microbatches."""
    tag = _tag(name, mesh)
    for rank in world["ranks"]:
        for i, (loss, state) in enumerate(world["one"][name]):
            if i >= STEPS:
                break
            np.testing.assert_allclose(float(rank[f"{tag}/run0/loss{i}"]),
                                       loss, rtol=1e-5)
            got = _tree(rank, f"{tag}/run0/state{i}")
            _params_close(got["params"], state["params"], _lr(i + 1))
            tol = MOMENT_TOL.get(name, 1e-4)
            _close(got["opt"]["m"], state["opt"]["m"], tol)
            _close(got["opt"]["v"], state["opt"]["v"], tol)
            assert int(got["opt"]["step"]) == i + 1


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", TWO_STEPS)
def test_tp_first_step_matches_jax(world, name, mesh):
    """The first step's loss, parameters and both moments against JAX's
    ``make_train_step`` at two microbatches from the same weights.  After
    one step m is (1 - b1) times the clipped gradient and v (1 - b2)
    times its square, so the moments hold the backward itself (the
    vocab-parallel loss's, ``model_copy``'s, the reduce-scatters', the
    norm's) to JAX's."""
    jloss, jparams, jm, jv = world["jax"][name]
    for rank in world["ranks"]:
        np.testing.assert_allclose(
            float(rank[f"{_tag(name, mesh)}/run0/loss0"]), jloss, rtol=1e-5)
        got = _tree(rank, f"{_tag(name, mesh)}/run0/state0")
        _params_close(got["params"], jparams, _lr(1))
        tol = MOMENT_TOL.get(name, 1e-4)
        _close(got["opt"]["m"], jm, tol)
        _close(got["opt"]["v"], jv, tol)


@pytest.mark.parametrize("name", WHOLE_HEADS)
def test_whole_heads_train_on_model_4(world, name):
    """Query heads that do not divide model 4 (whisper's 6, a GQA
    decoder's 6 over 2 kv heads), whole on every rank: the attention runs
    replicated, so its weights' gradients are whole on every rank and not
    summed over "model", beside the ff-sharded MLP.  Two steps on (1, 4)
    against world 1, and the first against JAX's ``make_train_step``,
    within the tolerances of the other architectures (moments 1e-4); each
    rank's ``wq`` and its first moment whole."""
    tag = _tag(name, (1, 4))
    jloss, jparams, jm, jv = world["jax"][name]
    for rank in world["ranks"]:
        for i, (loss, state) in enumerate(world["one"][name]):
            np.testing.assert_allclose(float(rank[f"{tag}/run0/loss{i}"]),
                                       loss, rtol=1e-5)
            got = _tree(rank, f"{tag}/run0/state{i}")
            _params_close(got["params"], state["params"], _lr(i + 1))
            _close(got["opt"]["m"], state["opt"]["m"], 1e-4)
            _close(got["opt"]["v"], state["opt"]["v"], 1e-4)
        np.testing.assert_allclose(float(rank[f"{tag}/run0/loss0"]), jloss,
                                   rtol=1e-5)
        got = _tree(rank, f"{tag}/run0/state0")
        _params_close(got["params"], jparams, _lr(1))
        _close(got["opt"]["m"], jm, 1e-4)
        _close(got["opt"]["v"], jv, 1e-4)
        own = _paths(_tree(rank, f"{tag}/own"))
        wq = [k for k in own if k.endswith("attn/wq")]
        assert wq and all(own[k].shape[-2] == 6 for k in wq), wq


def test_xlstm_whole_heads_train_on_model_4(world):
    """A reduced xLSTM's 2 mLSTM/sLSTM heads over model 4 (xlstm-125m's 4
    at model 16), whole on every rank from JAX's training blocks (each
    rank a quarter of the columns of ``w_q``/``w_k``/``w_v``/``w_x``, of
    the rows of ``w_i``/``w_f``/``w_down``/``w_out``; ``b_i``, ``b_f``
    and ``r`` whole): two steps on (1, 4) against world 1, the first
    against JAX's ``make_train_step``, within the other architectures'
    tolerances (moments 1e-4); the whole leaves' gradients (their first
    moments) not summed over "model"."""
    name, tag = XLSTM_WHOLE, _tag(XLSTM_WHOLE, (1, 4))
    jloss, jparams, jm, jv = world["jax"][name]
    for rank in world["ranks"]:
        for i, (loss, state) in enumerate(world["one"][name]):
            np.testing.assert_allclose(float(rank[f"{tag}/run0/loss{i}"]),
                                       loss, rtol=1e-5)
            got = _tree(rank, f"{tag}/run0/state{i}")
            _params_close(got["params"], state["params"], _lr(i + 1))
            _close(got["opt"]["m"], state["opt"]["m"], 1e-4)
            _close(got["opt"]["v"], state["opt"]["v"], 1e-4)
        np.testing.assert_allclose(float(rank[f"{tag}/run0/loss0"]), jloss,
                                   rtol=1e-5)
        got = _tree(rank, f"{tag}/run0/state0")
        _params_close(got["params"], jparams, _lr(1))
        _close(got["opt"]["m"], jm, 1e-4)
        _close(got["opt"]["v"], jv, 1e-4)
        own = _paths(_tree(rank, f"{tag}/own/params"))
        for k, a in own.items():
            leaf = k.rsplit("/", 1)[-1]
            if leaf in ("w_q", "w_k", "w_v"):
                assert a.shape[-1] == 128 // 4, (k, a.shape)
            elif leaf == "w_x":
                assert a.shape[-1] == 256 // 4, (k, a.shape)
            elif leaf in ("b_i", "b_f"):
                assert a.shape[-1] == 2, (k, a.shape)
    jcfg = world["jcfgs"][name]
    for r, rank in enumerate(world["ranks"]):
        whole = _tree(rank, f"{tag}/run0/state{STEPS - 1}")
        own = _tree(rank, f"{tag}/own")
        for kind, tree in (("params", whole["params"]),
                           ("m", whole["opt"]["m"])):
            _bitwise(_paths(own[kind]), _jax_blocks(jcfg, (1, 4), tree, r))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", OTHER)
def test_other_decoders_one_step(world, name, mesh):
    """phi3 (10 kv heads, which no model axis here divides), chameleon
    (QK-norm) and dbrx (MoE): one step against world 1."""
    (loss, state), = world["one"][name]
    for rank in world["ranks"]:
        tag = _tag(name, mesh)
        np.testing.assert_allclose(float(rank[f"{tag}/run0/loss0"]), loss,
                                   rtol=1e-5)
        got = _tree(rank, f"{tag}/run0/state0")
        _params_close(got["params"], state["params"], _lr(1))
        _close(got["opt"]["m"], state["opt"]["m"], 1e-4)


def _jax_blocks(jcfg, mesh, whole: dict, rank: int) -> dict:
    """JAX's training blocks of mesh rank ``rank`` of a whole JAX-layout
    parameter tree: each leaf cut by JAX's ``params_shardings(train=
    True)`` spec of it."""
    amesh = AbstractMesh(mesh, ("data", "model"))
    specs = _paths(jax.tree.map(
        lambda s: np.array(tuple(s.spec), dtype=object),
        jsh.params_shardings(param_specs(jcfg), amesh, train=True),
        is_leaf=lambda s: hasattr(s, "spec")))
    got = {}
    for path, leaf in _paths(whole).items():
        spec = tuple(specs[path])
        got[path] = tsh.block(leaf, spec, types.SimpleNamespace(
            shape=dict(amesh.shape), rank=rank))
    return got


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", ALL)
def test_rank_blocks_are_jax_train_blocks(world, name, mesh):
    """Each rank's parameters as cut, and after the last step its
    parameters and first moments, are its blocks of the whole leaves by
    JAX's training specs, bit for bit."""
    tag = _tag(name, mesh)
    jcfg = world["jcfgs"][name]
    last = (STEPS if name in TWO_STEPS else 1) - 1
    for r, rank in enumerate(world["ranks"]):
        want = _jax_blocks(jcfg, mesh, world["weights"][name], r)
        _bitwise(_paths(_tree(rank, f"{tag}/init")["params"]), want)
        whole = _tree(rank, f"{tag}/run0/state{last}")
        own = _tree(rank, f"{tag}/own")
        for kind, tree in (("params", whole["params"]),
                           ("m", whole["opt"]["m"])):
            _bitwise(_paths(own[kind]), _jax_blocks(jcfg, mesh, tree, r))
    # the blocks are smaller than the whole where the specs cut (the
    # parameters' and first moments' blocks together for a decoder;
    # whisper's position table, whole at (1, 4), outweighs its cut leaves,
    # so its parameters' blocks alone)
    init = _tree(world["ranks"][0], f"{tag}/init")
    sizes = [a.size for a in _paths(init if name in DECODERS else
                                    init["params"]).values()]
    whole = sum(a.size for a in _paths(world["weights"][name]).values())
    assert sum(sizes) < whole


@pytest.mark.parametrize("name", TWO_STEPS)
def test_two_runs_bitwise(world, name):
    """The (2, 2) steps run twice from the same blocks: the same losses
    and states, bit for bit."""
    tag = _tag(name, (2, 2))
    for rank in world["ranks"]:
        for i in range(STEPS):
            assert rank[f"{tag}/run0/loss{i}"] == rank[f"{tag}/run1/loss{i}"]
            _bitwise(_tree(rank, f"{tag}/run1/state{i}"),
                     _tree(rank, f"{tag}/run0/state{i}"))


def test_ranks_agree(world):
    """Every rank holds the same losses and gathered state."""
    r0 = world["ranks"][0]
    for rank in world["ranks"][1:]:
        for name in ALL:
            for mesh in MESHES:
                _bitwise(_tree(rank, f"{_tag(name, mesh)}/run0"),
                         _tree(r0, f"{_tag(name, mesh)}/run0"))


def test_sync_ms_reports_each_kind(world):
    """``sync_ms`` names every kind; on (2, 2) the ``"data"`` gathers,
    the reduce-scatters and the ``"model"`` sums ran, on (1, 4) no
    ``"data"`` gather did."""
    for rank in world["ranks"]:
        for mesh in MESHES:
            tag = _tag("llama3-8b", mesh)
            kinds = [str(k) for k in rank[f"{tag}/sync_kinds"]]
            assert kinds == sorted(tsteps.SYNC_KINDS)
            ms = dict(zip(kinds, rank[f"{tag}/sync"].tolist()))
            assert all(v >= 0 for v in ms.values())
            assert ms["model_sum"] > 0
            if mesh == (2, 2):
                assert ms["data_gather"] > 0
                assert ms["grad_reduce_scatter"] > 0
            else:
                assert ms["data_gather"] == 0


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------

def test_mesh_save_is_world1_file_in_jax(world):
    """The (2, 2) save after two steps, read by the JAX package's
    ``restore``: JAX's train-state tree, leaf for leaf the world-1 save
    of the same step (shapes and dtypes), its values world 1's within the
    tolerances."""
    tmp = world["tmp"]
    got, step = jck.restore(str(tmp / "mesh"), 2)
    want, _ = jck.restore(str(tmp / "world1"), 2)
    assert step == 2
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(lambda a, b: (np.testing.assert_array_equal(
        np.asarray(a).shape, np.asarray(b).shape),
        np.testing.assert_equal(np.asarray(a).dtype, np.asarray(b).dtype)),
        got, want)
    got, want = jax.tree.map(np.asarray, got), jax.tree.map(np.asarray,
                                                            want)
    _params_close(got["params"], want["params"], _lr(2))
    _close(got["opt"]["m"], want["opt"]["m"], 1e-4)
    assert int(got["opt"]["step"]) == 2


def test_resumes_across_meshes(world):
    """A (2, 2) save resumed at world 1, and a world-1 save resumed on
    (2, 2) (``restore(shardings=)`` of ``state_shardings`` on the mesh),
    each take the third step to the uninterrupted run's loss."""
    loss3 = world["one"][RESUME][2][0]
    for rank in world["ranks"]:
        assert int(rank["resumed/at"]) == 2
        np.testing.assert_allclose(float(rank["resumed/loss"]), loss3,
                                   rtol=1e-5)
    tcfg = world["cfgs"][RESUME]
    tree, at = ck.restore(world["tmp"] / "mesh")
    p = lm_params_from_numpy(tree["params"], tcfg, "cpu")
    st = opt_state_from_numpy(tree["opt"], tcfg, "cpu")
    step = tsteps.make_train_step(tcfg, ShapeConfig("c", "train", S, B),
                                  microbatches=2)
    with few_threads():
        _, _, loss = step(p, st, _batch(world["batches"][at]))
    np.testing.assert_allclose(float(loss), loss3, rtol=1e-5)


def test_recurrent_mesh_save_resumes_at_world1(world):
    """xlstm's (2, 2) save after two steps (the whole leaves mesh rank 0
    wrote), resumed at world 1, takes the third step to the uninterrupted
    world-1 run's loss."""
    tcfg = world["cfgs"][RESUME_22]
    tree, at = ck.restore(world["tmp"] / f"mesh_{RESUME_22}")
    assert at == STEPS
    p = lm_params_from_numpy(tree["params"], tcfg, "cpu")
    st = opt_state_from_numpy(tree["opt"], tcfg, "cpu")
    step = tsteps.make_train_step(tcfg, ShapeConfig("c", "train", S, B),
                                  microbatches=2)
    with few_threads():
        _, _, loss = step(p, st, _batch(world["batches"][at]))
    np.testing.assert_allclose(float(loss), world["one"][RESUME_22][2][0],
                               rtol=1e-5)


def test_trainer_on_the_mesh_resumes_at_world1(world, tmp_path):
    """``train(production=True, mesh_shape=(2, 2))`` gives world 1's
    losses (two microbatches) within tolerance; its save after step 2
    (the whole leaves mesh rank 0 wrote) resumed by ``train()`` at world 1
    takes the last step to the uninterrupted run's loss."""
    import shutil
    with few_threads():       # train() takes signals: the main thread
        ref = dict(ttrain.train(**TRAIN, device="cpu", resume=False,
                                microbatches=2, log_every=10**6,
                                ckpt_dir=str(tmp_path / "ref"))[2])
    for rank in world["ranks"]:
        got = {int(s): x for s, x in rank["train/losses"]}
        assert sorted(got) == sorted(ref)
        for s_ in ref:
            np.testing.assert_allclose(got[s_], ref[s_], rtol=1e-5)
    shutil.copytree(world["tmp"] / "train22" / "step_2",
                    tmp_path / "mesh" / "step_2")
    with few_threads():
        _, _, losses = ttrain.train(**TRAIN, device="cpu", microbatches=2,
                                    log_every=10**6,
                                    ckpt_dir=str(tmp_path / "mesh"))
    assert [s_ for s_, _ in losses] == [2]
    np.testing.assert_allclose(losses[0][1], ref[2], rtol=1e-5)


# ---------------------------------------------------------------------------
# without the world
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_make_step_trains_at_model_2(name):
    """``make_step(cfg, (2, 2), train)`` gives a step for each of the ten
    architectures at full size: the attention decoders, and the recurrent
    blocks and the encoder-decoder, whose inner blocks and heads split
    over model 2 as the attention's do."""
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2}, size=4,
                                 model=2, in_mesh=True)
    cfg = get_config(name)
    train = ShapeConfig("c", "train", 4096, 4)
    step = tsteps.make_step(cfg, mesh, train)
    assert callable(step) and step.microbatches == 1


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 1), (2, 1)])
def test_owned_blocks_cut_by_each_axis(mesh):
    """``owned_blocks`` names each rank's block by the data axis's size
    and the rank's index on it, and the model axis's likewise: the views
    it names are ``sharding.block``'s of JAX's spec of the leaf."""
    D, M = mesh
    cfg = get_config("llama3-8b-reduced")
    jcfg = cfgs("llama3-8b")[0]
    p = lm_params_from_numpy(jax.tree.map(
        lambda s: np.arange(np.prod(s.shape), dtype=np.float32).reshape(
            s.shape), param_specs(jcfg)), cfg, "cpu")
    amesh = AbstractMesh(mesh, ("data", "model"))
    for r in range(D * M):
        dm = DataMesh(group=None, rank=r, size=D * M, device=torch.device(
            "cpu"), backend="gloo", world_rank=r, world_size=D * M,
            model=M)
        blocks = tsh.owned_blocks(p, cfg, dm)
        specs = tsh.params_shardings(p, cfg, dict(amesh.shape), train=True)
        for (n, t), blk in zip(p.named_parameters(), blocks):
            want = tsh.block(t, specs[n], dm)
            assert torch.equal(tsh.block_of(t, blk), want), (n, r)
            assert (blk is None) == (want.numel() == t.numel()), (n, r)


def test_grad_norm_rows_do_not_depend_on_the_split():
    """The norm's row sums of a leaf are the same bits whether its rows
    are summed together or in blocks, beside other leaves' rows of their
    length or alone, and past the size that halves alone; the leaf's sum
    the same however many rows a rank held; the norm is within f32
    rounding of a plain sum."""
    gen = torch.Generator().manual_seed(0)
    g = torch.randn((96, 37), generator=gen)
    name = "blocks.0.mlp.w_gate"            # rows: dimension 0
    sq = tadamw._squares(name, g)
    whole, = tadamw._tree_sums([sq])
    parts = torch.cat(tadamw._tree_sums(list(sq.split(24))))
    assert torch.equal(whole, parts)
    other = torch.randn((5, 37), generator=gen)
    assert torch.equal(tadamw._tree_sums([other, sq])[1], whole)
    big = torch.randn((3, 3 * tadamw._ALONE + 5), generator=gen)
    alone = torch.cat([tadamw._tree_sums([r.view(1, -1)])[0]
                       for r in big.clone().split(1)])
    assert torch.equal(tadamw._tree_sums([big])[0], alone)
    t, = tadamw._tree_sums([torch.arange(1, 12, dtype=torch.float32)
                            .view(1, -1)])
    assert float(t[0]) == 66.0
    gn = tadamw.grad_norm([name, "final_norm.scale"],
                          [g, torch.ones(5)])
    want = torch.sqrt((g.double() ** 2).sum() + 5)
    assert abs(float(gn) - float(want)) <= 1e-6 * float(want)
