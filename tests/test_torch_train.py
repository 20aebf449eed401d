"""The port's LM training path against the JAX package, on the CPU.

``cross_entropy``; ``lm_loss`` and its gradients for all ten reduced
architectures against ``jax.value_and_grad`` of JAX's ``lm_loss`` (the
JAX package's weights carried across by ``convert``; MoE blocks at top-2
with their routers scaled by 100, as ``tests/test_torch_lm_families.py``
holds ``moe_apply``: at the 0.02 init the router margins are about 1e-5
and f32 summation order flips top-k membership), the flash path's loss
(``attn_impl="chunked"``) at S 512, ``encdec_loss``; AdamW over three
steps from one state; ``make_train_step`` with one and two microbatches
against JAX's step on the same batch; the token stream's transitions; the
checkpoint manager (``tests/test_checkpoint.py``'s cases), and training
checkpoints read both ways between the packages; ``train()`` interrupted
and resumed bitwise (JAX's ``test_restart_bit_identical``), a SIGTERM
whose save lands at the step reached, and ``production=True`` at a world
of one (``tests/test_torch_sharded_train.py`` holds the sharded trainer).

Tolerances (f32): losses within 1e-5 relative; gradients and AdamW's
moments within 1e-4 of each leaf's largest magnitude (XLA and torch sum
in their own orders; measured 1e-6 to 1.9e-5), jamba's within 1e-3 (a
mamba block's gradients agree within 1e-6, held at 1e-5 below; over its
16 layers with top-2 routing the whole model's differ by up to 3.5e-4);
parameters after a step within 1e-6 of their largest magnitude plus twice
the step's lr (an element whose gradient is within rounding of 0 may take
the other sign in Adam's first step).
"""
import contextlib
import os
import signal
import subprocess
import sys
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.synthetic import token_stream as jtoken_stream
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro.runtime import sharding as jsh
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy,
                                 opt_state_from_numpy, opt_state_to_numpy,
                                 train_state_to_numpy)
from repro_torch.data import synthetic
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step, pick_microbatches
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.optim import adamw as tadamw
from torch_lm_parity import cfgs, normal, params, rel, tokens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODERS = [n for n in ARCH_NAMES if n != "whisper-tiny"]
GRAD_TOL = {"jamba-v0.1-52b": 1e-3}


def _scaled_routers(jp):
    """JAX params with every MoE router scaled by 100 (stable top-k)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: (v * 100.0 if k == "router" else walk(v))
                    for k, v in t.items()}
        return t
    return walk(jp)


def _setup(name, seed=0, **kw):
    jcfg, tcfg = cfgs(name, total_routing=False, **kw)
    jp, _ = params(jcfg, tcfg, seed)
    jp = _scaled_routers(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, lm_params_from_numpy(jp, tcfg, "cpu")


def _trainable(tp):
    return tp.requires_grad_(True)


def _port_grads(tp, tcfg, loss):
    """(loss, gradients in JAX's tree) of the port's loss, computed on
    the trainable ``tp``."""
    plist = list(tp.parameters())
    gs = torch.autograd.grad(loss, plist, allow_unused=True)
    by_id = {id(p): (torch.zeros_like(p) if g is None else g)
             for p, g in zip(plist, gs)}
    return float(loss.detach()), lm_params_to_numpy(
        tlm.map_tree(lambda p: by_id[id(p)], tp), tcfg)


def _same_tree(got, want, tol, where=()):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _same_tree(got[k], want[k], tol, where + (k,))
        return
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, where
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err < tol, (where, err)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7))
    want = float(jlayers.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels)))
    got = tlayers.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    no_z = tlayers.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels), z_loss=0.0)
    np.testing.assert_allclose(float(no_z), float(jlayers.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), z_loss=0.0)), rtol=1e-6)


@pytest.mark.parametrize("name", DECODERS)
def test_lm_loss_and_grads_match_jax(name):
    """``lm_loss`` (remat on, as JAX's default) and every gradient leaf
    against ``jax.value_and_grad`` of JAX's ``lm_loss``; B 2, S 16."""
    jcfg, tcfg, jp, tp = _setup(name)
    toks = tokens(2, 17, tcfg.vocab_size, seed=3)
    x, y = toks[:, :-1], toks[:, 1:]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, jnp.asarray(x), jnp.asarray(y))))(
            jax.tree.map(jnp.asarray, jp))
    loss, grads = _port_grads(tp, tcfg, tlm.lm_loss(
        _trainable(tp), tcfg, torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    _same_tree(grads, jax.tree.map(np.asarray, jgrads),
               GRAD_TOL.get(name, 1e-4))


def test_mamba_block_grads_match_jax():
    """One mamba block's backward through the doubling scan: the input's
    and every parameter's gradient against ``jax.vjp`` of JAX's
    ``mamba_fwd`` (its associative scan), within 1e-5."""
    jcfg, tcfg = cfgs("jamba-v0.1-52b")
    jp = jax.tree.map(np.asarray, jssm.init_mamba(jax.random.key(0), jcfg))
    tp = tlm.as_module({k: torch.from_numpy(np.array(v))
                        for k, v in jp.items()}).requires_grad_(True)
    x, g = normal((2, 16, 64), seed=1), normal((2, 16, 64), seed=2)
    _, vjp = jax.vjp(lambda p, x: jssm.mamba_fwd(p, x, jcfg),
                     jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    names = [n for n, _ in tp.named_parameters()]
    grads = torch.autograd.grad(tssm.mamba_fwd(tp, xt, tcfg),
                                list(tp.parameters()) + [xt],
                                torch.from_numpy(g))
    assert rel(grads[-1].numpy(), jgx) < 1e-5
    for n, gr in zip(names, grads[:-1]):
        assert rel(gr.numpy(), np.asarray(jgp[n])) < 1e-5, n


def test_lm_loss_remat_changes_nothing():
    """Recomputing the periods in the backward gives the same bits."""
    _, tcfg, _, tp = _setup("jamba-v0.1-52b")
    _trainable(tp)
    toks = torch.from_numpy(tokens(2, 17, tcfg.vocab_size, seed=4))
    out = []
    for remat in (True, False):
        loss = tlm.lm_loss(tp, tcfg, toks[:, :-1], toks[:, 1:], remat=remat)
        out.append(_port_grads(tp, tcfg, loss))
    assert out[0][0] == out[1][0]
    jax.tree.map(np.testing.assert_array_equal, out[0][1], out[1][1])


def test_lm_loss_chunked_matches_jax():
    """The flash path forced (``attn_impl="chunked"``) at S 512: the
    autograd Function's plain versions against JAX's chunked attention
    and its custom VJP, loss and gradients."""
    jcfg, tcfg, jp, tp = _setup("qwen1.5-0.5b")
    toks = tokens(1, 513, tcfg.vocab_size, seed=5)
    x, y = toks[:, :-1], toks[:, 1:]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, jnp.asarray(x), jnp.asarray(y),
                              attn_impl="chunked")))(
            jax.tree.map(jnp.asarray, jp))
    loss, grads = _port_grads(tp, tcfg, tlm.lm_loss(
        _trainable(tp), tcfg, torch.from_numpy(x), torch.from_numpy(y),
        attn_impl="chunked"))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    _same_tree(grads, jax.tree.map(np.asarray, jgrads), 1e-4)


def test_encdec_loss_and_grads_match_jax():
    jcfg, tcfg, jp, tp = _setup("whisper-tiny")
    toks = tokens(2, 17, tcfg.vocab_size, seed=6)
    x, y = toks[:, :-1], toks[:, 1:]
    frames = normal((2, tcfg.enc_positions, tcfg.d_model), seed=7)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jencdec.encdec_loss(p, jcfg, jnp.asarray(x),
                                      jnp.asarray(y),
                                      jnp.asarray(frames))))(
            jax.tree.map(jnp.asarray, jp))
    loss, grads = _port_grads(tp, tcfg, tencdec.encdec_loss(
        _trainable(tp), tcfg, torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(frames)))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    _same_tree(grads, jax.tree.map(np.asarray, jgrads), 1e-4)


def test_adamw_three_steps_match_jax():
    """Three ``adamw_update`` steps from one state, the same gradients fed
    to both (scaled so the clip is active, a 2-step warmup): parameters,
    moments, step, the gradient norm and the lr."""
    jcfg, tcfg, jp, tp = _setup("gemma3-12b", seed=1)
    cfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2)
    tcfg_opt = tadamw.AdamWConfig(lr=1e-2, warmup_steps=2)
    jstate = jadamw.adamw_init(jax.tree.map(jnp.asarray, jp))
    tstate = tadamw.adamw_init(tp)
    jparams = jax.tree.map(jnp.asarray, jp)
    for i in range(3):
        rng = np.random.default_rng(10 + i)
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3)
                         .astype(np.float32), jp)
        jparams, jstate, jstats = jadamw.adamw_update(
            cfg, jparams, jax.tree.map(jnp.asarray, g), jstate)
        gmod = lm_params_from_numpy(g, tcfg, "cpu")
        tp, tstate, tstats = tadamw.adamw_update(tcfg_opt, tp, gmod, tstate)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        assert tstate["step"].dtype == torch.int32
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tstats["lr"]), float(jstats["lr"]),
                                   rtol=1e-7)
        _same_tree(lm_params_to_numpy(tp, tcfg),
                   jax.tree.map(np.asarray, jparams), 1e-6)
        opt = opt_state_to_numpy(tstate, tcfg)
        _same_tree(opt["m"], jax.tree.map(np.asarray, jstate["m"]), 1e-5)
        _same_tree(opt["v"], jax.tree.map(np.asarray, jstate["v"]), 1e-5)


def test_pick_microbatches_matches_jax():
    from repro.launch.steps import pick_microbatches as jpick
    mesh = make_host_mesh()
    for seq, batch in ((4096, 4), (128, 8), (4096, 6), (2048, 256)):
        assert pick_microbatches(ShapeConfig("c", "train", seq, batch)) == \
            jpick(mesh, JShapeConfig("c", "train", seq, batch))
    assert pick_microbatches(ShapeConfig("c", "train", 4096, 4)) == 2


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax(micro):
    """One ``make_train_step`` step (gradients over ``micro``
    microbatches, summed in f32, then AdamW) against JAX's on the same
    batch from the same weights: the loss, the moments and the
    parameters (module docstring's tolerances)."""
    jcfg, tcfg, jp, tp = _setup("llama3-8b", seed=2)
    shape = JShapeConfig("c", "train", 16, 4)
    jstep, *_ = jmake_train_step(jcfg, make_host_mesh(), shape,
                                 microbatches=micro)
    toks = tokens(4, 17, tcfg.vocab_size, seed=8)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(
        toks[:, 1:])}
    jparams = jax.tree.map(jnp.asarray, jp)
    # JAX's step on one device, its activation policy off: under JAX 0.9
    # the policy's sharding constraints name make_mesh's Explicit axes,
    # which with_sharding_constraint refuses (ROADMAP Queue 3)
    with mock.patch.object(jsh, "activation_policy",
                           lambda *a, **kw: contextlib.nullcontext()):
        jparams, jstate, jloss = jax.jit(jstep)(
            jparams, jadamw.adamw_init(jparams), jb)
    step = make_train_step(tcfg, ShapeConfig("c", "train", 16, 4),
                           microbatches=micro)
    assert step.microbatches == micro
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(toks[:, 1:])}
    tp, tstate, loss = step(tp, tadamw.adamw_init(tp), tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    opt = opt_state_to_numpy(tstate, tcfg)
    _same_tree(opt["m"], jax.tree.map(np.asarray, jstate["m"]), 1e-4)
    lr = float(tadamw._schedule(tadamw.AdamWConfig(), tstate["step"]))
    got = lm_params_to_numpy(tp, tcfg)
    want = jax.tree.map(np.asarray, jparams)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-6 * float(np.abs(b).max()) + 2 * lr),
        got, want)


def test_token_stream_transitions():
    """The Markov stream: batch i depends only on (seed, i), labels are
    the tokens shifted by one, and the share of transitions ``next =
    perm[prev]`` is ``markov`` (+ the uniform draws that hit it) within
    0.02; ``markov=0`` is uniform."""
    V = 97
    perm = torch.randperm(V, generator=synthetic._generator(5, 10**6))
    batches = list(synthetic.token_stream(5, 3, 8, 256, V))
    again = synthetic.token_batch(5, 2, 8, 256, V)
    assert torch.equal(batches[2]["tokens"], again["tokens"])
    assert not torch.equal(batches[0]["tokens"], batches[1]["tokens"])
    for b in batches:
        t, y = b["tokens"], b["labels"]
        assert t.shape == y.shape == (8, 256) and t.dtype == torch.int64
        assert torch.equal(t[:, 1:], y[:, :-1])
        share = float((perm[t] == y).float().mean())
        assert abs(share - (0.9 + 0.1 / V)) < 0.02, share
    u = synthetic.token_batch(5, 0, 8, 256, V, markov=0.0)
    assert abs(float((perm[u["tokens"]] == u["labels"]).float().mean())
               - 1 / V) < 0.02
    # the JAX package's stream has the same contract (its draws differ)
    jb = next(jtoken_stream(jax.random.key(5), 1, 8, 256, V))
    assert np.asarray(jb["tokens"]).shape == tuple(t.shape)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 32)).astype(np.float32),
            "nested": {"b": np.arange(17, dtype=np.int32),
                       "scale": np.float32(3.5)},
            "stack": rng.standard_normal((4, 8, 8)).astype(np.float32)}


def test_latest_step_and_manager_roundtrip(tmp_path):
    """``tests/test_checkpoint.py``'s manager round trip and
    ``latest_step`` (an uncommitted checkpoint does not count)."""
    assert ck.latest_step(tmp_path) is None
    mgr = CheckpointManager(str(tmp_path), save_every=5)
    assert mgr.resume() == (None, 0)
    t = _tree(3)
    assert mgr.maybe_save(3, t) is None           # not on the cadence
    assert mgr.maybe_save(5, t) is not None
    assert mgr.maybe_save(10, lambda: t) is not None   # a tree maker
    (tmp_path / "step_10" / "_COMMITTED").unlink()
    assert ck.latest_step(tmp_path) == 5
    got, step = mgr.resume()
    assert step == 5
    np.testing.assert_array_equal(got["w"], t["w"])
    mgr.save_now(7, t)
    assert ck.all_steps(tmp_path) == [5, 7]


def test_restore_like_casts_and_checks(tmp_path):
    t = _tree(1)
    ck.save(tmp_path, 1, t)
    like = {"w": torch.zeros((64, 32), dtype=torch.float64),
            "nested": {"b": torch.zeros(17, dtype=torch.int64),
                       "scale": np.float16(0)},
            "stack": np.zeros((4, 8, 8), np.float32)}
    got, step = ck.restore(tmp_path, like=like)
    assert step == 1
    assert got["w"].dtype == torch.float64 and torch.is_tensor(got["w"])
    np.testing.assert_array_equal(got["w"].numpy(), t["w"])
    assert got["nested"]["b"].dtype == torch.int64
    assert got["nested"]["scale"].dtype == np.float16
    np.testing.assert_array_equal(got["stack"], t["stack"])
    with pytest.raises(ValueError, match="like"):
        ck.restore(tmp_path, like={"w": like["w"]})
    got, _ = CheckpointManager(str(tmp_path)).resume(like=like)
    assert got["w"].dtype == torch.float64


def test_training_checkpoints_load_both_ways(tmp_path):
    """A port-written train state read by JAX's ``CheckpointManager``:
    JAX's own train-state structure, the same values, and a JAX AdamW
    step taken on it; a JAX-written one read by the port's trainer, which
    resumes from its step."""
    jcfg, tcfg, jp, tp = _setup("qwen1.5-0.5b", seed=4)
    tstate = tadamw.adamw_init(tp)
    g = lm_params_from_numpy(jax.tree.map(
        lambda a: np.full(a.shape, 0.01, np.float32), jp), tcfg, "cpu")
    tp, tstate, _ = tadamw.adamw_update(tadamw.AdamWConfig(), tp, g, tstate)
    CheckpointManager(str(tmp_path / "port"), save_every=1).maybe_save(
        1, train_state_to_numpy(tp, tstate, tcfg))
    got, step = JManager(str(tmp_path / "port")).resume()
    assert step == 1
    jparams = jax.tree.map(jnp.asarray, jp)
    want = {"params": jparams, "opt": jadamw.adamw_init(jparams)}
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert int(got["opt"]["step"]) == 1
    _same_tree(got["params"], lm_params_to_numpy(tp, tcfg), 1e-12)
    jadamw.adamw_update(jadamw.AdamWConfig(), got["params"],
                        got["params"], got["opt"])
    # the reverse: JAX's trainer state, resumed by the port's trainer
    jmgr = JManager(str(tmp_path / "jax"), save_every=2)
    jmgr.maybe_save(2, {"params": jparams,
                        "opt": dict(jadamw.adamw_init(jparams),
                                    step=jnp.int32(2))})
    tree, step = CheckpointManager(str(tmp_path / "jax")).resume()
    opt = opt_state_from_numpy(tree["opt"], tcfg, "cpu")
    assert step == 2 and int(opt["step"]) == 2
    _same_tree(lm_params_to_numpy(lm_params_from_numpy(
        tree["params"], tcfg, "cpu"), tcfg), jax.tree.map(np.asarray, jp),
        1e-12)
    _, opt, losses = ttrain.train("qwen1.5-0.5b", steps=3, batch=2, seq=16,
                                  ckpt_dir=str(tmp_path / "jax"),
                                  device="cpu", log_every=100)
    assert [s for s, _ in losses] == [2] and int(opt["step"]) == 3


def _run(steps, ckpt_dir, resume=True):
    _, _, losses = ttrain.train("qwen1.5-0.5b", steps=steps, batch=4, seq=32,
                                ckpt_dir=ckpt_dir, save_every=4,
                                resume=resume, log_every=1000, device="cpu")
    return dict(losses)


def test_restart_bit_identical(tmp_path):
    """An interrupted-then-resumed run reproduces the uninterrupted run's
    losses exactly (JAX's ``test_restart_bit_identical``): the resumed run
    restarts at step 4, its checkpoint, and every later loss is equal."""
    ref = _run(12, str(tmp_path / "ref"), resume=False)
    _run(6, str(tmp_path / "int"), resume=False)
    resumed = _run(12, str(tmp_path / "int"))
    assert sorted(resumed) == list(range(4, 12))
    for s in range(4, 12):
        assert resumed[s] == ref[s], (s, resumed[s], ref[s])


def test_sigterm_saves_the_step_reached(tmp_path):
    """SIGTERM in the middle of a run: the loop finishes its step, saves
    the step it reached (never -1, the JAX trainer's preemption save) and
    the process dies by the signal; the saved AdamW step equals it."""
    code = (f"import sys; sys.path.insert(0, {os.path.join(REPO, 'src')!r})\n"
            "from repro_torch.launch.train import train\n"
            f"train('qwen1.5-0.5b', steps=100000, batch=2, seq=16, "
            f"ckpt_dir={str(tmp_path)!r}, save_every=100000, log_every=1, "
            "device='cpu')\n")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    deadline = threading.Timer(120.0, proc.kill)    # a stuck child ends
    deadline.start()
    seen = []
    try:
        for line in proc.stdout:
            if line.startswith("step"):
                seen.append(int(line.split()[1]))
                if seen[-1] == 2:
                    proc.send_signal(signal.SIGTERM)
            if line.startswith("preemption"):
                break
        rest = proc.communicate(timeout=60)[0]
    finally:
        deadline.cancel()
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGTERM, (proc.returncode, rest)
    steps = ck.all_steps(tmp_path)
    assert steps == [seen[-1] + 1] and steps[0] >= 3
    tree, step = ck.restore(tmp_path)
    assert int(tree["opt"]["step"]) == step


def test_production_mesh_and_encdec_raise(tmp_path):
    """``production=True`` trains over the data mesh: at a world of one
    over gloo (made here, and taken down after) its losses are
    ``production=False``'s; the encoder-decoder, whose batches need
    encoder frames, raises."""
    import torch.distributed as dist
    kw = dict(steps=2, batch=2, seq=16, resume=False, log_every=100,
              device="cpu")
    _, _, want = ttrain.train("qwen1.5-0.5b", ckpt_dir=str(tmp_path / "a"),
                              **kw)
    was = dist.is_initialized()
    try:
        _, opt, got = ttrain.train("qwen1.5-0.5b", production=True,
                                   ckpt_dir=str(tmp_path / "b"), **kw)
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    finally:
        if not was and dist.is_initialized():
            dist.destroy_process_group()
    assert got == want and int(opt["step"]) == 2
    with pytest.raises(ValueError, match="encoder frames"):
        ttrain.train("whisper-tiny", device="cpu", ckpt_dir=str(tmp_path))
