"""The port's sharded serving path against the JAX package, on the CPU
over gloo: tensor parallelism over ``"model"``, expert parallelism over
``"data"``, JAX's sharded cache layouts, ``make_prefill_step`` and
``make_decode_step``.

Layouts, shapes only, on JAX ``AbstractMesh``es of (1, 1), (2, 1), (4,
1), (2, 2) and (1, 4), for all ten architectures at full size: the
port's ``batch_shardings`` (cache leaves by ``_cache_pspec``),
``_out_tree_shardings`` and ``out_shardings_for`` equal JAX's on the same
shapes (the port's cache shapes are JAX's ``cache_specs``), batch-first
and sequence-parallel (global batch 4 and 1), with and without
``kv_quant``, the KV heads repeated by ``kv_tp_repeat``;
``make_prefill_step``/``make_decode_step``'s layouts equal those of JAX's
two functions; the MoE route equals the one JAX's ``_moe_apply_sharded``
traces (an ``all_to_all``, or not) for mixtral, dbrx and jamba at decode
and at an 8192-token prefill a data shard.

One world of four gloo processes for the whole file
(``tests/torch_dist_ranks.py::tp_serve_world``) forms (2, 2), (1, 4),
(4, 1) and (2, 1) meshes in turn, and runs each case's prefill and 4
decode steps through the sharded steps in f32 on the rank's blocks of
JAX-layout weights (drawn by the port's init, seeded; the JAX side reads
the same arrays); JAX's ``lm_prefill``/``lm_decode`` (and
``encdec_prefill``/``encdec_decode``) run once a case in this process
meanwhile, on the whole batch.  The logits and the caches are rebuilt
whole from the ranks' blocks (``sharding.assemble``) and held to JAX's:
the seven attention decoders at all four meshes (qwen with 4 kv heads,
MHA; at model 4 the reduced configs' 2 kv heads repeat to 4, and JAX's
cache is compared repeated likewise, ``jnp.repeat``'s order); 6 query
heads over 3 kv heads at model 2, whose cache shards the head dimension,
in f32 and int8; jamba, xlstm and whisper at all four meshes (at
``model`` > 1 the mamba inner blocks, the mLSTM's and sLSTM's heads and
whisper's heads and ff over ``"model"``; each rank's parameter and cache
blocks are JAX's blocks of the whole leaves, no rank holds a whole
``w_in``/``w_up``/``w_x`` and no step gathers a weight block);
sequence-parallel decodes (global batch 1 on data 2) of gemma3, mixtral
and whisper; a reduced whisper with an odd vocab (509) at (1, 2), whose
table JAX keeps whole.  MoE whole models run with total routing, so
that no token drops and each data shard's own routing (what ``moe_apply_sharded`` computes
there) equals JAX's on the whole batch; at top-2 one MoE layer is held per
data shard to JAX's ``_dispatch_and_compute`` on that shard's rows, at
both routes.  At (P, 1) the dense decoders are bitwise the port's one
device on the rank's rows.

Tolerances (f32): logits and cache leaves within 1e-5 of the leaf's
largest magnitude (the row-parallel sums over ``"model"`` and the
flash-decoding combine add in other orders than one device); an int8
cache within one quantization step of JAX's (a value at a rounding edge
may round the other way), the int8 case's logits within 1e-4; the MoE
layer within 1e-5.
"""
import dataclasses
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import steps as jsteps
from repro.models import encdec as jencdec
from repro.models import factory as jfactory
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.runtime import sharding as jsh
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_params_to_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.models import encdec as tencdec
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.attention import kv_tp_repeat
from repro_torch.models.factory import init_cache
from repro_torch.runtime import sharding as tsh
from torch_dist_ranks import start_world
from torch_lm_parity import cfgs, normal, tokens

MESHES = [(1, 1), (2, 1), (4, 1), (2, 2), (1, 4)]
DECODERS = ("qwen1.5-0.5b", "llama3-8b", "phi3-medium-14b", "gemma3-12b",
            "chameleon-34b", "mixtral-8x7b", "dbrx-132b")
OTHERS = ("jamba-v0.1-52b", "xlstm-125m", "whisper-tiny")
TP_MESHES = [(2, 2), (1, 4), (4, 1), (2, 1)]
DP_MESHES = [(4, 1), (2, 1)]
MODEL_MESHES = [(2, 2), (1, 4)]     # the recurrent blocks' and whisper's TP
ODD_VOCAB = {"vocab_size": 509}     # whisper's table whole at model 2
B, S, STEPS = 4, 72, 4          # S past the reduced window of 64
TOL, TOL_INT8 = 1e-5, 1e-4
OVERRIDES = {"qwen1.5-0.5b": {"n_kv_heads": 4}}
HD_SPLIT = {"n_heads": 6, "n_kv_heads": 3}      # over llama3's reduced
# query heads that do not divide model 4, whole on every rank: whisper's
# 6 (whisper-tiny's own count) and a GQA decoder's 6 over 2 kv heads
WHOLE_HEADS = {"whisper-tiny": {"n_heads": 6, "n_kv_heads": 6},
               "llama3-8b": {"n_heads": 6, "n_kv_heads": 2}}
# a reduced xLSTM whose 2 heads do not divide model 4 (xlstm-125m's 4 at
# model 16): its mLSTM/sLSTM heads whole on every rank
XLSTM_2_HEADS = {"n_heads": 2}
# one mamba layer whose inner width (66) does not divide model 4: whole on
# every rank (its w_in, 132 columns, still cut); no architecture's does
MAMBA_WHOLE = {"d_model": 33}


def _jdtype(t):
    return jnp.dtype(str(t.dtype).removeprefix("torch."))


def _sds(tree):
    """A tree of meta tensors as JAX ShapeDtypeStructs."""
    if isinstance(tree, dict):
        return {k: _sds(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape), _jdtype(tree))


def _specs(tree):
    """A tree of NamedShardings as spec tuples."""
    return jax.tree.map(lambda s: tuple(s.spec), tree,
                        is_leaf=lambda s: hasattr(s, "spec"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


# ---------------------------------------------------------------------------
# (i) the layouts, shapes only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_serving_layouts_match_jax(name):
    """Cache-leaf ``batch_shardings``, ``_out_tree_shardings`` and
    ``out_shardings_for`` equal JAX's at five meshes, global batch 4 and
    1, with and without ``kv_quant``; the port's cache shapes are JAX's
    ``cache_specs``."""
    jcfg, tcfg = jget_config(name), get_config(name)
    seq = 512
    want = _sds(tsteps._serve_batch(tcfg, ShapeConfig("c", "decode", seq, 4))
                ["cache"])
    got = jfactory.cache_specs(jcfg, 4, seq)
    assert jax.tree.map(lambda a: (a.shape, a.dtype), got) == \
        jax.tree.map(lambda a: (a.shape, a.dtype), want)
    for D, M in MESHES:
        amesh = AbstractMesh((D, M), ("data", "model"))
        sizes = dict(amesh.shape)
        rep = kv_tp_repeat(tcfg, M)
        for gb in (4, 1):
            for quant in (False, True):
                batch = tsteps._serve_batch(
                    tcfg, ShapeConfig("c", "decode", seq, gb),
                    kv_repeat=rep, kv_quant=quant)
                jbatch = _sds(batch)
                where = (name, D, M, gb, quant)
                assert tsh.batch_shardings(batch, sizes, global_batch=gb) \
                    == _specs(jsh.batch_shardings(jbatch, amesh,
                                                  global_batch=gb)), where
                logits = torch.empty((gb, tcfg.vocab_size), device="meta")
                got = tsteps._out_tree_shardings(
                    (logits, batch["cache"]), sizes, global_batch=gb)
                want = jsteps._out_tree_shardings(
                    (_sds(logits), jbatch["cache"]), amesh, global_batch=gb)
                assert got == _specs(want), where
            for kind in ("loss", "logits"):
                assert tsh.out_shardings_for(kind, sizes, global_batch=4) \
                    == tuple(jsh.out_shardings_for(kind, amesh,
                                                   global_batch=4).spec)


STEP_CASES = [("mixtral-8x7b", (2, 2), "prefill", 4, False),
              ("mixtral-8x7b", (2, 2), "decode", 4, False),
              ("gemma3-12b", (2, 2), "decode", 1, False),
              ("gemma3-12b", (1, 4), "decode", 1, False),
              ("phi3-medium-14b", (1, 4), "decode", 4, True),
              ("jamba-v0.1-52b", (4, 1), "decode", 4, False),
              ("whisper-tiny", (2, 1), "prefill", 4, False)]


@pytest.mark.parametrize("name,mesh,kind,gb,quant", STEP_CASES)
def test_step_layouts_match_jax(name, mesh, kind, gb, quant):
    """``make_prefill_step``/``make_decode_step``'s parameter, batch and
    output layouts equal those of JAX's two functions (the parameters' by JAX
    path, a port layer one period of JAX's stacked leaf); a decode's
    ``init_cache(..., mesh=)`` gives every rank the shapes and dtypes of its
    block of the step's cache (batch-first, sequence-parallel at global
    batch 1 on data 2, phi3's hd-over-"model" int8 cache)."""
    jcfg, tcfg = jget_config(name), get_config(name)
    amesh = AbstractMesh(mesh, ("data", "model"))
    fake = types.SimpleNamespace(shape=dict(amesh.shape))
    jshape = JShapeConfig("c", kind, 256, gb)
    tshape = ShapeConfig("c", kind, 256, gb)
    if kind == "prefill":
        _, _, (jp, jb), jout = jsteps.make_prefill_step(jcfg, amesh, jshape)
        _, _, (tp, tb), tout = tsteps.make_prefill_step(tcfg, fake, tshape)
    else:
        _, _, (jp, jb), jout = jsteps.make_decode_step(jcfg, amesh, jshape,
                                                       kv_quant=quant)
        _, tbatch, (tp, tb), tout = tsteps.make_decode_step(
            tcfg, fake, tshape, kv_quant=quant)
    assert tb == _specs(jb)
    assert tout == _specs(jout)
    jflat = _flat(_specs(jp))
    period = len(tcfg.block_pattern)
    for pname, spec in tp.items():
        path, stacked = tsh.jax_path(pname, period)
        assert spec == (jflat[path][1:] if stacked else jflat[path]), pname
    if kind == "prefill":
        return

    def shapes(t, spec, rank):
        if isinstance(t, dict):
            return {k: shapes(t[k], spec if spec is None else spec[k], rank)
                    for k in t}
        b = t if spec is None else tsh.block(t, spec, rank)
        return tuple(b.shape), b.dtype

    for r in range(mesh[0] * mesh[1]):
        rank = types.SimpleNamespace(shape=fake.shape, rank=r)
        got = init_cache(tcfg, gb, 256, "meta",
                         kv_repeat=kv_tp_repeat(tcfg, mesh[1]),
                         kv_quant=quant, mesh=rank)
        assert shapes(got, None, rank) == \
            shapes(tbatch["cache"], tb["cache"], rank), r


def _jax_route(jcfg, mesh, Bg, Sg):
    """The route JAX's ``_moe_apply_sharded`` traces at inference: "a2a"
    when its jaxpr holds an ``all_to_all``, "gather" when it gathers the
    expert weights, "local" otherwise."""
    E, d, f = jcfg.n_experts, jcfg.d_model, jcfg.d_ff
    sd = jax.ShapeDtypeStruct
    p = {"router": sd((d, E), jnp.float32),
         "w_gate": sd((E, d, f), jcfg.dtype), "w_up": sd((E, d, f),
                                                          jcfg.dtype),
         "w_down": sd((E, f, d), jcfg.dtype)}
    txt = str(jax.make_jaxpr(lambda p, x: jmoe._moe_apply_sharded(
        p, x, jcfg, 1.25, (mesh, ("data",), False)))(
        p, sd((Bg, Sg, d), jcfg.dtype)))
    if "all_to_all" in txt:
        return "a2a"
    return "gather" if "all_gather" in txt else "local"


@pytest.mark.parametrize("name", ["mixtral-8x7b", "dbrx-132b",
                                  "jamba-v0.1-52b"])
def test_moe_route_matches_jax(name):
    """At decode (one token a row, 8 rows) and at an 8192-token prefill a
    data shard, ``moe_route`` is the route JAX's sharded MoE takes."""
    jcfg, tcfg = jget_config(name), get_config(name)
    seen = set()
    for D, M in MESHES[1:]:
        amesh = AbstractMesh((D, M), ("data", "model"))
        for Bg, Sg in ((8, 1), (D, 8192)):
            got = tmoe.moe_route(tcfg, Bg * Sg // D, dict(amesh.shape))
            assert got == _jax_route(jcfg, amesh, Bg, Sg), (D, M, Bg, Sg)
            seen.add(got)
    assert "a2a" in seen


def test_mesh_past_model_1_refuses_mamba_xlstm_whisper():
    """(iii) The recurrent blocks and the encoder-decoder build at model 2
    (and at model 1), and ``make_step`` gives a training step for them as
    for an attention decoder; whisper-tiny builds at model 4 (its 6 heads
    whole on every rank), and xlstm-125m, once refused at the production
    mesh's model 16 (4 mLSTM/sLSTM heads over 16 ranks), builds there for
    serving and for training, its heads whole on every rank."""
    from repro_torch.models.factory import make_model
    for name in OTHERS:
        for shape in ({"data": 1, "model": 2}, {"data": 2, "model": 1}):
            cfg = get_config(name + "-reduced")
            assert callable(make_model(cfg, mesh=types.SimpleNamespace(
                shape=shape))["prefill"])
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2}, size=2,
                                 model=2, in_mesh=True)
    train = ShapeConfig("c", "train", 16, 2)
    for name in ("qwen1.5-0.5b",) + OTHERS:
        step = tsteps.make_step(get_config(name + "-reduced"), mesh, train)
        assert callable(step) and step.microbatches == 1
    assert callable(make_model(get_config("whisper-tiny"),
                               mesh=types.SimpleNamespace(
                                   shape={"data": 1, "model": 4}))["loss"])
    prod = types.SimpleNamespace(shape={"data": 16, "model": 16},
                                 size=256, model=16, in_mesh=True)
    xl = get_config("xlstm-125m")
    assert callable(make_model(xl, mesh=prod)["prefill"])
    step = tsteps.make_step(xl, prod, ShapeConfig("c", "train", 4096, 256))
    assert callable(step) and step.microbatches == 8


def test_block_and_assemble_round_trip():
    """Every rank's block of a (4, 6, 8) array under a spec, put back
    together, is the array; a rank's block is its slice in JAX's
    row-major device order."""
    x = np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8)
    sizes = {"data": 2, "model": 2}
    for spec in [("data", "model", None), (None, "data", "model"),
                 (("data",), None, None), (None, None, None),
                 (("data", "model"), None, None)]:
        blocks = [tsh.block(x, spec, types.SimpleNamespace(
            shape=sizes, rank=r)) for r in range(4)]
        np.testing.assert_array_equal(tsh.assemble(blocks, spec, sizes), x)
    b = tsh.block(x, ("data", "model", None), types.SimpleNamespace(
        shape=sizes, rank=1))
    np.testing.assert_array_equal(b, x[:2, 3:])


# ---------------------------------------------------------------------------
# (ii) one world of four gloo processes
# ---------------------------------------------------------------------------

def _case_cfgs(name, **kw):
    return cfgs(name, **dict(OVERRIDES.get(name, {}), **kw))


def _cases():
    """(tag, name, overrides, mesh, global batch, kv_quant, plain)."""
    out = []
    for name in DECODERS:
        for mesh in TP_MESHES:
            plain = mesh[1] == 1 and not get_config(name).n_experts
            out.append((f"{name}@{mesh}", name, {}, mesh, B, False, plain))
    for name in OTHERS:
        for mesh in DP_MESHES:
            out.append((f"{name}@{mesh}", name, {}, mesh, B, False,
                        name == "xlstm-125m"))
        for mesh in MODEL_MESHES:
            out.append((f"{name}@{mesh}", name, {}, mesh, B, False, False))
    out += [("hd-split@(2, 2)", "llama3-8b", HD_SPLIT, (2, 2), B, False,
             False),
            ("hd-split-int8@(1, 2)", "llama3-8b", HD_SPLIT, (1, 2), B, True,
             False),
            ("sp-gemma3@(2, 2)", "gemma3-12b", {}, (2, 2), 1, False, False),
            ("sp-mixtral@(2, 2)", "mixtral-8x7b", {}, (2, 2), 1, False,
             False),
            ("sp-whisper@(2, 2)", "whisper-tiny", {}, (2, 2), 1, False,
             False),
            ("odd-vocab-whisper@(1, 2)", "whisper-tiny", ODD_VOCAB, (1, 2),
             B, False, False)]
    out += [(f"whole-heads-{name}@(1, 4)", name, kw, (1, 4), B, False, False)
            for name, kw in WHOLE_HEADS.items()]
    out.append(("xlstm-2-heads@(1, 4)", "xlstm-125m", XLSTM_2_HEADS, (1, 4),
                B, False, False))
    return out



def _jax_run(jcfg, jp, toks, frames, kv_quant):
    """JAX's prefill of ``S`` tokens and ``STEPS`` decode steps (the
    position-indexed cache leaves grown with zeros first): every step's
    logits and the final cache."""
    Bg = toks.shape[0]
    t = jnp.asarray(toks)
    if jcfg.is_encoder_decoder:
        logits, cache = jax.jit(lambda p, x, f: jencdec.encdec_prefill(
            p, jcfg, x, f))(jp, t[:, :S], jnp.asarray(frames))
        dec = jax.jit(lambda p, x, c, pos: jencdec.encdec_decode(
            p, jcfg, x, c, pos))
    else:
        logits, cache = jax.jit(lambda p, x: jlm.lm_prefill(
            p, jcfg, x, kv_quant=kv_quant))(jp, t[:, :S])
        dec = jax.jit(lambda p, x, c, pos: jlm.lm_decode(p, jcfg, x, c,
                                                         pos))
    cache = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, STEPS)] +
                          [(0, 0)] * (a.ndim - 3))
        if a.ndim == 5 and a.shape[2] == S else a, cache)
    out = [np.asarray(logits)]
    for i in range(STEPS):
        logits, cache = dec(jp, t[:, S + i:S + i + 1], cache,
                            jnp.full((Bg,), S + i, jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out), jax.tree.map(np.asarray, cache)


@pytest.fixture(scope="module", autouse=True)
def world_started(tmp_path_factory):
    """The world and JAX's references, started in a thread before the
    file's first test, so that the layout tests run meanwhile."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_world, tmp_path_factory)


@pytest.fixture(scope="module")
def world(world_started):
    return world_started.result()


def _mamba_whole() -> dict:
    """One mamba layer of width 33 (inner 66) for (1, 4): its weights, a
    prompt of 40 tokens and 4 decode steps' inputs, from seeds."""
    from repro_torch.models import ssm
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b-reduced"),
                              **MAMBA_WHOLE)
    w = ssm.init_mamba(torch.Generator().manual_seed(3), cfg)
    return {"cfg": cfg, "mesh": (1, 4),
            "weights": {k: v.numpy() for k, v in w.items()},
            "x": normal((2, 40, cfg.d_model), seed=31),
            "xd": normal((STEPS, 2, 1, cfg.d_model), seed=32)}


def _world(tmp_path_factory):
    """The world's results beside JAX's, computed here while the world
    runs."""
    weights, payload_cases, jobs = {}, [], {}
    for tag, name, kw, mesh, gb, quant, plain in _cases():
        jcfg, tcfg = _case_cfgs(name, **kw)
        wkey = f"{name}{sorted(kw.items())}"
        if wkey not in weights:
            init = tencdec.init_encdec if tcfg.is_encoder_decoder else \
                tlm.init_lm
            p = init(torch.Generator().manual_seed(len(weights)), tcfg)
            weights[wkey] = lm_params_to_numpy(p, tcfg)
        toks = tokens(gb, S + STEPS, tcfg.vocab_size, seed=gb)
        case = {"tag": tag, "cfg": tcfg, "weights": wkey, "mesh": mesh,
                "B": gb, "S": S, "steps": STEPS, "tokens": toks,
                "kv_quant": quant, "plain": plain,
                "own": (name in OTHERS or tag.startswith("whole-heads"))
                and mesh[1] > 1}
        if tcfg.is_encoder_decoder:
            case["frames"] = normal((gb, tcfg.enc_positions, tcfg.d_model),
                                    seed=gb)
        payload_cases.append(case)
        jobs.setdefault((wkey, gb, quant), (jcfg, toks, case.get("frames"),
                                            []))[3].append(tag)
    # one MoE layer at top-2, its router scaled up from the 0.02 init so
    # that top-2 membership has wide margins
    jm, tm = cfgs("mixtral-8x7b", total_routing=False)
    layer = weights[f"mixtral-8x7b{[]}"]["blocks"]["pos0"]["moe"]
    layer = {k: np.array(v[0]) for k, v in layer.items()}
    layer["router"] = layer["router"] * np.float32(100.0)
    xs = [normal((B, n, tm.d_model), seed=n) for n in (40, 160)]
    payload = {"cases": payload_cases, "weights": weights,
               "moe": {"cfg": tm, "layer": layer, "xs": xs,
                       "mesh": (2, 2)}, "mamba_whole": _mamba_whole(),
               "refused": [(get_config(n + "-reduced"), (2, 2))
                           for n in OTHERS] +
               [(get_config("whisper-tiny"), (1, 4)),
                (_case_cfgs("xlstm-125m", **XLSTM_2_HEADS)[1], (1, 4))]}
    wait = start_world("tp_serve_world", 4, tmp_path_factory.mktemp("tp"),
                       payload)
    jw = {k: jax.tree.map(jnp.asarray, v) for k, v in weights.items()}
    jl = jax.tree.map(jnp.asarray, layer)
    moe_layer = jax.jit(lambda w, x: jmoe._dispatch_and_compute(w, x, jm,
                                                                1.25))

    def moe_ref(x):
        ys, auxes = [], []
        for d in range(2):                 # each data shard's own rows
            y, aux = moe_layer(jl, jnp.asarray(x[2 * d:2 * d + 2]))
            ys.append(np.asarray(y))
            auxes.append(np.float32(aux))
        return np.concatenate(ys), (auxes[0] + auxes[1]) / 2

    refs = {}
    with ThreadPoolExecutor(6) as pool:      # XLA compiles off the GIL
        moe_runs = [pool.submit(moe_ref, x) for x in xs]
        runs = {key: pool.submit(_jax_run, jcfg, jw[key[0]], toks, frames,
                                 key[2])
                for key, (jcfg, toks, frames, _) in jobs.items()}
    for key, (*_, tags) in jobs.items():
        refs.update({tag: runs[key].result() for tag in tags})
    moe_refs = [r.result() for r in moe_runs]
    ranks = wait()
    return {"ranks": ranks, "refs": refs, "moe": moe_refs,
            "cases": {c[0]: c for c in _cases()}, "weights": weights,
            "mamba": payload["mamba_whole"]}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rep(name, kw, mesh) -> int:
    """The case's KV-head repeat: ``kv_tp_repeat``'s for a decoder, none
    for the encoder-decoder (its prefill takes none, as JAX's)."""
    tcfg = _case_cfgs(name, **kw)[1]
    return 1 if tcfg.is_encoder_decoder else kv_tp_repeat(tcfg, mesh[1])


def _check_case(world, tag):
    _, name, kw, mesh, gb, quant, _ = world["cases"][tag]
    r0 = world["ranks"][0]
    logits, cache = world["refs"][tag]
    tol = TOL_INT8 if quant else TOL
    assert _rel(r0[f"{tag}/logits"], logits) < tol, tag
    rep = _rep(name, kw, mesh)
    for path, want in _flat(cache).items():
        got = r0[f"{tag}/cache/{path}"]
        if rep > 1 and path.endswith(("/k", "/v", "_scale")):
            want = np.repeat(want, rep, axis=3)      # jnp.repeat's order
        if want.dtype == np.int8:
            assert got.dtype == np.int8 and got.shape == want.shape, path
            assert np.abs(got.astype(np.int32) - want).max() <= 1, path
        else:
            assert _rel(got, want) < TOL, (tag, path)
    # every rank of the mesh rebuilt the same logits
    n = mesh[0] * mesh[1]
    for r in world["ranks"][1:n]:
        np.testing.assert_array_equal(r[f"{tag}/logits"], r0[f"{tag}/logits"])


@pytest.mark.parametrize("name", DECODERS)
@pytest.mark.parametrize("mesh", TP_MESHES)
def test_sharded_decoders_match_jax(world, name, mesh):
    """Prefill of 72 tokens (past the reduced window of 64: a local
    layer's cache is its ring) and 4 decode steps: every step's logits
    and the final cache."""
    _check_case(world, f"{name}@{mesh}")


@pytest.mark.parametrize("name", OTHERS)
@pytest.mark.parametrize("mesh", DP_MESHES)
def test_batch_split_of_the_others_matches_jax(world, name, mesh):
    """jamba (EP over "data"), xlstm and whisper at (P, 1)."""
    _check_case(world, f"{name}@{mesh}")


@pytest.mark.parametrize("name", OTHERS)
@pytest.mark.parametrize("mesh", MODEL_MESHES)
def test_tensor_parallel_others_match_jax(world, name, mesh):
    """jamba (mamba's inner blocks, attention heads, the expert-parallel
    MoE), xlstm (the mLSTM's and sLSTM's heads) and whisper (heads and ff)
    at model 2 and 4: every step's logits and the final cache against
    JAX's one-device ``lm_prefill``/``lm_decode`` and
    ``encdec_prefill``/``encdec_decode``."""
    _check_case(world, f"{name}@{mesh}")


def _jax_blocks(whole: dict, specs: dict, mesh, rank: int) -> dict:
    """{path: mesh rank ``rank``'s block of each whole leaf} by its spec
    in ``specs`` (a {path: spec} dict)."""
    at = types.SimpleNamespace(shape={"data": mesh[0], "model": mesh[1]},
                               rank=rank)
    return {k: tsh.block(v, specs[k], at) for k, v in whole.items()}


def _param_specs(name, kw, mesh, train: bool) -> dict:
    jcfg = _case_cfgs(name, **kw)[0]
    amesh = AbstractMesh(mesh, ("data", "model"))
    return _flat(_specs(jsh.params_shardings(jfactory.param_specs(jcfg),
                                             amesh, train=train)))


@pytest.mark.parametrize("name", OTHERS)
@pytest.mark.parametrize("mesh", MODEL_MESHES)
def test_others_rank_blocks_are_jax_blocks(world, name, mesh):
    """Each rank's parameters are its blocks of the whole weights by JAX's
    inference specs, bit for bit, and its final cache leaves are its blocks
    of JAX's cache by JAX's ``_cache_pspec`` (``batch_shardings``), within
    the logits' bound."""
    tag = f"{name}@{mesh}"
    _, _, kw, _, gb, _, _ = world["cases"][tag]
    wkey = f"{name}{sorted(kw.items())}"
    specs = _param_specs(name, kw, mesh, train=False)
    _, cache = world["refs"][tag]
    rep = _rep(name, kw, mesh)
    cache = {k: np.repeat(v, rep, axis=3) if rep > 1 and
             k.endswith(("/k", "/v")) else v for k, v in _flat(cache).items()}
    amesh = AbstractMesh(mesh, ("data", "model"))
    cspecs = _flat(_specs(jsh.batch_shardings(
        {"cache": jax.tree.map(lambda a: jax.ShapeDtypeStruct(
            a.shape, a.dtype), _unflat(cache))}, amesh,
        global_batch=gb)))
    cspecs = {k.removeprefix("cache/"): v for k, v in cspecs.items()}
    for r in range(mesh[0] * mesh[1]):
        rank = world["ranks"][r]
        got = {k[len(f"{tag}/own/params/"):]: v for k, v in rank.items()
               if k.startswith(f"{tag}/own/params/")}
        want = _jax_blocks(_flat(world["weights"][wkey]), specs, mesh, r)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape and \
                got[k].tobytes() == want[k].tobytes(), (tag, r, k)
        want = _jax_blocks(cache, cspecs, mesh, r)
        for k, w in want.items():
            g = rank[f"{tag}/own/cache/{k}"]
            assert g.shape == w.shape, (tag, r, k, g.shape, w.shape)
            assert _rel(g, w) < TOL, (tag, r, k)


def _unflat(flat: dict) -> dict:
    out = {}
    for k, v in flat.items():
        node = out
        *up, leaf = k.split("/")
        for u in up:
            node = node.setdefault(u, {})
        node[leaf] = v
    return out


def test_no_rank_holds_or_gathers_a_whole_weight(world):
    """At model > 1 no rank holds a whole ``w_in``, ``w_up`` or ``w_x``
    (each its 1/M of the columns), every parameter that JAX's rules cut
    over "model" is smaller on each rank than whole, and no gather of the
    steps along "model" takes a tensor of the shape of a rank's cut
    weight block: the blocks run tensor-parallel, never as whole weights
    (the MoE's expert weights gathered over "data" at a long prefill are
    the expert-parallel route, not this)."""
    seen = set()
    for tag, (_, name, kw, mesh, *_) in world["cases"].items():
        if name not in OTHERS or mesh[1] == 1:
            continue
        wkey = f"{name}{sorted(kw.items())}"
        whole = _flat(world["weights"][wkey])
        specs = _param_specs(name, kw, mesh, train=False)
        for r in range(mesh[0] * mesh[1]):
            rank = world["ranks"][r]
            gathered = {str(s) for s in rank[f"{tag}/gathered_shapes"]}
            for k, w in whole.items():
                got = rank[f"{tag}/own/params/{k}"]
                if k.endswith(("w_in", "w_up", "w_x")):
                    assert got.shape[-1] * mesh[1] == w.shape[-1], (tag, k)
                    seen.add(k.rsplit("/", 1)[-1])
                if "model" in specs[k]:
                    assert got.size < w.size, (tag, r, k)
                    assert str(tuple(got.shape[1:])) not in gathered and \
                        str(tuple(got.shape)) not in gathered, (tag, r, k)
    assert seen == {"w_in", "w_up", "w_x"}


@pytest.mark.parametrize("tag", ["sp-whisper@(2, 2)",
                                 "odd-vocab-whisper@(1, 2)"])
def test_whisper_sequence_parallel_and_whole_table(world, tag):
    """whisper's sequence-parallel decode (global batch 1 on data 2: the
    self-attention cache's sequence over "data", ``encoder_out`` whole on
    every rank), and a vocab of 509 at model 2, whose table JAX keeps
    whole: the whole-table lookup and the whole logits."""
    _check_case(world, tag)
    r0 = world["ranks"][0]
    if tag.startswith("sp-"):
        assert r0[f"{tag}/own/cache/encoder_out"].shape[0] == 1
        assert r0[f"{tag}/own/cache/self/k"].shape[2] == (S + STEPS) // 2
    else:
        assert r0[f"{tag}/own/params/embed/table"].shape[0] == 509


@pytest.mark.parametrize("tag", ["hd-split@(2, 2)", "hd-split-int8@(1, 2)"])
def test_hd_split_cache_matches_jax(world, tag):
    """6 query heads over 3 kv heads at model 2: the cache's heads do not
    divide the model axis, so it holds each rank's half of the head
    dimension; the partial scores are summed over "model".  In f32 and on
    an int8 cache (its scales whole on every rank)."""
    _check_case(world, tag)
    r0 = world["ranks"][0]
    assert r0[f"{tag}/cache/pos0/k"].shape[-1] == 16


@pytest.mark.parametrize("tag", ["sp-gemma3@(2, 2)", "sp-mixtral@(2, 2)"])
def test_sequence_parallel_decode_matches_jax(world, tag):
    """Global batch 1 on data 2: every rank holds the row, the caches'
    sequence (gemma3's local rings too) is sharded over "data", each new
    token is written by its slot's owner, and the partial softmax is
    combined across "data"; mixtral's MoE gathers its experts."""
    _check_case(world, tag)
    assert set(world["ranks"][0][f"{tag}/routes"]) <= {"gather", ""}


def test_dense_batch_split_is_one_device_bitwise(world):
    """At (P, 1) a dense decoder's logits and cache on each rank are the
    bits of one device's prefill and decode on the rank's rows."""
    seen = 0
    for tag, c in world["cases"].items():
        if not c[6]:
            continue
        for r in world["ranks"][:c[3][0]]:
            assert r[f"{tag}/plain_bitwise"].all(), tag
            seen += 1
    assert seen >= 2 * 6 * 3


def test_moe_routes_both_taken(world):
    """The whole-model MoE runs took the all-to-all route and the weight
    gather (by size: decode and short prefills a2a, a long prefill at
    model 2 gathers)."""
    taken = set()
    for tag, c in world["cases"].items():
        if get_config(c[1]).n_experts:
            taken |= set(world["ranks"][0][f"{tag}/routes"])
    assert {"a2a", "gather"} <= taken


@pytest.mark.parametrize("i,route", [(0, "a2a"), (1, "gather")])
def test_moe_layer_per_data_shard_matches_jax(world, i, route):
    """One MoE layer at top-2 on (2, 2): each data shard routes its own
    rows at its own capacity, as JAX's ``_dispatch_and_compute`` on those
    rows; the aux loss is the mean of the shards'."""
    r0 = world["ranks"][0]
    y, aux = world["moe"][i]
    assert list(r0[f"moe{i}/route"]) == [route]
    assert _rel(r0[f"moe{i}/y"], y) < TOL
    np.testing.assert_allclose(float(r0[f"moe{i}/aux"]), float(aux),
                               rtol=1e-6)


def test_mesh_collectives_along_each_axis(world):
    """The (2, 2) mesh: rank r is (r // 2, r % 2); the rank-order sum,
    the tiled all-gather, the broadcast and JAX's tiled all_to_all along
    "data", "model" and the whole mesh."""
    coords = {"data": lambda r: r // 2, "model": lambda r: r % 2}
    for r, got in enumerate(world["ranks"]):
        assert got["mesh/coords"].tolist() == [r // 2, r % 2]
        for axis in ("data", "model", None):
            name = axis or "mesh"
            if axis is None:
                peers = [0, 1, 2, 3]
            else:
                other = "model" if axis == "data" else "data"
                peers = [q for q in range(4)
                         if coords[other](q) == coords[other](r)]
            t = [np.arange(6, dtype=np.float32) + 10 * q for q in peers]
            np.testing.assert_array_equal(got[f"mesh/sum_{name}"], sum(t))
            np.testing.assert_array_equal(
                got[f"mesh/gather_{name}"],
                np.concatenate([x.reshape(2, 3) for x in t], axis=1))
            np.testing.assert_array_equal(got[f"mesh/bcast_{name}"], t[-1])
            n, me = len(peers), peers.index(r)
            xs = [np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3)
                  + 100 * q for q in peers]
            np.testing.assert_array_equal(
                got[f"mesh/a2a_{name}"],
                np.concatenate([x[me:me + 1] for x in xs], axis=1))


def test_refusals_on_the_mesh(world):
    """(iii) On the world's (2, 2) mesh the reduced jamba, xLSTM and
    whisper build, and on its (1, 4) mesh whisper-tiny (6 heads, whole on
    every rank) and a reduced xLSTM with 2 heads (once refused: its heads
    now run whole on every rank); nothing raises."""
    built = [str(m) for m in world["ranks"][0]["refused"]]
    assert built == [""] * (len(OTHERS) + 2)


def test_xlstm_whole_heads_match_jax(world):
    """A reduced xLSTM's 2 mLSTM/sLSTM heads over model 4 (xlstm-125m's 4
    at model 16): each rank holds JAX's blocks (a quarter of the columns
    of ``w_q``/``w_k``/``w_v``/``w_x``, ``b_i``/``b_f``/``r`` whole),
    computes every head, and keeps JAX's cache blocks (``C``'s key block
    of 64 / 4 rows, the other states whole); prefill and 4 decode steps
    against JAX's one device (1e-5)."""
    tag = "xlstm-2-heads@(1, 4)"
    _check_case(world, tag)
    specs = _param_specs("xlstm-125m", XLSTM_2_HEADS, (1, 4), train=False)
    wkey = f"xlstm-125m{sorted(XLSTM_2_HEADS.items())}"
    for r in range(4):
        rank = world["ranks"][r]
        got = {k[len(f"{tag}/own/params/"):]: v for k, v in rank.items()
               if k.startswith(f"{tag}/own/params/")}
        want = _jax_blocks(_flat(world["weights"][wkey]), specs, (1, 4), r)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
        assert got["blocks/pos0/core/w_q"].shape[-1] == 128 // 4
        assert got["blocks/pos0/core/b_i"].shape[-1] == 2
        assert rank[f"{tag}/own/cache/pos0/C"].shape[-2:] == (64 // 4, 64)
        assert rank[f"{tag}/own/cache/pos1/h"].shape[-2:] == (2, 32)


def test_mamba_inner_width_whole_on_every_rank(world):
    """One mamba layer of inner width 66 at model 4: the inner leaves
    whole on every rank (JAX's ``_guard``), ``w_in``'s 132 columns cut
    and its product gathered whole; the prefill of 40 tokens, 4 decode
    steps and the cache, and the gradients of a loss on ``mamba_fwd``
    (gathered whole), against the port's one device (1e-5 of each
    leaf's largest; that path is held to JAX in tests/test_torch_ssm.py)."""
    from repro_torch.models import ssm
    m = world["mamba"]
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b-reduced"),
                              **MAMBA_WHOLE)
    w = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in m["weights"].items()}
    x, xd = torch.from_numpy(m["x"]), torch.from_numpy(m["xd"])
    ssm.mamba_fwd(w, x, cfg).square().sum().backward()
    with torch.no_grad():
        out, cache = ssm.mamba_prefill(w, x, cfg)
        outs = [out]
        for i in range(STEPS):
            out, cache = ssm.mamba_decode(w, xd[i], cfg, cache)
            outs.append(out)
    for r in range(4):
        got = world["ranks"][r]
        assert got["mamba_whole/w_in_cols"] == 132 // 4
        assert got["mamba_whole/conv_w_cols"] == 66
        for i, o in enumerate(outs):
            assert _rel(got[f"mamba_whole/out{i}"], o.numpy()) < TOL, i
        for k, t in cache.items():
            assert _rel(got[f"mamba_whole/cache/{k}"], t.numpy()) < TOL, k
        for k, t in w.items():
            assert _rel(got[f"mamba_whole/grad/{k}"], t.grad.numpy()) \
                < TOL, k


@pytest.mark.parametrize("name", list(WHOLE_HEADS))
def test_whole_heads_match_jax(world, name):
    """Query heads that do not divide model 4 (whisper's 6, a GQA
    decoder's 6 over 2 kv heads): every rank holds ``wq``/``wk``/``wv``/
    ``wo`` whole, as JAX's ``_guard`` leaves them, and computes all heads
    beside the ff-sharded MLP and the hd-over-"model" cache; prefill and
    4 decode steps against JAX's one device (1e-5), the cache's head
    dimension a rank's quarter."""
    tag = f"whole-heads-{name}@(1, 4)"
    _check_case(world, tag)
    r0 = world["ranks"][0]
    wq = [k for k in r0 if k.startswith(f"{tag}/own/params/")
          and k.endswith("attn/wq")]
    assert wq and all(r0[k].shape[-2] == 6 for k in wq), wq
    k = "self/k" if name == "whisper-tiny" else "pos0/k"
    assert r0[f"{tag}/own/cache/{k}"].shape[-1] == 16 // 4
