"""The port's launch harness against the JAX package on the CPU: the cost
book and the analytic counts, the configuration helpers and specs, the
LargeVis production-cell steps, and the serve command line.

* ``models/costbook.py``: the entries the port records while a reduced
  model's loss runs (on the meta device) are JAX's, traced under
  ``jax.eval_shape``, label for label with the same totals and trips,
  once for each period (JAX traces its scanned period once, the port runs
  every layer); the five ``*_flops``, ``param_count``,
  ``active_param_count`` and ``cell_applicable`` equal JAX's for the ten
  full configurations and the four shapes.
* ``input_specs``, ``kv_cache_specs``, ``param_specs`` and
  ``cache_specs``: shapes and dtypes JAX's, for the full configurations
  (a port layer one period of JAX's stacked leaf).
* ``launch/steps.py``'s four LargeVis builders: their arguments' shapes
  and dtypes JAX's, their per-rank blocks JAX's per-device shard shapes
  on both production meshes; one call of a local-SGD builder bitwise one
  round of ``run_layout_local_sgd`` at world 1 and at world 2 over gloo
  (a world of two processes, ``tests/torch_dist_ranks.py``); the
  transform step bitwise the projection engine's lockstep step on the
  same draws; a fit from the local builder's rounds reaching JAX's
  quality bar (``tests/test_distributed.py``: 5-NN accuracy > 0.7); the
  global step's first call demoting a failing fused kernel to the split
  route (``run_layout``'s contract).
* ``launch/serve.py::main`` on ``--device cpu``: JAX's seeded requests,
  each served to its length.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_applicable as jcell_applicable
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import costbook as jcostbook
from repro.models import factory as jfactory
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.configs import (ARCH_NAMES, SHAPES, all_configs,
                                 cell_applicable, get_config, input_specs,
                                 kv_cache_specs)
from repro_torch.configs.largevis_default import LargeVisConfig
from repro_torch.core import layout, layout_engine, sampler
from repro_torch.launch import serve, steps
from repro_torch.launch import serve_projection as sp
from repro_torch.launch.mesh import make_data_mesh, make_production_mesh
from repro_torch.models import attention, costbook, layers, moe, ssm, xlstm
from repro_torch.models.factory import (F32_MATRICES, cache_specs,
                                        make_model, param_specs)
from repro_torch.runtime import sharding as tsh
from torch_dist_ranks import run_world
from torch_lm_parity import cfgs
from torch_threads import few_threads


def _jdtype(t):
    return jnp.dtype(str(t.dtype).removeprefix("torch."))


def _shapes(tree):
    """{path: (shape, dtype name)} of a tree of meta tensors or JAX
    ShapeDtypeStructs."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            dt = _jdtype(t) if torch.is_tensor(t) else jnp.dtype(t.dtype)
            out["/".join(path)] = (tuple(t.shape), dt.name)

    walk(tree, ())
    return out


@pytest.fixture(scope="module")
def jax_param_specs():
    """JAX's ``param_specs`` of the ten full configurations, once."""
    return {n: jfactory.param_specs(jget_config(n)) for n in ARCH_NAMES}


# ---------------------------------------------------------------------------
# the cost book and the analytic counts
# ---------------------------------------------------------------------------

# (arch, sequence): attention past 2048 tokens (the flash path, JAX's
# mha_chunked), mamba's 256-token chunks, the xLSTM's token recurrences
BOOK_CASES = [("llama3-8b", 4096), ("jamba-v0.1-52b", 4096),
              ("xlstm-125m", 16), ("whisper-tiny", 4096)]


def _entries(book):
    return [(e.label, e.total_flops, e.total_bytes, e.trips)
            for e in book.entries]


@pytest.mark.parametrize("name,S", BOOK_CASES)
def test_costbook_entries_match_jax(name, S):
    """The loss of the reduced config over a (1, S) batch: the port's
    entries (run on the meta device) are JAX's (its loss traced under
    ``jax.eval_shape``), repeated once a period; labels, totals and
    trips equal, and the book's corrections with them."""
    jcfg, tcfg = cfgs(name, total_routing=False)
    jb = {"tokens": jax.ShapeDtypeStruct((1, S), jnp.int32),
          "labels": jax.ShapeDtypeStruct((1, S), jnp.int32)}
    tb = {"tokens": torch.empty((1, S), dtype=torch.int32, device="meta"),
          "labels": torch.empty((1, S), dtype=torch.int32, device="meta")}
    if tcfg.is_encoder_decoder:
        shape = (1, tcfg.enc_positions, tcfg.d_model)
        jb["encoder_frames"] = jax.ShapeDtypeStruct(shape, jnp.float32)
        tb["encoder_frames"] = torch.empty(shape, device="meta")
    with jcostbook.recording() as jbook:
        jax.eval_shape(jfactory.make_model(jcfg)["loss"],
                       jfactory.param_specs(jcfg), jb)
    with torch.no_grad(), costbook.recording() as tbook:
        make_model(tcfg)["loss"](param_specs(tcfg), tb)
    reps = tcfg.n_layers if tcfg.is_encoder_decoder else tcfg.n_periods
    assert _entries(jbook) and _entries(tbook) == _entries(jbook) * reps
    assert tbook.flops_correction == pytest.approx(
        jbook.flops_correction * reps, rel=1e-12)
    assert tbook.bytes_correction == pytest.approx(
        jbook.bytes_correction * reps, rel=1e-12)


def test_record_is_a_noop_outside_recording():
    costbook.record("x", 1.0, 1.0, 4)
    with costbook.recording() as book:
        costbook.record("one trip", 1.0, 1.0, 1)
        with costbook.recording() as inner:
            costbook.record("inner", 2.0, 3.0, 4)
        costbook.record("outer", 2.0, 3.0, 4, per_layer_mult=2)
    assert _entries(inner) == [("inner", 2.0, 3.0, 4)]
    assert _entries(book) == [("outer", 4.0, 6.0, 4)]
    assert book.flops_correction == 3.0 and book.bytes_correction == 4.5


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_counts_and_cells_match_jax(name):
    """The five ``*_flops``, ``param_count``, ``active_param_count`` and
    ``cell_applicable`` of the full configuration equal JAX's, at the four
    shapes' token counts."""
    jcfg, tcfg = jget_config(name), get_config(name)
    assert all_configs()[name] is tcfg
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    for shape in SHAPES:
        assert cell_applicable(tcfg, SHAPES[shape]) == \
            jcell_applicable(jcfg, JSHAPES[shape])
        B, S = SHAPES[shape].global_batch, SHAPES[shape].seq_len
        n = B * S
        for train in (True, False):
            assert attention.attention_flops(tcfg, B, S, S, train=train) == \
                jattn.attention_flops(jcfg, B, S, S, train=train)
        if tcfg.d_ff:
            assert layers.mlp_flops(tcfg.d_model, tcfg.d_ff, tcfg.mlp_type,
                                    n) == \
                jlayers.mlp_flops(jcfg.d_model, jcfg.d_ff, jcfg.mlp_type, n)
        if tcfg.n_experts:
            assert moe.moe_flops(tcfg, n) == jmoe.moe_flops(jcfg, n)
        assert ssm.mamba_flops(tcfg, n) == jssm.mamba_flops(jcfg, n)
        for kind in ("mlstm", "slstm"):
            assert xlstm.xlstm_flops(tcfg, n, kind) == \
                jxlstm.xlstm_flops(jcfg, n, kind)


# ---------------------------------------------------------------------------
# the specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_specs_match_jax(name, jax_param_specs):
    """``param_specs`` (a port layer one period of JAX's stacked leaf;
    cast for serving, the matrices JAX casts to the compute dtype, but
    ``factory.F32_MATRICES``, which the port reads in f32); the inputs of
    the four shapes (``input_specs``) and a decode cell's cache
    (``kv_cache_specs``, ``cache_specs``) against JAX's, shapes and
    dtypes."""
    jcfg, tcfg = jget_config(name), get_config(name)
    want = _shapes(jax_param_specs[name])
    period = len(tcfg.block_pattern)
    for inference in (False, True):
        tree = param_specs(tcfg, inference=inference)
        seen = {}
        for pname, p in tree.named_parameters():
            assert p.device.type == "meta"
            path, stacked = tsh.jax_path(pname, period)
            shape, dtype = want[path]
            assert tuple(p.shape) == shape[int(stacked):], pname
            seen[path] = seen.get(path, 0) + 1
            if not inference or p.dim() < 2:
                assert _jdtype(p).name == dtype, pname
            elif pname.rsplit(".", 1)[-1] in F32_MATRICES:
                assert p.dtype == torch.float32, pname
            else:
                assert p.dtype == tcfg.dtype, pname
        assert sorted(seen) == sorted(want)
        for path, count in seen.items():
            stacked = "blocks/" in path or "_layers/" in path
            assert count == (want[path][0][0] if stacked else 1), path
    for shape in SHAPES:
        ok, _ = cell_applicable(tcfg, SHAPES[shape])
        if SHAPES[shape].kind == "decode" and shape != "decode_32k":
            continue                 # one decode cache a config (below)
        got = _shapes(input_specs(tcfg, SHAPES[shape]))
        assert got == _shapes(jinput_specs(jcfg, JSHAPES[shape])), shape
    B, T = 4, 1024
    jcache = _shapes(jfactory.cache_specs(jcfg, B, T))
    assert _shapes(kv_cache_specs(tcfg, B, T)) == jcache
    assert _shapes(cache_specs(tcfg, B, T)) == jcache


# ---------------------------------------------------------------------------
# the LargeVis production-cell steps
# ---------------------------------------------------------------------------

LV_SHAPES = [dict(n_nodes=4_000_000, n_edges=600_000_000, batch=1 << 20),
             dict(n_nodes=1_000, n_edges=6_000, batch=512)]
TRANSFORM = dict(n_corpus=100_000, n_slots=1024, k=150)


def _jax_meshes():
    return [(AbstractMesh((16, 16), ("data", "model")), False),
            (AbstractMesh((2, 16, 16), ("pod", "data", "model")), True)]


def _check_builder(tb, jb, mesh):
    _, targs, tin, tout = tb
    _, jargs, jin, jout = jb
    assert [(tuple(a.shape), _jdtype(a)) for a in targs] == \
        [(tuple(a.shape), jnp.dtype(a.dtype)) for a in jargs]
    assert list(tin) == [tuple(s.shard_shape(a.shape))
                         for s, a in zip(jin, jargs)]
    assert tuple(tout) == tuple(jout.shard_shape(jargs[0].shape))


@pytest.mark.parametrize("spec", LV_SHAPES, ids=["layout_4m", "small"])
def test_largevis_builders_match_jax(spec):
    """Each builder's argument shapes and dtypes are JAX's, and its
    blocks JAX's per-device shard shapes, on the single- and the
    multi-pod production mesh (the pod axis folded into the data axis)."""
    for jmesh, multi in _jax_meshes():
        tmesh = make_production_mesh(multi_pod=multi)
        for tb_fn, jb_fn in ((steps.make_largevis_step,
                              jsteps.make_largevis_step),
                             (steps.make_largevis_step_local,
                              jsteps.make_largevis_step_local),
                             (steps.make_largevis_step_sharded,
                              jsteps.make_largevis_step_sharded)):
            kw = dict(spec)
            if tb_fn is steps.make_largevis_step_sharded:
                kw["n_edges"] += (-kw["n_edges"]) % tmesh.shape["data"]
            _check_builder(tb_fn(tmesh, **kw), jb_fn(jmesh, **kw), tmesh)
        _check_builder(
            steps.make_largevis_transform_step(tmesh, **TRANSFORM),
            jsteps.make_largevis_transform_step(jmesh, **TRANSFORM), tmesh)


def test_sharded_builder_refuses_as_jax():
    mesh = make_production_mesh()
    for kw in (dict(n_nodes=1000, n_edges=6001, batch=64),
               dict(n_nodes=8, n_edges=6000, batch=64)):
        with pytest.raises(ValueError) as te:
            steps.make_largevis_step_sharded(mesh, **kw)
        with pytest.raises(ValueError) as je:
            jsteps.make_largevis_step_sharded(
                AbstractMesh((16, 16), ("data", "model")), **kw)
        assert str(te.value) == str(je.value)


def _graph(n=512, K=8, seed=0):
    rng = np.random.default_rng(seed)
    knn = rng.integers(0, n, (n, K)).astype(np.int32)
    w = (rng.random((n, K)) + 0.05).astype(np.float32)
    return knn, w


# one round of 8 steps of 64 edges at world 1 (512 nodes, 1 sample a node)
ROUND_CFG = LargeVisConfig(samples_per_node=1, batch_size=64, sync_every=8,
                           steps_per_dispatch=8)


def test_local_round_is_the_fit_at_world_1():
    """At world 1 ``run_layout_local_sgd`` is ``run_layout``: its 8 steps
    (one chunk) are one call of the local builder on the flat samplers,
    from the same start, stream and lrs, bitwise; so is one call of the
    global step against the fit's first step."""
    knn, w = map(torch.from_numpy, _graph())
    n, K = knn.shape
    es = sampler.build_edge_sampler(knn, w)
    ns = sampler.build_negative_sampler(knn, w)
    mesh = make_data_mesh(1, device="cpu")
    cfg = ROUND_CFG
    fit = layout.run_layout_local_sgd(torch.Generator().manual_seed(5), es,
                                      ns, n, cfg, mesh)
    assert fit.steps == cfg.sync_every
    gen = _after_init(5, n, cfg)
    y = torch.randn((n, 2), generator=torch.Generator().manual_seed(5)) * \
        cfg.init_scale
    y_init = y.clone()
    lrs = layout_engine.lr_table(cfg.rho0, fit.steps, "cpu")
    tables = (es.src, es.dst, es.threshold, es.alias, ns.threshold, ns.alias)
    step, *_ = steps.make_largevis_step_local(
        mesh, n_nodes=n, n_edges=n * K, batch=cfg.batch_size,
        sync_every=cfg.sync_every)
    step(y, torch.tensor([0], dtype=torch.int32), None, *tables,
         generator=gen, lrs=lrs)
    assert torch.equal(y, fit.y)
    one, *_ = steps.make_largevis_step(mesh, n_nodes=n, n_edges=n * K,
                                       batch=cfg.batch_size)
    y1 = one(y_init.clone(), torch.tensor([0], dtype=torch.int32), None,
             *tables, generator=_after_init(5, n, cfg), lr=lrs[0])
    want = layout_engine.sgd_edge_step(
        y_init.clone(), _after_init(5, n, cfg), edge_sampler=es,
        neg_sampler=ns, n_negatives=cfg.n_negatives, batch=cfg.batch_size,
        lr=lrs[0])
    assert torch.equal(y1, want) and not torch.equal(y1, y_init)


def test_global_step_demotes_a_failing_fused_kernel(monkeypatch):
    """``run_layout``'s contract on the global builder's first call: a
    fused kernel that fails there leaves y and the stream as they were,
    warns once, and the step (that call and the later ones) runs on the
    split route, bitwise the split route's steps."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.fault_tolerance import DegradedModeWarning

    knn, w = map(torch.from_numpy, _graph())
    n, K = knn.shape
    es = sampler.build_edge_sampler(knn, w)
    ns = sampler.build_negative_sampler(knn, w)
    tables = (es.src, es.dst, es.threshold, es.alias, ns.threshold, ns.alias)
    step, *_ = steps.make_largevis_step(make_data_mesh(1, device="cpu"),
                                        n_nodes=n, n_edges=n * K, batch=64)

    def broken(*a, **kw):
        raise RuntimeError("no kernel image for the card")

    monkeypatch.setattr(ops, "largevis_edge_step", broken)
    y = torch.randn((n, 2), generator=torch.Generator().manual_seed(1))
    want = y.clone()
    gen, ref = (torch.Generator().manual_seed(2) for _ in range(2))
    with pytest.warns(DegradedModeWarning):
        step(y, None, None, *tables, generator=gen, lr=torch.tensor(0.5))
    step(y, None, None, *tables, generator=gen, lr=torch.tensor(0.4))
    for lr in (0.5, 0.4):
        layout_engine.sgd_edge_step(
            want, ref, edge_sampler=es, neg_sampler=ns, n_negatives=5,
            batch=64, layout_step="split", lr=torch.tensor(lr))
    assert torch.equal(y, want)


def _after_init(seed: int, n: int, cfg) -> torch.Generator:
    """A generator seeded with ``seed`` past the layout's start draw."""
    gen = torch.Generator().manual_seed(seed)
    torch.randn((n, cfg.out_dim), generator=gen)
    return gen


def test_local_rounds_are_the_fit_at_world_2(tmp_path):
    """At world 2 over gloo, one round of ``run_layout_local_sgd`` (the
    edge tables of ``build_samplers_sharded``) is one call of the sharded
    builder (with the round's two-level negative sampler) and of the local
    builder (the rank's rows flattened, with the flat negative sampler),
    bitwise on both ranks, and the ranks' layouts are equal."""
    knn, w = _graph()
    cfg = dataclasses.replace(ROUND_CFG, samples_per_node=2)   # 8 steps
    ranks = run_world("largevis_round_world", 2, tmp_path,
                      {"cfg": cfg, "knn": knn, "w": w, "seed": 5})
    for name in ("sharded", "local"):
        assert int(ranks[0][f"steps_{name}"]) == cfg.sync_every
        for r in ranks:
            np.testing.assert_array_equal(r[name], r[f"fit_{name}"])
            np.testing.assert_array_equal(r[name], ranks[0][name])


def test_transform_step_is_the_engines_lockstep_step():
    """One call of the transform builder's step is
    ``serve_projection._lockstep_apply`` on ``sample_query_edges``'s draws
    from the same generator, with the engine's lr table: the slots'
    rows and ages bitwise, the corpus rows held, idle slots still."""
    from repro_torch.core.transform import sample_query_edges

    rng = np.random.default_rng(3)
    N, S, k, M = 300, 16, 10, 5
    y = torch.from_numpy(rng.standard_normal((N + S, 2)).astype(np.float32))
    p = torch.from_numpy(rng.random((S, k)).astype(np.float32))
    p = p / p.sum(1, keepdim=True)
    nn_idx = torch.from_numpy(rng.integers(0, N, (S, k)).astype(np.int32))
    ages = torch.from_numpy(rng.integers(0, 60, S).astype(np.int32))
    active = torch.from_numpy((rng.random(S) < 0.7).astype(np.int32))
    ns = sampler.build_negative_sampler(*map(torch.from_numpy, _graph(N)))
    step, *_ = steps.make_largevis_transform_step(
        make_data_mesh(1, device="cpu"), n_corpus=N, n_slots=S, k=k)
    y1, a1 = y.clone(), ages.clone()
    step(y1, torch.tensor([9], dtype=torch.int32), p, nn_idx, a1, active,
         ns.threshold, ns.alias, generator=torch.Generator().manual_seed(9))
    y2, a2 = y.clone(), ages.clone()
    gen = torch.Generator().manual_seed(9)
    j, negs, mask = sample_query_edges(gen, p, nn_idx, ns, M)
    sp._lockstep_apply(y2, N + torch.arange(S, dtype=torch.int32), j, negs,
                       mask, a2, active.bool(), sp.slot_lr_table(1.0, 48,
                                                                 "cpu"),
                       n_frozen=N)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    assert torch.equal(y1[:N], y[:N])
    idle = N + torch.nonzero(active == 0)[:, 0]
    assert torch.equal(y1[idle], y[idle])
    assert not torch.equal(y1, y)


def test_local_builder_fit_reaches_jax_quality_bar():
    """A fit from the local builder's rounds at world 1 on JAX's fixture
    of ``tests/test_distributed.py`` (1,500 points of 6 clusters in 24
    dimensions; K 12, perplexity 8, 1,500 samples a node, batch 1,024,
    H 8): 5-NN accuracy of the layout above JAX's bar of 0.7."""
    from repro_torch.core.largevis import build_graph
    from repro_torch.core.metrics import knn_classifier_accuracy
    from repro_torch.data.synthetic import gaussian_mixture

    x, labels = gaussian_mixture(1, 1500, 24, 6)
    cfg = LargeVisConfig(n_neighbors=12, n_trees=4, n_explore_iters=2,
                         window=32, perplexity=8.0, samples_per_node=1500,
                         batch_size=1024, sync_every=8)
    with few_threads():
        idx, _, w, _ = build_graph(x, cfg=cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(2))
        es = sampler.build_edge_sampler(idx, w)
        ns = sampler.build_negative_sampler(idx, w)
        n = x.shape[0]
        batch = layout._collision_capped_batch(cfg.batch_size, n)
        total = cfg.samples_per_node * n // batch
        H = cfg.sync_every
        lrs = layout_engine.lr_table(cfg.rho0, total, "cpu")
        step, *_ = steps.make_largevis_step_local(
            make_data_mesh(1, device="cpu"), n_nodes=n, n_edges=es.n_edges,
            batch=batch, sync_every=H)
        gen = torch.Generator().manual_seed(3)
        y = torch.randn((n, 2), generator=gen) * cfg.init_scale
        tables = (es.src, es.dst, es.threshold, es.alias, ns.threshold,
                  ns.alias)
        for r in range(total // H):
            step(y, torch.tensor([0], dtype=torch.int32), None, *tables,
                 generator=gen, lrs=lrs[r * H:(r + 1) * H])
    assert torch.isfinite(y).all()
    acc = knn_classifier_accuracy(y, torch.from_numpy(labels), k=5)
    assert acc > 0.7, acc


# ---------------------------------------------------------------------------
# the serve command line
# ---------------------------------------------------------------------------

def test_serve_cli_on_the_cpu(capsys):
    """``main`` serves JAX's ``main``'s requests (numpy's seeded prompts
    of 4-11 tokens, 12 new tokens each) with the reduced model, 4 slots
    and ``max_len`` 64, on the CPU when asked; on the card by default,
    which raises here."""
    reqs = serve.main(["--device", "cpu"])
    rng = np.random.default_rng(0)
    vocab = get_config("qwen1.5-0.5b").reduced().vocab_size
    for r in reqs:
        assert r.prompt == rng.integers(0, vocab, rng.integers(4, 12)
                                        ).tolist()
        assert len(r.out) == 12 and all(0 <= t < vocab for t in r.out)
    assert len(reqs) == 8 and "served 8 requests, 96 tokens" in \
        capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main([])
