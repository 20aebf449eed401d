"""The port's dry run (``launch/dryrun.py``) against the JAX package's
production shardings, on the CPU.

Cells of the single-pod production mesh (data 16, model 16), each run
once for the file (mesh rank 0's step on the meta device, on a recording
mesh): qwen1.5-0.5b ``train_4k``, llama3-8b ``decode_32k``,
jamba-v0.1-52b ``long_500k``, phi3-medium-14b ``prefill_32k`` (40 query
heads, whole on every rank at model 16) and LargeVis ``layout_4m``.
Their bytes a rank equal the sums over JAX's per-device shard shapes
(``NamedSharding.shard_shape`` on an ``AbstractMesh`` of the same shape):
the training parameters and both moments (f32), the served parameters
(JAX's element counts at the port's serving dtypes: ``F32_MATRICES`` stay
f32, JAX casts them), the decode cache and the prefill's output cache,
the LargeVis step's inputs.  A training cell records its collectives and
the flash regions' cost-book entries, and its flops are its
microbatches' (``run_body_cell``'s ``micro`` body times ``n_micro``,
exactly, for qwen and xlstm-125m); xlstm-125m at model 16 (its heads
whole on every rank) is ``ok``; qwen's ``long_500k`` is ``skipped`` with
JAX's reason; ``all_cells`` lists JAX's cells.  A decode cell under
``REPRO_KV_QUANT`` counts JAX's int8 cache and scales a rank; ``--all``
keeps the records it finds.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.launch import steps as jsteps
from repro.models import factory as jfactory
from repro.models.attention import kv_tp_repeat as jkv_tp_repeat
from repro.runtime import sharding as jsh
from repro_torch.launch import dryrun
from repro_torch.models.factory import F32_MATRICES

CELLS = [("qwen1.5-0.5b", "train_4k"), ("llama3-8b", "decode_32k"),
         ("jamba-v0.1-52b", "long_500k"), ("phi3-medium-14b", "prefill_32k"),
         ("largevis", "layout_4m"), ("xlstm-125m", "train_4k"),
         ("qwen1.5-0.5b", "long_500k")]
TRAIN_BODIES = ("qwen1.5-0.5b", "xlstm-125m")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    recs = {(a, s): dryrun.run_cell(a, s, "single", out, quiet=True)
            for a, s in CELLS}
    for (a, s), rec in recs.items():
        assert json.loads((out / f"{a}__{s}__single.json").read_text()) \
            == rec
    for a in TRAIN_BODIES:
        recs[(a, "train_4k", "body")] = dryrun.run_body_cell(
            a, "train_4k", "single", out, quiet=True, bodies=("micro",))
    return recs


def _amesh():
    return AbstractMesh((16, 16), ("data", "model"))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def _shard_elements(specs, shardings) -> dict:
    """{path: elements of one device's shard}."""
    sh = _flat(shardings)
    return {p: int(np.prod(sh[p].shard_shape(s.shape)))
            for p, s in _flat(specs).items()}


def _bytes(specs, shardings) -> int:
    sizes = _shard_elements(specs, shardings)
    flat = _flat(specs)
    return sum(n * flat[p].dtype.itemsize for p, n in sizes.items())


def _served_bytes(jcfg) -> tuple:
    """(elements, bytes at the port's serving dtypes) of one device's
    shards of JAX's served parameters."""
    specs = jfactory.param_specs(jcfg)
    sizes = _shard_elements(specs, jsh.params_shardings(specs, _amesh(),
                                                        train=False))
    flat = _flat(specs)
    n_bytes = 0
    for path, n in sizes.items():
        f32 = len(flat[path].shape) < 2 + ("blocks/" in path or
                                           "_layers/" in path) or \
            path.rsplit("/", 1)[-1] in F32_MATRICES
        n_bytes += n * (4 if f32 else jnp.dtype(jcfg.dtype).itemsize)
    return sum(sizes.values()), n_bytes


def test_train_cell_bytes_match_jax(records):
    """qwen ``train_4k``: the rank's f32 parameter blocks by the training
    rules and both moments; the step ran its 8 microbatches, gathering
    over "data" and summing over "model", with one ``mha_chunked`` entry
    a layer a microbatch in the forward and one in the backward's
    recompute."""
    rec = records[("qwen1.5-0.5b", "train_4k")]
    assert rec["status"] == "ok", rec
    jcfg = jget_config("qwen1.5-0.5b")
    specs = jfactory.param_specs(jcfg)
    want = _bytes(specs, jsh.params_shardings(specs, _amesh(), train=True))
    assert rec["bytes"]["params"]["bytes"] == want
    assert rec["bytes"]["moments"]["bytes"] == 2 * want
    assert rec["microbatches"] == 8
    kinds = set(rec["collectives"])
    assert {"all_gather:data", "reduce_scatter:data",
            "all_reduce:model"} <= kinds, kinds
    labels = [e["label"] for e in rec["costbook"]]
    assert labels == ["mha_chunked"] * (jcfg.n_layers * 8 * 2)
    assert rec["flops"] > 0


@pytest.mark.parametrize("arch,shape", [("llama3-8b", "decode_32k"),
                                        ("jamba-v0.1-52b", "long_500k")])
def test_decode_cell_bytes_match_jax(records, arch, shape):
    """A decode cell: the served parameter blocks and the cache's blocks
    (batch 128 over "data", or at batch 1 the sequence over "data") of
    JAX's ``batch_shardings``."""
    rec = records[(arch, shape)]
    assert rec["status"] == "ok", rec
    jcfg = jget_config(arch)
    n, n_bytes = _served_bytes(jcfg)
    assert rec["bytes"]["params"] == {"elements": n, "bytes": n_bytes}
    shape_cfg = JSHAPES[shape]
    batch = jinput_specs(jcfg, shape_cfg,
                         kv_repeat=jkv_tp_repeat(jcfg, 16))
    cache = jsh.batch_shardings(batch, _amesh(),
                                global_batch=shape_cfg.global_batch)["cache"]
    assert rec["bytes"]["cache"]["bytes"] == _bytes(batch["cache"], cache)


def test_prefill_cell_bytes_match_jax(records):
    """phi3 ``prefill_32k``: its 40 query heads whole on every rank at
    model 16, the ff over "model"; the prefill's output cache (10 kv
    heads: the head dimension over "model") in JAX's out layout."""
    rec = records[("phi3-medium-14b", "prefill_32k")]
    assert rec["status"] == "ok", rec
    jcfg = jget_config("phi3-medium-14b")
    n, n_bytes = _served_bytes(jcfg)
    assert rec["bytes"]["params"] == {"elements": n, "bytes": n_bytes}
    _, (_, b_specs), _, out_sh = jsteps.make_prefill_step(
        jcfg, _amesh(), JSHAPES["prefill_32k"])
    out = jax.eval_shape(lambda p, b: jfactory.make_model(
        jcfg, kv_repeat=jkv_tp_repeat(jcfg, 16))["prefill"](p, b),
        jfactory.param_specs(jcfg, inference=True), b_specs)
    assert rec["bytes"]["cache"]["bytes"] == _bytes(out[1], out_sh[1])


def test_largevis_cell_bytes_match_jax(records):
    """``layout_4m``: the step's inputs a rank (y whole, the edge and node
    tables over "data") and the three draws' sums over "data"."""
    rec = records[("largevis", "layout_4m")]
    assert rec["status"] == "ok", rec
    _, args, in_sh, _ = jsteps.make_largevis_step(
        _amesh(), n_nodes=4_000_000, n_edges=600_000_000, batch=1 << 20)
    want = sum(int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize
               for a, s in zip(args, in_sh))
    assert rec["bytes"]["inputs"]["bytes"] == want
    assert rec["collectives"]["all_reduce:data"]["calls"] == 3


def test_refused_and_skipped_cells(records):
    """xlstm-125m's 4 mLSTM/sLSTM heads at model 16, once refused, run
    whole on every rank: its ``train_4k`` cell is ``ok``, its parameter
    blocks and both moments JAX's training shard shapes; qwen's
    ``long_500k`` is skipped with JAX's reason; ``all_cells`` is JAX's
    list (JAX's ``launch/dryrun.py::all_cells``: the architectures by the
    shapes by the meshes, then LargeVis ``layout_4m``; not imported, as
    importing it sets a 512-device ``XLA_FLAGS`` for the process)."""
    rec = records[("xlstm-125m", "train_4k")]
    assert rec["status"] == "ok", rec
    jcfg = jget_config("xlstm-125m")
    specs = jfactory.param_specs(jcfg)
    want = _bytes(specs, jsh.params_shardings(specs, _amesh(), train=True))
    assert rec["bytes"]["params"]["bytes"] == want
    assert rec["bytes"]["moments"]["bytes"] == 2 * want
    assert rec["microbatches"] == 8 and rec["flops"] > 0
    rec = records[("qwen1.5-0.5b", "long_500k")]
    assert rec["status"] == "skipped"
    assert rec["reason"] == "long_500k skipped: pure full-attention arch"
    for kinds in (["single"], ["single", "multi"]):
        want = [(a, s, k) for a in JARCH_NAMES for s in JSHAPES
                for k in kinds] + [("largevis", "layout_4m", k)
                                   for k in kinds]
        assert dryrun.all_cells(kinds) == want


@pytest.mark.parametrize("arch", TRAIN_BODIES)
def test_train_flops_are_microbatch_bodies(records, arch):
    """A train cell's flops (the counter's and the kernels' own, each) are
    its one-microbatch body's times ``n_micro``, exactly: the step is its
    microbatches' losses and gradients, and AdamW adds no products."""
    rec = records[(arch, "train_4k")]
    body = records[(arch, "train_4k", "body")]
    assert body["status"] == "ok", body
    micro = body["bodies"]["micro"]["cost"]
    n = rec["microbatches"]
    for k in ("flops", "counter_flops", "kernel_flops"):
        assert rec["cost"][k] == n * micro[k], k


def test_kv_quant_decode_cell(tmp_path, monkeypatch):
    """``REPRO_KV_QUANT``: llama3-8b ``decode_32k`` decodes on the int8
    cache (JAX's ``make_decode_step(kv_quant=True)`` branch), its cache
    bytes a rank the sums over JAX's shard shapes of the int8 cache and
    its f32 scales."""
    monkeypatch.setenv("REPRO_KV_QUANT", "1")
    rec = dryrun.run_cell("llama3-8b", "decode_32k", "single", tmp_path,
                          quiet=True)
    assert rec["status"] == "ok", rec
    assert rec["kv_quant"] is True
    jcfg = jget_config("llama3-8b")
    shape_cfg = JSHAPES["decode_32k"]
    batch = jinput_specs(jcfg, shape_cfg, kv_repeat=jkv_tp_repeat(jcfg, 16),
                         kv_quant=True)
    assert {str(v.dtype) for v in _flat(batch["cache"]).values()} == \
        {"int8", "float32"}
    cache = jsh.batch_shardings(batch, _amesh(),
                                global_batch=shape_cfg.global_batch)["cache"]
    assert rec["bytes"]["cache"]["bytes"] == _bytes(batch["cache"], cache)


def test_all_keeps_records_unless_forced(tmp_path, capsys):
    """``--all`` reads a cell's record where one is there and runs
    nothing for it (JAX's cache of records; ``--force`` runs again);
    ``--mode body`` reads the single-mesh LM cells' body records."""
    cells = dryrun.all_cells(["single"])
    for a, s, m in cells:
        (tmp_path / f"{a}__{s}__{m}.json").write_text(
            json.dumps({"arch": a, "status": "skipped"}))
        if a != "largevis":
            (tmp_path / f"{a}__{s}__{m}__body.json").write_text(
                json.dumps({"arch": a, "status": "ok"}))
    assert dryrun.main(["--all", "--out", str(tmp_path)]) == 0
    said = capsys.readouterr().out
    assert said.count("cached ") == len(cells)
    assert f"0 ok / {len(cells)} skipped" in said
    assert dryrun.main(["--all", "--mode", "body", "--out",
                        str(tmp_path)]) == 0
    said = capsys.readouterr().out
    assert f"{len(cells) - 1} ok / 0 skipped" in said


@pytest.mark.parametrize("kind,arch", [("full", "whisper-tiny"),
                                       ("body", "qwen1.5-0.5b")])
def test_card_path_with_values(tmp_path, monkeypatch, kind, arch):
    """``device="cuda"``'s path with its CUDA calls swapped for the CPU's
    (the generator on the CPU, an untimed run): the step or body built
    from seeded values at the rank's blocks, the recording mesh's
    stand-ins on them; the counts are the meta device's, the values'
    collectives' bytes equal them (checked inside), the outputs finite,
    the arguments' bytes the meta device's.  Without CUDA the real call
    raises."""
    import torch

    from repro_torch.core.largevis import seeded_generator

    run = dryrun.run_cell if kind == "full" else dryrun.run_body_cell
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(arch, "decode_32k", "single", tmp_path, quiet=True,
                device="cuda")
    meta = run(arch, "decode_32k", "single", tmp_path, quiet=True)
    monkeypatch.setattr(dryrun, "_card", lambda device: seeded_generator(
        torch.device("cpu"), 0))
    monkeypatch.setattr(dryrun, "_timed", lambda fn, dev: (fn(), 0.0, 0, 0,
                                                           {}))
    got = run(arch, "decode_32k", "single", tmp_path, quiet=True,
              device="cuda")
    assert got["status"] == meta["status"] == "ok", got.get("error")
    if kind == "full":
        assert got["finite"] and got["launches"] == {}
        assert got["cost"] == meta["cost"] and got["bytes"] == meta["bytes"]
        assert got["memory"]["argument_size_in_bytes"] == sum(
            v["bytes"] for v in meta["bytes"].values())
    else:
        b, m = got["bodies"]["period"], meta["bodies"]["period"]
        assert b["finite"] and b["cost"] == m["cost"]
        assert b["collectives"] == m["collectives"]
        assert b["memory"]["argument_size_in_bytes"] == \
            m["memory"]["argument_size_in_bytes"]
