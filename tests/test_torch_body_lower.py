"""The port's per-period bodies (``launch/body_lower.py``,
``launch/dryrun.py::run_body_cell``) against the JAX package's on the
CPU, on the meta device.

Body cells of the single-pod production mesh (data 16, model 16), each
run once for the file: qwen1.5-0.5b ``train_4k``, llama3-8b
``decode_32k``, whisper-tiny ``prefill_32k`` (one decoder layer, the
encoder output an input) and xlstm-125m ``train_4k`` (its 4 mLSTM/sLSTM
heads whole on every rank at model 16).

* The period's parameter blocks are JAX's per-device shard shapes of its
  period (``body_lower._period_param_specs`` and
  ``_period_param_shardings`` on an ``AbstractMesh((16, 16))``; whisper's
  decoder layer by ``_lower_encdec_bodies``'s specs), leaf for leaf, and
  their bytes the sums over those shard shapes (JAX's f32 in training;
  serving, the port's dtypes: ``F32_MATRICES`` and vectors f32, as
  ``tests/test_torch_dryrun.py`` counts them).
* The flops identities hold exactly: a train cell's one-microbatch body
  is ``n_periods`` times its period body plus the head's products (the
  rank's vocab shard of the tied table: its forward, dx and dtable, 6 x
  rows x S x d x V/16), the counters' and the kernels' parts each; the
  decode cell's full step (``run_cell``) makes ``n_periods`` times the
  period's collectives plus the vocab-parallel embedding's one sum.
* A token loop on the meta device (two trips, ``xlstm._folded``) counts
  what the CPU's loop of every trip counts: a reduced xLSTM's loss and
  backward and its prefill at S = 16, at world 1 and on a recording
  mesh of (16, 16) (its heads whole), the flops and transcendentals
  exactly, the cost book's entries alike (the loss's forward and what
  its recompute reaches; a prefill records none, as JAX's).
* whisper's prefill body records the flash kernel's own work at its
  per-rank shape; the meta device's temporaries are None.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.launch import body_lower as jbody
from repro.models import encdec as jencdec
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import body_lower, dryrun
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.models.factory import F32_MATRICES

CELLS = [("qwen1.5-0.5b", "train_4k"), ("llama3-8b", "decode_32k"),
         ("whisper-tiny", "prefill_32k"), ("xlstm-125m", "train_4k")]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("body")
    return {(a, s): dryrun.run_body_cell(a, s, "single", out, quiet=True)
            for a, s in CELLS}


def _jax_shards(arch, train: bool) -> dict:
    """{"pos{p}/..." or "...": (shard shape, dtype)} of JAX's period (or
    decoder layer) on AbstractMesh (16, 16)."""
    jcfg = jget_config(arch)
    if jcfg.is_encoder_decoder:
        specs = jax.eval_shape(lambda k: jencdec.init_dec_layer(k, jcfg),
                               jax.random.key(0))
    else:
        specs = jbody._period_param_specs(jcfg, inference=not train)
    shard = jbody._period_param_shardings(
        specs, AbstractMesh((16, 16), ("data", "model")), train=train)
    flat_s = jax.tree_util.tree_flatten_with_path(specs)[0]
    flat_h = jax.tree.leaves(shard)
    out = {}
    for (path, leaf), s in zip(flat_s, flat_h):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = (tuple(s.shard_shape(leaf.shape)), np.dtype(leaf.dtype))
    return out


def _port_blocks(arch, shape) -> dict:
    """{path: (shape, itemsize)} of the port's period blocks, by JAX's
    path ("pos{p}/..." for a decoder's layer p of the period)."""
    cfg = get_config(arch)
    body = body_lower.lower_period_body(cfg, make_production_mesh(),
                                        SHAPES[shape])["period"]
    pp = body.args()[0]
    out = {}
    for name, p in pp.named_parameters():
        if not cfg.is_encoder_decoder:
            j, rest = name.split(".", 1)
            name = f"pos{j}.{rest}"
        out[name.replace(".", "/")] = (tuple(p.shape), p.element_size())
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_period_blocks_are_jax_shards(records, arch, shape):
    """Each leaf of the rank's period is its JAX shard shape, and the
    bytes are the sum over JAX's shard shapes (served: at the port's
    dtypes)."""
    rec = records[(arch, shape)]
    assert rec["status"] == "ok", rec
    train = SHAPES[shape].kind == "train"
    want = _jax_shards(arch, train)
    got = _port_blocks(arch, shape)
    assert sorted(got) == sorted(want)
    for k, (s, _) in want.items():
        assert got[k][0] == s, (k, got[k], s)
    jbytes = 0
    for k, (s, d) in want.items():
        if not train:        # the port's serving dtypes (test_torch_dryrun)
            f32 = len(s) < 2 or k.rsplit("/", 1)[-1] in F32_MATRICES
            d = np.dtype(np.float32) if f32 else np.dtype(
                str(get_config(arch).dtype).removeprefix("torch."))
        jbytes += int(np.prod(s)) * d.itemsize
    assert sum(int(np.prod(s)) * n for s, n in got.values()) == jbytes
    body = rec["bodies"]["period"]
    assert body["memory"]["temp_size_in_bytes"] is None
    assert rec["n_periods"] == get_config(arch).n_periods if arch != \
        "whisper-tiny" else get_config(arch).n_layers


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "xlstm-125m"])
def test_micro_is_periods_plus_head(records, arch):
    """``micro`` = ``n_periods`` x ``period`` + the tied head's products
    (6 x rows x S x d x V/16 on the rank's vocab shard), the counter's
    and the kernels' flops each, exactly; JAX's meta: 8 microbatches of
    32 rows (2 a data rank)."""
    rec = records[(arch, "train_4k")]
    cfg = get_config(arch)
    period, micro = rec["bodies"]["period"], rec["bodies"]["micro"]
    assert (period["n_micro"], period["b_micro"]) == (8, 32)
    rows, S = 2, 4096
    head = 6.0 * rows * S * cfg.d_model * (cfg.vocab_size // 16)
    n = rec["n_periods"]
    assert micro["cost"]["counter_flops"] == \
        n * period["cost"]["counter_flops"] + head
    assert micro["cost"]["kernel_flops"] == \
        n * period["cost"]["kernel_flops"]
    assert micro["cost"]["flops"] == n * period["cost"]["flops"] + head
    if arch == "qwen1.5-0.5b":                   # the flash kernels
        assert period["cost"]["kernel_flops"] > 0
    assert micro["collectives"]["total"] > n * period["collectives"][
        "total"]


def test_decode_step_is_periods_plus_embedding(records, tmp_path):
    """llama3-8b ``decode_32k``: the full step's collectives are
    ``n_periods`` x the period's (two "model" sums a layer) plus the
    vocab-parallel embedding's one sum of (8, 1, 4096) bf16; the logits
    stay the rank's vocab shard (no gather)."""
    full = dryrun.run_cell("llama3-8b", "decode_32k", "single", tmp_path,
                           quiet=True)
    rec = records[("llama3-8b", "decode_32k")]
    body = rec["bodies"]["period"]["collectives"]["by_kind"]
    n = rec["n_periods"]
    rest = {}
    for k, v in full["collectives"].items():
        b = body.get(k, {"calls": 0, "bytes": 0})
        left = {"calls": v["calls"] - n * b["calls"],
                "bytes": v["bytes"] - n * b["bytes"]}
        if left["calls"] or left["bytes"]:
            rest[k] = left
    assert body == {"all_reduce:model": {"calls": 2, "bytes": 2 * 65536}}
    assert rest == {"all_reduce:model": {"calls": 1, "bytes": 8 * 4096 * 2}}


def test_whisper_prefill_records_the_flash_work(records):
    """One decoder layer at 2 rows a rank, its 6 heads whole at model 16:
    the flash forward's own work, 4 hd operations a pair under the causal
    mask of 32,768 tokens."""
    body = records[("whisper-tiny", "prefill_32k")]["bodies"]["period"]
    S = 32768
    assert [k["label"] for k in body["kernels"]] == ["flash_attention"]
    assert body["cost"]["kernel_flops"] == 4.0 * 2 * 6 * 64 * \
        (S * (S + 1) // 2)
    assert body["memory"]["argument_size_in_bytes"] > 0


def _loop_cost(cfg, device, mesh=None, train=True):
    """cost_stats and the book's entries of a reduced xLSTM's loss and
    backward (or prefill) at S = 16 on ``device``."""
    gen = torch.Generator().manual_seed(0)
    params = lm.init_lm(gen, cfg, mesh, train=train)
    toks = torch.zeros((2, 16), dtype=torch.long)
    if device == "meta":
        params = params.to("meta")
        toks = toks.to("meta")
    with H.counting() as counter:
        if train:
            params.requires_grad_(True)
            lm.lm_loss(params, cfg, toks, toks, mesh=mesh).backward()
        else:
            lm.lm_prefill(params, cfg, toks, mesh=mesh)
    entries = [(e.label, e.total_flops, e.trips)
               for e in counter.book.entries]
    return H.cost_stats(counter), entries


@pytest.mark.parametrize("train", [True, False], ids=["loss", "prefill"])
@pytest.mark.parametrize("meshed", [False, True], ids=["world1", "16x16"])
def test_meta_loop_counts_every_trip(meshed, train):
    """The meta device's two-trip loop counts the flops and
    transcendentals of the CPU's loop of every trip, exactly, and the
    book's entries are the same."""
    cfg = get_config("xlstm-125m-reduced")
    got = {}
    for device in ("cpu", "meta"):
        mesh = make_production_mesh(device=device) if meshed else None
        got[device] = _loop_cost(cfg, device, mesh, train)
    (cpu, cpu_book), (meta, meta_book) = got["cpu"], got["meta"]
    assert meta["flops"] == cpu["flops"] > 0
    assert meta["transcendentals"] == cpu["transcendentals"] > 0
    # the loss: each layer's forward, then what the recompute reaches (a
    # non-reentrant checkpoint stops once the backward's tensors are
    # back); a prefill none
    assert meta_book == cpu_book
    assert [e[0] for e in cpu_book][:4 if train else None] == (
        ["mlstm_scan", "slstm_scan"] * 2 if train else [])
