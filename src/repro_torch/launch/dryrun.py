"""The dry run of every production cell: each (architecture x shape x
mesh) cell's per-rank step built and run on torch's meta device — the JAX
package's ``launch/dryrun.py``.

JAX proves each cell by lowering and compiling it on 512 placeholder CPU
devices.  The port has no such devices.  Instead it runs one rank of the
production mesh (``launch/mesh.py::make_production_mesh``: (data 16,
model 16), or (pod 2, data 16, model 16) with the pod axis folded into
the data axis as 32) as a :class:`~repro_torch.launch.mesh.RecordingMesh`
whose collectives return meta tensors and log their kind, axis and bytes:
the rank's parameters, optimizer moments, batch and cache are its blocks
by ``runtime/sharding.py``'s rules, on the meta device (shapes, no
memory), and the step the launcher would run (``launch/steps.py``) runs
on them under ``launch/hlo_analysis.py``'s ``counting()`` (torch's flop
formulas, the bytes and transcendentals of every op, and
``models/costbook.py``'s book).  Each cell's JSON record holds:

* ``bytes``: parameters, optimizer moments (a training cell) and cache
  (a decode cell's input, a prefill's output) a rank, with the element
  counts;
* ``collectives``: by ``kind:axis``, the calls and the bytes a rank hands
  them;
* ``flops``: what torch's flop formulas counted (every trip of the eager
  loops, the backward's included) plus the work the hand-written kernels
  record for themselves (the flash forward and backward, one opaque call
  each here); ``cost``: ``hlo_analysis.cost_stats`` (the two parts of
  ``flops`` alone, the bytes accessed, the transcendentals); and
  ``costbook``: the book's entries, JAX's labels, totals and trips;
* ``status``: ``ok``; ``skipped`` with ``configs.cell_applicable``'s
  reason (JAX's); or ``refused`` with the port's own ``lm.check_mesh``
  text.  An ``error`` is a fault of the port.

A decode cell under ``REPRO_KV_QUANT`` (set and not empty) runs
``steps.make_decode_step(..., kv_quant=True)``, JAX's branch: the record
says ``kv_quant`` and its cache bytes are the int8 cache and its scales.

The meta device does not show the activations' peak memory (meta
tensors hold none, and nothing is freed or kept as on the card), whether
a kernel takes its shapes (the meta device runs no kernel), or the
collectives' times (only their bytes are known).  ``device="cuda"``
(``--device cuda``) runs the same rank's step once more on the card,
timed (a run under a second twice, the repeat kept): its blocks drawn from a seeded generator, its batch's blocks
random (a zero cache), the recording mesh's collectives returning
stand-in values on the card (a gather tiles the rank's block, a sum
returns the rank's own term); the record adds the step's ms by CUDA
events, its ``memory`` (``hlo_analysis.memory_stats``: the peak over the
run less what was allocated before it) and the kernels' launches.  Its
counts (flops, bytes accessed, transcendentals, collectives' bytes) stay
the meta device's, which do not depend on the device (the card's
collectives' bytes are checked equal to them), so the counters' Python
work on every op runs once.  The collectives' times and values are not
measured there: nothing crosses a process.  Without CUDA it raises;
nothing falls back.

:func:`run_body_cell` (``--mode body``) runs JAX's per-period bodies
(``launch/body_lower.py``) alone: a train cell's layer period (forward,
recompute and backward) and one microbatch's loss and gradient over the
whole model, a prefill's period, a decode's period step on the rank's
cache slice, whisper's decoder layer.  Its record,
``<arch>__<shape>__<mesh>__body.json``, holds JAX's fields: ``n_periods``
and for each body its ``cost`` (``hlo_analysis.cost_stats``: flops,
bytes accessed, transcendentals), ``collectives``
(``hlo_analysis.collective_bytes``), ``costbook`` and JAX's meta
(``n_micro``, ``b_micro``); and the port's ``memory``, and on the card
the body's ``ms`` and ``launches``.  ``--all --mode body`` takes the
single-mesh cells of the LM architectures, as JAX's.  A token loop on the
meta device runs as two trips (``models/xlstm.py::_folded``) whose
counted flops and transcendentals are every trip's (its bytes accessed
approximately); the record's ``loops`` says so.

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
    python -m repro_torch.launch.dryrun --arch largevis --shape layout_4m
    python -m repro_torch.launch.dryrun --all --mode body
    python -m repro_torch.launch.dryrun --arch gemma3-12b --shape prefill_32k \\
        --mode body --device cuda

Records go to ``dryrun_out/`` at the checkout's root (git-ignored), one
file a cell, ``<arch>__<shape>__<mesh>.json``; ``--out`` moves them.
``--all`` keeps a cell's record from an earlier run and runs it again
only under ``--force``.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

import torch

from repro_torch.launch.hlo_analysis import tree_size

LOOPS = ("every trip counted: a token loop on the meta device runs as two "
         "trips whose rows are every trip's (models/xlstm.py::_folded); "
         "its flops and transcendentals are every trip's exactly, its "
         "bytes accessed approximate (the second trip's repeated states "
         "are copies the loop does not make)")

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "dryrun_out"

LARGEVIS_SHAPES = {
    # paper scale: LiveJournal ~4M nodes, K=150 edges/node
    "layout_4m": dict(n_nodes=4_000_000, n_edges=600_000_000,
                      batch=1 << 20),
    # per-shard sampling + local SGD (H=8)
    "layout_4m_local": dict(n_nodes=4_000_000, n_edges=600_000_000,
                            batch=1 << 20, local=True),
    "layout_64m": dict(n_nodes=64_000_000, n_edges=9_600_000_000,
                       batch=1 << 22),
}


def _meta_like(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def rank_params(cfg, sizes, *, train: bool):
    """The rank's parameter blocks on the meta device: the whole tree
    (``factory.param_specs``, cast for serving unless ``train``), each
    leaf replaced by its block under ``sharding.params_shardings``."""
    from repro_torch.models.factory import param_specs
    from repro_torch.runtime import sharding as sh

    tree = param_specs(cfg, inference=not train)
    specs = sh.params_shardings(tree, cfg, sizes, train=train)
    for mod_name, mod in tree.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            full = f"{mod_name}.{name}" if mod_name else name
            mod._parameters[name] = torch.nn.Parameter(
                _meta_like(sh.block_shape(p.shape, specs[full], sizes),
                           p.dtype), requires_grad=False)
    return tree


def _blocks(tree, specs, sizes):
    """A dict tree of whole meta tensors as the rank's blocks under
    ``specs`` (the same tree of specs)."""
    from repro_torch.runtime import sharding as sh

    if isinstance(tree, dict):
        return {k: _blocks(tree[k], specs[k], sizes) for k in tree}
    return _meta_like(sh.block_shape(tree.shape, specs, sizes), tree.dtype)


def _device_blocks(tree, generator, cfg, S: int):
    """Tensors on the generator's device in the shapes of a tree of meta
    tensors (a batch's blocks): tokens random below the vocabulary, the
    positions ``S - 1`` (a filled cache), the cache zero, frames
    normal."""
    if isinstance(tree, dict):
        return {k: (_device_blocks(v, generator, cfg, S) if
                    isinstance(v, dict) else
                    _device_leaf(k, v, generator, cfg, S))
                for k, v in tree.items()}
    return tree


def _device_leaf(name, t, generator, cfg, S):
    dev = generator.device
    if name in ("tokens", "labels"):
        return torch.randint(0, cfg.vocab_size, tuple(t.shape),
                             generator=generator, device=dev,
                             dtype=t.dtype)
    if name == "position":
        return torch.full(tuple(t.shape), S - 1, dtype=t.dtype, device=dev)
    if name == "encoder_frames":
        return torch.randn(tuple(t.shape), generator=generator,
                           device=dev).to(t.dtype)
    return torch.zeros(tuple(t.shape), dtype=t.dtype, device=dev)


def _largevis(mesh, shape: str):
    from repro_torch.launch import steps

    spec = dict(LARGEVIS_SHAPES[shape])
    local = spec.pop("local", False)
    builder = steps.make_largevis_step_local if local else \
        steps.make_largevis_step
    fn, arg_specs, in_blocks, _ = builder(mesh, **spec)
    args = [_meta_like(b, a.dtype) for a, b in zip(arg_specs, in_blocks)]
    sizes = {"inputs": tree_size(args)}
    return (lambda: fn(*args)), sizes, "largevis_layout", {}


def _lm(cfg, shape_cfg, mesh, generator=None):
    from repro_torch.configs import input_specs
    from repro_torch.launch import steps
    from repro_torch.models.factory import make_model
    from repro_torch.optim.adamw import adamw_init

    sizes = mesh.shape
    S = shape_cfg.seq_len
    if shape_cfg.kind == "train":
        step = steps.make_train_step(cfg, shape_cfg, mesh=mesh)
        batch = input_specs(cfg, shape_cfg)
        if generator is None:
            params = rank_params(cfg, sizes, train=True)
        else:
            params = make_model(cfg, mesh=mesh)["init"](generator,
                                                        train=True)
            batch = _device_blocks(batch, generator, cfg, S)
        opt = adamw_init(params)
        rec = {"params": tree_size(params),
               "moments": tree_size([opt["m"], opt["v"]])}
        return (lambda: step(params, opt, batch)), rec, "train", \
            {"microbatches": step.microbatches}
    info = {}
    if shape_cfg.kind == "prefill":
        step, batch, (_, b_layout), _ = steps.make_prefill_step(
            cfg, mesh, shape_cfg)
    else:
        quant = bool(os.environ.get("REPRO_KV_QUANT"))
        step, batch, (_, b_layout), _ = steps.make_decode_step(
            cfg, mesh, shape_cfg, kv_quant=quant)
        if quant:
            info["kv_quant"] = True
    local = _blocks(batch, b_layout, sizes)
    if generator is None:
        params = rank_params(cfg, sizes, train=False)
    else:
        params = make_model(cfg, mesh=mesh)["init"](generator,
                                                    inference=True)
        local = _device_blocks(local, generator, cfg, S)
    rec = {"params": tree_size(params)}
    if "cache" in local:
        rec["cache"] = tree_size(local["cache"])
    return (lambda: step(params, local)), rec, shape_cfg.kind, info


def _card(device: str):
    """The generator of a card run (seed 0), None on the meta device;
    raises for a card run without CUDA."""
    if device == "meta":
        return None
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r}: CUDA is not available "
                           "(the dry run on the meta device is "
                           "device='meta')")
    from repro_torch.core.largevis import seeded_generator

    return seeded_generator(torch.device(device), 0)


# a card run shorter than this is run again and the repeat kept: a body's
# first run in a process pays its kernels' lazy loading and the
# allocator's growth (on an H100, qwen1.5-0.5b decode_32k's period took
# 178.7 ms first in a process, 2.6 ms after a run); a longer one is kept
# as it is
REPEAT_UNDER_MS = 1_000.0


def _timed(run, mesh) -> tuple:
    """(result, ms by CUDA events, peak bytes, bytes allocated before, the
    kernels' launches) of a run on the card (``mesh`` the card's recording
    mesh, its log cleared before it), run again if it took under
    :data:`REPEAT_UNDER_MS`."""
    from repro_torch.kernels import ops

    dev = mesh.device
    ms = 0.0
    while True:
        out = None
        mesh.log.clear()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        counts = ops.launch_counts()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        out = run()
        b.record()
        b.synchronize()
        if ms or a.elapsed_time(b) >= REPEAT_UNDER_MS:
            break
        ms = a.elapsed_time(b)
    launches = {k: v - counts[k] for k, v in ops.launch_counts().items()
                if v != counts[k]}
    return out, a.elapsed_time(b), torch.cuda.max_memory_allocated(dev), \
        before, launches


def _finite(tree) -> bool:
    """Whether every floating tensor of a tree (nested tuples, lists,
    dicts) is finite."""
    from torch.utils._pytree import tree_flatten

    return all(bool(torch.isfinite(t).all()) for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor) and t.is_floating_point())


def _book(book) -> list:
    return [dict(label=e.label, total_flops=e.total_flops,
                 total_bytes=e.total_bytes, trips=e.trips)
            for e in book.entries]


def _same_collectives(card, meta) -> None:
    if card != meta:
        raise RuntimeError(f"the card's collectives {card} are not the "
                           f"meta device's {meta}")


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: pathlib.Path,
             quiet: bool = False, device: str = "meta") -> dict:
    """Build and run mesh rank 0's step of one cell on the meta device and
    write its record (module docstring); returns the record.  With
    ``device="cuda"`` the step then runs on the card, timed
    (:func:`_timed`); its counts stay the meta device's, which do not depend on the device
    (the card's collectives are checked equal to them)."""
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch.mesh import make_production_mesh

    generator = _card(device)
    multi = mesh_kind == "multi"
    mesh = make_production_mesh(multi_pod=multi)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "mesh_shape": dict(mesh.shape), "ranks": mesh.size, "rank": 0,
           "device": device, "status": "ok"}
    t0 = time.time()
    try:
        if arch == "largevis":
            if generator is not None:
                raise ValueError("the LargeVis cell runs on the card in "
                                 "chip_smoke.py's production phase, not "
                                 "here")

            def build(m, g):
                return _largevis(m, shape)
        else:
            from repro_torch.configs import SHAPES, cell_applicable, \
                get_config
            from repro_torch.models import lm

            cfg = get_config(arch)
            shape_cfg = SHAPES[shape]
            ok, why = cell_applicable(cfg, shape_cfg)
            if not ok:
                rec.update(status="skipped", reason=why)
                return _write(rec, out_dir, quiet)
            try:
                lm.check_mesh(cfg, mesh)
            except ValueError as e:
                rec.update(status="refused", reason=str(e))
                return _write(rec, out_dir, quiet)

            def build(m, g):
                return _lm(cfg, shape_cfg, m, g)
        run, sizes, rec["cell_kind"], info = build(mesh, None)
        rec.update(info)
        with H.counting() as counter:
            out = run()
        if rec["cell_kind"] == "prefill":
            sizes["cache"] = tree_size(out[1])
        cost = H.cost_stats(counter)
        rec.update(
            bytes=sizes, collectives=mesh.collectives(),
            flops=cost["flops"], cost=cost, costbook=_book(counter.book),
            loops=LOOPS)
        del out, run
        if generator is not None:
            card = make_production_mesh(multi_pod=multi, device=device)
            run = build(card, generator)[0]
            out, ms, peak, before, launches = _timed(run, card)
            _same_collectives(card.collectives(), rec["collectives"])
            memory = H.memory_stats(None, out, peak, before)
            memory["argument_size_in_bytes"] = sum(
                v["bytes"] for k, v in sizes.items() if k != "cache" or
                rec["cell_kind"] == "decode")
            rec.update(ms=ms, memory=memory, launches=launches,
                       finite=_finite(out))
        rec["seconds"] = round(time.time() - t0, 2)
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug report
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
    return _write(rec, out_dir, quiet)


def _body_on_card(body, mesh, generator, collectives) -> dict:
    """A body timed on the card (:func:`_timed`; ``mesh`` the card's
    recording mesh): its ms by CUDA events, its ``memory`` (the peak less
    what was allocated before it), its kernels' launches, whether its
    outputs are finite."""
    from repro_torch.launch import hlo_analysis as H

    args = body.args(generator)
    out, ms, peak, before, launches = _timed(lambda: body.fn(*args), mesh)
    _same_collectives(H.collective_bytes(mesh.log), collectives)
    return dict(memory=H.memory_stats(args, out, peak, before), ms=ms,
                launches=launches, finite=_finite(out))


def run_body_cell(arch: str, shape: str, mesh_kind: str,
                  out_dir: pathlib.Path, quiet: bool = False,
                  device: str = "meta", bodies=None) -> dict:
    """Run mesh rank 0's per-period bodies of one LM cell
    (``body_lower.lower_period_body``; ``bodies`` picks some by name) on
    the meta device and write the cell's body record (module docstring);
    returns the record.  With ``device="cuda"`` each body then runs on
    the card, timed (:func:`_body_on_card`); its counts stay the meta
    device's, which do not depend on the device (the card's collectives
    are checked equal to them)."""
    from repro_torch.configs import SHAPES, cell_applicable, get_config
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch.body_lower import lower_period_body
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import lm

    generator = _card(device)
    multi = mesh_kind == "multi"
    mesh = make_production_mesh(multi_pod=multi)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "mesh_shape": dict(mesh.shape), "rank": 0, "device": device,
           "status": "ok", "bodies": {}}
    t0 = time.time()
    try:
        cfg = get_config(arch)
        shape_cfg = SHAPES[shape]
        ok, why = cell_applicable(cfg, shape_cfg)
        if not ok:
            rec.update(status="skipped", reason=why)
            return _write(rec, out_dir, quiet, "__body")
        try:
            lm.check_mesh(cfg, mesh)
        except ValueError as e:
            rec.update(status="refused", reason=str(e))
            return _write(rec, out_dir, quiet, "__body")
        rec["n_periods"] = cfg.n_layers if cfg.is_encoder_decoder else \
            cfg.n_periods
        rec["loops"] = LOOPS
        if generator is not None:
            card = make_production_mesh(multi_pod=multi, device=device)
            on_card = lower_period_body(cfg, card, shape_cfg)
        for name, body in lower_period_body(cfg, mesh, shape_cfg).items():
            if bodies is not None and name not in bodies:
                continue
            args = body.args()
            mesh.log.clear()
            with H.counting() as counter:
                out = body.fn(*args)
            got = dict(
                cost=H.cost_stats(counter),
                collectives=H.collective_bytes(mesh.log),
                costbook=_book(counter.book),
                kernels=[dict(label=k, flops=f, bytes=b)
                         for k, f, b in counter.kernels],
                memory=H.memory_stats(args, out), **body.meta)
            del args, out
            if generator is not None:
                got.update(_body_on_card(on_card[name], card, generator,
                                         got["collectives"]))
            rec["bodies"][name] = got
        rec["seconds"] = round(time.time() - t0, 2)
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug report
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
    return _write(rec, out_dir, quiet, "__body")


def _record_path(out_dir, arch, shape, mesh, suffix="") -> pathlib.Path:
    return pathlib.Path(out_dir) / f"{arch}__{shape}__{mesh}{suffix}.json"


def _write(rec: dict, out_dir: pathlib.Path, quiet: bool,
           suffix: str = "") -> dict:
    path = _record_path(out_dir, rec["arch"], rec["shape"], rec["mesh"],
                        suffix)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    if not quiet:
        what = rec.get("reason") or rec.get("error") or \
            f"{rec.get('seconds')} s"
        print(f"{rec['arch']:18s} {rec['shape']:12s} {rec['mesh']:6s} -> "
              f"{rec['status']:8s} ({what})", flush=True)
    return rec


def all_cells(mesh_kinds) -> list:
    """Every (arch, shape, mesh) cell JAX's dry run lists: the ten
    architectures by the four shapes, then the LargeVis layout cell."""
    from repro_torch.configs import ARCH_NAMES, SHAPES

    cells = [(arch, shape, mk) for arch in ARCH_NAMES for shape in SHAPES
             for mk in mesh_kinds]
    cells += [("largevis", "layout_4m", mk) for mk in mesh_kinds]
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the dry run of every "
                                 "production cell on the meta device")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="with --all, run again the cells that have a "
                    "record")
    ap.add_argument("--mode", default="full", choices=["full", "body"])
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"])
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    body = args.mode == "body"
    suffix = "__body" if body else ""
    if args.all:
        cells = all_cells(mesh_kinds)
        if body:
            cells = [(a, s, m) for a, s, m in cells
                     if a != "largevis" and m == "single"]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, mk) for mk in mesh_kinds]
    results = []
    for a, s, m in cells:
        path = _record_path(out_dir, a, s, m, suffix)
        if args.all and path.exists() and not args.force:
            rec = json.loads(path.read_text())
            print(f"cached {a} x {s} x {m}: {rec['status']}", flush=True)
        elif body:
            rec = run_body_cell(a, s, m, out_dir, device=args.device)
        else:
            rec = run_cell(a, s, m, out_dir, device=args.device)
        results.append(rec)
    count = {k: sum(r["status"] == k for r in results)
             for k in ("ok", "skipped", "refused", "error")}
    print(f"{count['ok']} ok / {count['skipped']} skipped / "
          f"{count['refused']} refused / {count['error']} error of "
          f"{len(results)} cells; records in {out_dir}")
    return 1 if count["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
