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
on them under ``models/costbook.py``'s ``recording()`` and torch's
``FlopCounterMode``.  Each cell's JSON record holds:

* ``bytes``: parameters, optimizer moments (a training cell) and cache
  (a decode cell's input, a prefill's output) a rank, with the element
  counts;
* ``collectives``: by ``kind:axis``, the calls and the bytes a rank hands
  them;
* ``flops``: what ``FlopCounterMode`` counted (every trip of the eager
  loops, the backward's included), and ``costbook``: the book's entries,
  which stand for the regions the counter cannot see, the hand-written
  kernels (the flash forward and backward, one opaque call each here);
* ``status``: ``ok``; ``skipped`` with ``configs.cell_applicable``'s
  reason (JAX's); or ``refused`` with the port's own ``lm.check_mesh``
  text, which names the ROADMAP step that lifts it.  An ``error`` is a
  fault of the port.

What it does not prove: the activations' peak memory (meta tensors hold
none, and nothing is freed or kept as on the card), whether a kernel fits
its shapes (its launch bounds, shared memory and registers: the meta
device runs no kernel), and the collectives' times (only their bytes are
known).  ``run_body_cell`` (JAX's trip-count correction from the lowered
scan bodies) needs ``launch/body_lower.py`` and waits for ROADMAP Queue 1
item 7 step 10.

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh both]
    python -m repro_torch.launch.dryrun --arch largevis --shape layout_4m

Records go to ``dryrun_out/`` at the checkout's root (git-ignored), one
file a cell, ``<arch>__<shape>__<mesh>.json``; ``--out`` moves them.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

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


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def _size(tree) -> dict:
    """{"elements", "bytes"} of a tree's tensors (dicts, lists and
    modules' parameters)."""
    ts = list(_leaves(tree))
    return {"elements": int(sum(t.numel() for t in ts)),
            "bytes": int(sum(t.numel() * t.element_size() for t in ts))}


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


def _largevis(mesh, shape: str):
    from repro_torch.launch import steps

    spec = dict(LARGEVIS_SHAPES[shape])
    local = spec.pop("local", False)
    builder = steps.make_largevis_step_local if local else \
        steps.make_largevis_step
    fn, arg_specs, in_blocks, _ = builder(mesh, **spec)
    args = [_meta_like(b, a.dtype) for a, b in zip(arg_specs, in_blocks)]
    sizes = {"inputs": _size(args)}
    return (lambda: fn(*args)), sizes, "largevis_layout", {}


def _lm(cfg, shape_cfg, mesh):
    from repro_torch.configs import input_specs
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import adamw_init

    sizes = mesh.shape
    if shape_cfg.kind == "train":
        step = steps.make_train_step(cfg, shape_cfg, mesh=mesh)
        params = rank_params(cfg, sizes, train=True)
        opt = adamw_init(params)
        batch = input_specs(cfg, shape_cfg)
        rec = {"params": _size(params),
               "moments": _size([opt["m"], opt["v"]])}
        return (lambda: step(params, opt, batch)), rec, "train", \
            {"microbatches": step.microbatches}
    build = steps.make_prefill_step if shape_cfg.kind == "prefill" else \
        steps.make_decode_step
    step, batch, (_, b_layout), _ = build(cfg, mesh, shape_cfg)
    params = rank_params(cfg, sizes, train=False)
    local = _blocks(batch, b_layout, sizes)
    rec = {"params": _size(params)}
    if "cache" in local:
        rec["cache"] = _size(local["cache"])
    return (lambda: step(params, local)), rec, shape_cfg.kind, {}


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: pathlib.Path,
             quiet: bool = False) -> dict:
    """Build and run mesh rank 0's step of one cell on the meta device and
    write its record (module docstring); returns the record."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import costbook

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "mesh_shape": dict(mesh.shape), "ranks": mesh.size, "rank": 0,
           "status": "ok"}
    t0 = time.time()
    try:
        if arch == "largevis":
            run, sizes, rec["cell_kind"], info = _largevis(mesh, shape)
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
            run, sizes, rec["cell_kind"], info = _lm(cfg, shape_cfg, mesh)
        rec.update(info)
        with costbook.recording() as book, \
                FlopCounterMode(display=False) as counter:
            out = run()
        if rec["cell_kind"] == "prefill":
            sizes["cache"] = _size(out[1])
        rec.update(
            bytes=sizes, collectives=mesh.collectives(),
            flops=float(counter.get_total_flops()),
            costbook=[dict(label=e.label, total_flops=e.total_flops,
                           total_bytes=e.total_bytes, trips=e.trips)
                      for e in book.entries],
            seconds=round(time.time() - t0, 2))
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug report
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
    return _write(rec, out_dir, quiet)


def _write(rec: dict, out_dir: pathlib.Path, quiet: bool) -> dict:
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
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
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = all_cells(mesh_kinds)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, mk) for mk in mesh_kinds]
    results = [run_cell(a, s, m, out_dir) for a, s, m in cells]
    count = {k: sum(r["status"] == k for r in results)
             for k in ("ok", "skipped", "refused", "error")}
    print(f"{count['ok']} ok / {count['skipped']} skipped / "
          f"{count['refused']} refused / {count['error']} error of "
          f"{len(results)} cells; records in {out_dir}")
    return 1 if count["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
