"""Multi-process worlds of the port's data mesh for the CPU tests.

``run_world(fn, P, tmp_path, payload)`` spawns P processes that join one
gloo process group (``init_method="file://..."`` under ``tmp_path``, so
concurrent test workers never share a port or a store), each with a
60 s timeout on the group; every rank calls ``fn(mesh, payload)`` (a
function of this module, picked by name) and its dict of numpy arrays
comes back through an ``.npz`` file.  A rank that raises, or a world that
outlives its deadline, fails the call.  This module imports no JAX, so a
rank starts with torch alone.
"""
from __future__ import annotations

import datetime
import time
import warnings
from pathlib import Path

import numpy as np

WORLD_TIMEOUT_S = 60
ALL_REDUCE_ROWS = 403         # (403, 2): 806 entries, cut in P blocks


def _rank_main(rank, P, tmp, fn_name, payload):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=P,
        timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        from repro_torch.launch.mesh import make_data_mesh
        mesh = make_data_mesh(0, device="cpu")
        out = globals()[fn_name](mesh, payload)
        np.savez(Path(tmp) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def run_world(fn_name: str, P: int, tmp_path, payload) -> list:
    """Every rank's result dict, in rank order."""
    import torch.multiprocessing as mp

    tmp = Path(tmp_path) / f"world{P}_{fn_name}"
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(P, str(tmp), fn_name,
                                               payload),
                             nprocs=P, join=False, start_method="spawn")
    deadline = time.monotonic() + 2 * WORLD_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world {P} of {fn_name} hung")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(P)]


# ---------------------------------------------------------------------------
# the worlds of tests/test_torch_sharded_graph.py
# ---------------------------------------------------------------------------

def graph_world(mesh, pl):
    """Ring KNN (codes and exact), one exploring round (tiled and
    untiled), the sharded weights and samplers, all global."""
    import torch

    from repro_torch.configs.largevis_default import LargeVisConfig
    from repro_torch.core import knn_sharded, neighbor_explore, perplexity
    from repro_torch.core import sampler
    from repro_torch.runtime import sharding as sh

    out = {}
    for n, x in pl["x"].items():
        x = torch.from_numpy(x)
        for mode, trees, iters in (("ring", pl["n_trees"], 0),
                                   ("knn", pl["n_trees"], 1),
                                   ("exact", 0, 0)):
            cfg = LargeVisConfig(n_neighbors=pl["k"], n_trees=trees,
                                 n_explore_iters=iters, distributed=True)
            proj = torch.from_numpy(pl["proj"][n][trees])
            idx, dist = knn_sharded.build_knn_graph_sharded(
                x, cfg, mesh=mesh, proj=proj)
            out[f"{mode}_idx_{n}"], out[f"{mode}_dist_{n}"] = (
                idx.numpy(), dist.numpy())
        # one exploring round from a given graph, tiled and not
        g_idx = torch.from_numpy(pl["graph"][n][0])
        g_dist = torch.from_numpy(pl["graph"][n][1])
        n_loc = sh.rows_per_shard(x.shape[0], mesh.size)
        lo = mesh.rank * n_loc
        x_loc = sh.pad_rows(x, mesh.size)[lo:lo + n_loc]
        ids = torch.arange(lo, lo + n_loc, dtype=torch.int32)
        i_loc = sh.pad_rows(g_idx, mesh.size)[lo:lo + n_loc]
        d_loc = sh.pad_rows(g_dist, mesh.size)[lo:lo + n_loc]
        for name, tile in (("whole", n_loc), ("tiled", 16)):
            ei, ed = neighbor_explore.sharded_explore_round(
                mesh, x_loc, ids, i_loc, d_loc, n_real=x.shape[0],
                tile=tile)
            out[f"explore_{name}_idx_{n}"] = mesh.all_gather(ei)[:n].numpy()
            out[f"explore_{name}_dist_{n}"] = mesh.all_gather(
                ed)[:n].numpy()
        # the weights of a fixed graph
        w_idx = torch.from_numpy(pl["wgraph"][n][0])
        w_d2 = torch.from_numpy(pl["wgraph"][n][1])
        p = perplexity.calibrate_p_sharded(w_d2, 5.0, mesh=mesh)
        out[f"p_{n}"] = p.numpy()
        out[f"w_{n}"] = perplexity.symmetrize_sharded(w_idx, p,
                                                      mesh=mesh).numpy()
        out[f"ew_{n}"] = perplexity.edge_weights_sharded(
            w_idx, w_d2, 5.0, mesh=mesh).numpy()
        # the sharded tables, of integer and of real weights
        for kind in ("int", "real"):
            es, ns = sampler.build_samplers_sharded(
                w_idx, torch.from_numpy(pl["tw"][n][kind]), mesh=mesh)
            for f in ("src", "dst", "threshold", "alias", "shard_threshold",
                      "shard_alias"):
                out[f"es_{f}_{kind}_{n}"] = getattr(es, f).numpy()
            for f in ("threshold", "alias", "shard_threshold", "shard_alias"):
                out[f"ns_{f}_{kind}_{n}"] = getattr(ns, f).numpy()
            out[f"marg_{kind}_{n}"] = sampler.edge_marginals(es)
            gen = torch.Generator().manual_seed(9)
            out[f"draw_e_{kind}_{n}"] = torch.stack(es.sample(gen, 4096)
                                                    ).numpy()
            out[f"draw_n_{kind}_{n}"] = ns.sample(gen, (4096,)).numpy()
    # the local-SGD sync's sum of every rank's own move
    gen = torch.Generator().manual_seed(100 + mesh.rank)
    move = torch.randn((ALL_REDUCE_ROWS, 2), generator=gen)
    out["all_reduce_sum"] = mesh.all_reduce_sum(move).numpy()
    return out


# ---------------------------------------------------------------------------
# the worlds of tests/test_torch_distributed.py
# ---------------------------------------------------------------------------

def layout_world(mesh, pl):
    """The local-SGD layout: flat and sharded samplers, twice; the
    fixture fit's accuracy; the mesh retry; a layout checkpoint killed
    after its second save (resumed by the test at another P)."""
    import dataclasses

    import torch

    from repro_torch.configs.largevis_default import (CheckpointConfig,
                                                      LargeVisConfig)
    from repro_torch.core import layout, metrics, sampler
    from repro_torch.core.largevis import largevis, layout_graph
    from repro_torch.runtime.fault_tolerance import (DegradedModeWarning,
                                                     FaultInjector,
                                                     InjectedFault,
                                                     ShardFailedError)

    out = {}
    idx = torch.from_numpy(pl["idx"])
    w = torch.from_numpy(pl["w"])
    n = idx.shape[0]
    cfg = LargeVisConfig(**pl["layout_cfg"], distributed=True)
    es, ns = sampler.build_samplers_sharded(idx, w, mesh=mesh)
    ef = sampler.build_edge_sampler(idx, w)
    nf = sampler.build_negative_sampler(idx, w)
    for name, (e, g) in (("flat", (ef, nf)), ("sharded", (es, ns)),
                         ("sharded2", (es, ns))):
        gen = torch.Generator().manual_seed(3)
        res = layout.run_layout_local_sgd(gen, e, g, n, cfg, mesh)
        out[f"y_{name}"] = res.y.numpy()
        out[f"steps_{name}"] = np.array([res.steps, res.dispatches,
                                         res.edge_samples])
    if mesh.size == 1:      # a world of one is the single-device layout
        gen = torch.Generator().manual_seed(3)
        out["y_run_layout"] = layout.run_layout(gen, ef, nf, n, cfg,
                                                device="cpu").y.numpy()
    # the fixture's accuracy through largevis()
    fx = pl["fixture"]
    res = largevis(fx["x"], cfg=LargeVisConfig(**fx["cfg"],
                                               distributed=True),
                   device="cpu")
    out["fixture_acc"] = np.array(metrics.knn_classifier_accuracy(
        res.y, fx["labels"]))
    out["fixture_y"] = res.y.numpy()
    # the estimator, and routing.knn_stage="forest" (the single-device
    # forest for stage 1, the sharded weights after it)
    from repro_torch.api import LargeVis
    from repro_torch.configs.largevis_default import RoutingConfig
    from repro_torch.core.largevis import build_graph
    small = dataclasses.replace(cfg, samples_per_node=50)
    fitted = LargeVis(small, device="cpu").fit(pl["x"])
    out["fit_y"] = fitted.embedding_.numpy()
    out["largevis_y"] = largevis(pl["x"], cfg=small, device="cpu").y.numpy()
    forest = dataclasses.replace(cfg, routing=RoutingConfig(
        knn_stage="forest"))
    for name, c in (("forest", forest),
                    ("flat", dataclasses.replace(forest,
                                                 distributed=False))):
        fi, fd, fw, _ = build_graph(pl["x"], cfg=c, device="cpu")
        out.update({f"{name}_idx": fi.numpy(), f"{name}_dist": fd.numpy(),
                    f"{name}_w": fw.numpy()})
    # a shard fault at the first shard count of each stage kind
    for site in pl["fault_sites"]:
        with warnings.catch_warnings(record=True) as log:
            warnings.simplefilter("always")
            try:
                r = largevis(pl["x"], cfg=small, device="cpu",
                             fault=FaultInjector({site: {0: "exception"}}))
                out[f"fault_y_{site}"] = r.y.numpy()
                out[f"fault_err_{site}"] = np.array("")
            except ShardFailedError as e:
                out[f"fault_err_{site}"] = np.array(f"{e.stage}:{e.shard}")
        out[f"fault_warn_{site}"] = np.array(
            [str(m.message) for m in log
             if issubclass(m.category, DegradedModeWarning)] or [""])
    # a layout checkpoint, killed after its second save
    ck = dataclasses.replace(cfg, checkpoint=CheckpointConfig(
        pl["ckpt_dir"], every_chunks=pl["every"]))
    try:
        layout_graph(idx, w, cfg=ck, device="cpu",
                     fault=FaultInjector({"layout_saved": {1: "exception"}}))
        out["killed"] = np.array(False)
    except InjectedFault:
        out["killed"] = np.array(True)
    # resumed at the same shard count, and the same run uninterrupted
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        resumed, _ = layout_graph(idx, w, cfg=ck, device="cpu")
    out["resumed_y"] = resumed.y.numpy()
    out["resumed_steps"] = np.array(resumed.steps)
    out["resumed_warn"] = np.array(len(log))
    whole, _ = layout_graph(idx, w, cfg=cfg, device="cpu")
    out["whole_y"] = whole.y.numpy()
    # a checkpoint another shard count wrote (a copy each), resumed here
    if pl.get("foreign"):
        fk = dataclasses.replace(cfg, checkpoint=CheckpointConfig(
            pl["foreign"], every_chunks=pl["every"]))
        with warnings.catch_warnings(record=True) as log:
            warnings.simplefilter("always")
            res, _ = layout_graph(idx, w, cfg=fk, device="cpu")
        out["foreign_y"] = res.y.numpy()
        out["foreign_steps"] = np.array(res.steps)
        out["foreign_warn"] = np.array(
            [f"{m.category.__name__}: {m.message}" for m in log] or [""])
    return out


# ---------------------------------------------------------------------------
# the world of tests/test_torch_sharded_train.py
# ---------------------------------------------------------------------------

def _flat(tree, prefix: str) -> dict:
    """A nested dict of arrays as {prefix/path: array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def sharded_train_world(mesh, pl):
    """The sharded trainer at world P: two steps of each architecture at
    1 and 2 microbatches a rank (loss, parameters, the moments gathered
    and the rank's own blocks), ``restore(shardings=)`` of a tree mesh
    rank 0 saved, ``make_host_mesh``, and ``train(production=True)``: a
    world-1 save resumed here, and a fresh run that saves for the test
    to resume at world 1."""
    import torch

    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import (lm_params_from_numpy,
                                     lm_params_to_numpy, opt_state_to_numpy,
                                     train_state_to_numpy)
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import gather_moments, make_train_step
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.sharding import owned_blocks

    out = {}
    for name, jp in pl["params"].items():
        cfg = get_config(name + "-reduced")
        B, S = pl["batches"][0].shape[0], pl["batches"][0].shape[1] - 1
        for micro in (1, 2):
            p = lm_params_from_numpy(jp, cfg, "cpu")
            blocks = owned_blocks(p, cfg, mesh)
            st = adamw_init(p, blocks)
            step = make_train_step(cfg, ShapeConfig("c", "train", S, B),
                                   mesh=mesh, microbatches=micro)
            tag = f"{name}/m{micro}"
            for i, toks in enumerate(pl["batches"]):
                t = torch.from_numpy(toks)
                p, st, loss = step(p, st, {"tokens": t[:, :-1],
                                           "labels": t[:, 1:]})
                out[f"{tag}/loss{i}"] = np.asarray(float(loss))
                state = train_state_to_numpy(p, dict(st, **{
                    k: gather_moments(mesh, p, st[k], cfg)
                    for k in ("m", "v")}), cfg)
                out.update(_flat(state, f"{tag}/state{i}"))
                out.update(_flat(opt_state_to_numpy(st, cfg)["m"],
                                 f"{tag}/own_m{i}"))
            out[f"{tag}/blocks"] = np.array(
                [(-1, -1, -1) if b is None else b for b in blocks])
            sync = step.sync_ms()
            out[f"{tag}/sync"] = np.array([sync["grad_all_reduce"],
                                           sync["param_gather"]])
            out.update(_flat(lm_params_to_numpy(p, cfg), f"{tag}/final"))
    # restore(shardings=): every rank its block of a tree rank 0 saved
    if mesh.rank == 0:
        ck.save(pl["ckpt"] / "tree", 1, pl["tree"])
    mesh.barrier()
    shardings = {"w": (mesh, ("data", None)),
                 "nested": {"b": (mesh, (None,)), "scale": (mesh, ())},
                 "stack": (mesh, (None, "data", None))}
    got, _ = ck.restore(pl["ckpt"] / "tree", shardings=shardings)
    out.update(_flat({k: v for k, v in got.items() if k != "nested"},
                     "restored"))
    out.update(_flat(got["nested"], "restored/nested"))
    # make_host_mesh clamps data to the world; model > 1 raises
    out["host_mesh"] = np.array([make_host_mesh(4, device="cpu").size,
                                 make_host_mesh(1, device="cpu").size])
    try:
        make_host_mesh(1, 2, device="cpu")
        out["host_mesh_model"] = np.array("")
    except ValueError as e:
        out["host_mesh_model"] = np.array(str(e))
    # train(production=True): the world-1 save resumed, and a fresh run
    kw = dict(pl["train"], device="cpu", production=True, log_every=10**6)
    _, opt, losses = ttrain.train(**kw, steps=pl["steps"],
                                  ckpt_dir=str(pl["ckpt"] / "world1"))
    out["resumed_losses"] = np.array(losses)
    _, _, losses = ttrain.train(**kw, steps=pl["cut"], resume=False,
                                ckpt_dir=str(pl["ckpt"] / f"world{mesh.size}"))
    out["fresh_losses"] = np.array(losses)
    return out
