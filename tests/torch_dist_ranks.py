"""Multi-process worlds of the port's data mesh for the CPU tests.

``run_world(fn, P, tmp_path, payload)`` spawns P processes that join one
gloo process group (``init_method="file://..."`` under ``tmp_path``, so
concurrent test workers never share a port or a store), each with a
60 s timeout on the group; every rank calls ``fn(mesh, payload)`` (a
function of this module, picked by name) and its dict of numpy arrays
comes back through an ``.npz`` file.  A rank that raises, or a world that
outlives its deadline (twice the group's timeout unless the caller gives
one), fails the call.  This module imports no JAX, so a
rank starts with torch alone.
"""
from __future__ import annotations

import datetime
import time
import warnings
from pathlib import Path

import numpy as np

WORLD_TIMEOUT_S = 60
# the (data, model) meshes the sharded trainer's world asks make_host_mesh
HOST_MESH_ASKS = ((4, 1), (1, 1), (1, 2), (2, 2), (1, 4), (2, 1))
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
    return start_world(fn_name, P, tmp_path, payload)()


def start_world(fn_name: str, P: int, tmp_path, payload,
                deadline_s: float = 2 * WORLD_TIMEOUT_S):
    """Start the world and return a function that waits for it and gives
    :func:`run_world`'s result (the caller works meanwhile); the world
    fails as hung ``deadline_s`` after its start."""
    import torch.multiprocessing as mp

    tmp = Path(tmp_path) / f"world{P}_{fn_name}"
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(P, str(tmp), fn_name,
                                               payload),
                             nprocs=P, join=False, start_method="spawn")
    deadline = time.monotonic() + deadline_s

    def wait() -> list:
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"world {P} of {fn_name} hung")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(P)]

    return wait


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
    """The sharded trainer at world P, each rank holding its training
    blocks: two steps of each architecture at 1 and 2 microbatches a rank
    (loss, the state gathered whole, the rank's own moment blocks, the
    final parameters gathered whole), ``restore(shardings=)`` of a tree mesh
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
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.sharding import gather_tree

    out = {}
    for name, jp in pl["params"].items():
        cfg = get_config(name + "-reduced")
        B, S = pl["batches"][0].shape[0], pl["batches"][0].shape[1] - 1
        for micro in (1, 2):
            p = lm_params_from_numpy(jp, cfg, "cpu", mesh=mesh, train=True)
            st = adamw_init(p)
            step = make_train_step(cfg, ShapeConfig("c", "train", S, B),
                                   mesh=mesh, microbatches=micro)
            tag = f"{name}/m{micro}"
            for i, toks in enumerate(pl["batches"]):
                t = torch.from_numpy(toks)
                p, st, loss = step(p, st, {"tokens": t[:, :-1],
                                           "labels": t[:, 1:]})
                out[f"{tag}/loss{i}"] = np.asarray(float(loss))
                state = train_state_to_numpy(p, st, cfg, mesh=mesh)
                out.update(_flat(state, f"{tag}/state{i}"))
                out.update(_flat(opt_state_to_numpy(st, cfg)["m"],
                                 f"{tag}/own_m{i}"))
            out.update(_flat(lm_params_to_numpy(gather_tree(mesh, p, cfg),
                                                cfg), f"{tag}/final"))
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
    # make_host_mesh clamps data to the world, then model to world // data;
    # the rank's (data, model) index, row-major
    for data, model in HOST_MESH_ASKS:
        m = make_host_mesh(data, model, device="cpu")
        out[f"host_mesh_{data}x{model}"] = np.array(
            [m.shape["data"], m.shape["model"], m.axis_index("data"),
             m.axis_index("model")])
    # train(production=True): the world-1 save resumed, and a fresh run
    kw = dict(pl["train"], device="cpu", production=True, log_every=10**6)
    _, opt, losses = ttrain.train(**kw, steps=pl["steps"],
                                  ckpt_dir=str(pl["ckpt"] / "world1"))
    out["resumed_losses"] = np.array(losses)
    _, _, losses = ttrain.train(**kw, steps=pl["cut"], resume=False,
                                ckpt_dir=str(pl["ckpt"] / f"world{mesh.size}"))
    out["fresh_losses"] = np.array(losses)
    return out


# ---------------------------------------------------------------------------
# the world of tests/test_torch_tp_serve.py
# ---------------------------------------------------------------------------

def _mesh_collectives(mesh) -> dict:
    """Each collective along each axis of a (data, model) mesh, on
    tensors made from the rank's index."""
    import torch

    r = mesh.rank
    t = torch.arange(6, dtype=torch.float32) + 10 * r
    out = {"coords": np.array([mesh.axis_index("data"),
                               mesh.axis_index("model")])}
    for axis in ("data", "model", None):
        name = axis or "mesh"
        n = mesh.axis_size(axis)
        out[f"sum_{name}"] = mesh.all_reduce_sum(t, axis).numpy()
        out[f"gather_{name}"] = mesh.all_gather(t.view(2, 3), axis,
                                                dim=1).numpy()
        out[f"bcast_{name}"] = mesh.broadcast(t, n - 1, axis).numpy()
        x = torch.arange(n * 2 * 3, dtype=torch.float32).view(n * 2, 3) \
            + 100 * r
        out[f"a2a_{name}"] = mesh.all_to_all(x.view(n, 2, 3), axis, 0,
                                             1).numpy()
    return out


def tp_serve_world(_, pl):
    """The sharded serving steps at each case's ``(data, model)`` mesh:
    the rank's blocks of the weights, a prefill and ``steps`` decode
    steps (``make_prefill_step``/``make_decode_step``), the logits of
    each and the final cache rebuilt whole from the blocks; at (P, 1) the
    dense cases also on one device on the rank's rows (bitwise); one MoE
    layer per data shard at both routes; the mesh's collectives."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.launch.mesh import DataMesh, make_host_mesh
    from repro_torch.launch.steps import (decode_cache, make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import lm, moe, ssm
    from repro_torch.models.attention import kv_tp_repeat
    from repro_torch.models.factory import make_model
    from repro_torch.runtime import sharding as sh

    torch.set_num_threads(1)

    def gathered(tree, spec, prefix=""):
        """{path: the whole leaf} of a tree of the rank's blocks."""
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(gathered(v, spec[k], f"{prefix}/{k}"))
            else:
                out[f"{prefix}/{k}"] = sh.gather(mesh, v, spec[k])
        return out

    out = {}
    for c in pl["cases"]:
        D, M = c["mesh"]
        mesh = make_host_mesh(D, M, device="cpu")
        if not mesh.in_mesh:
            continue
        tag, cfg, B, S, n = c["tag"], c["cfg"], c["B"], c["S"], c["steps"]
        params = lm_params_from_numpy(pl["weights"][c["weights"]], cfg,
                                      "cpu", mesh=mesh)
        gathered_shapes = set()
        if c.get("own"):
            # the rank's blocks as held, and every tensor the steps
            # gather along "model" (by its block's shape)
            out.update(_flat(lm_params_to_numpy(params, cfg),
                             f"{tag}/own/params"))

            def logged(t, axis=None, _real=DataMesh.all_gather_list.__get__(
                    mesh)):
                if axis == "model":
                    gathered_shapes.add(tuple(t.shape))
                return _real(t, axis)
            mesh.all_gather_list = logged
        toks = torch.from_numpy(c["tokens"])
        shape = ShapeConfig("c", "prefill", S, B)
        step, _, (_, bl), outl = make_prefill_step(cfg, mesh, shape)
        batch = {"tokens": sh.block(toks[:, :S], bl["tokens"], mesh)}
        if "frames" in c:
            batch["encoder_frames"] = sh.block(torch.from_numpy(
                c["frames"]), bl["encoder_frames"], mesh)
        quant = bool(c.get("kv_quant"))
        if quant:                       # the prefill of an int8 cache
            logits, cache = lm.lm_prefill(
                params, cfg, batch["tokens"], kv_repeat=kv_tp_repeat(cfg, M),
                kv_quant=True, mesh=mesh,
                seq_parallel=not sh.covers_dp(mesh.shape, B))
            if outl[0][-1] is None:
                logits = mesh.all_gather(logits, "model", dim=-1)
            # the layout of a cache of S slots
            cache_l = make_decode_step(cfg, mesh, ShapeConfig(
                "c", "decode", S, B), kv_quant=True)[2][1]["cache"]
        else:
            logits, cache = step(params, batch)
            cache_l = outl[1]
        logit_list = [sh.gather(mesh, logits, outl[0])]
        pre_blocks = cache
        dshape = ShapeConfig("c", "decode", S + n, B)
        dstep, _, (_, dbl), doutl = make_decode_step(cfg, mesh, dshape,
                                                     kv_quant=quant)
        cache = decode_cache(cfg, mesh, dshape, cache, cache_l,
                             kv_quant=quant)
        # at (P, 1), a dense model on one device on the rank's rows
        plain = c.get("plain")
        if plain:
            p_logits, p_cache = lm.lm_prefill(params, cfg, batch["tokens"])
            bits = [torch.equal(p_logits, logits)] + [
                torch.equal(p_cache[p][k], pre_blocks[p][k])
                for p in p_cache for k in p_cache[p]]
            p_cache = {p: {k: t.clone() for k, t in e.items()}
                       for p, e in cache.items()}
        for i in range(n):
            pos = torch.full((B,), S + i, dtype=torch.int32)
            db = {"tokens": sh.block(toks[:, S + i:S + i + 1],
                                     dbl["tokens"], mesh),
                  "cache": cache,
                  "position": sh.block(pos, dbl["position"], mesh)}
            logits, cache = dstep(params, db)
            logit_list.append(sh.gather(mesh, logits, doutl[0]))
            if plain:
                p_logits, p_cache = lm.lm_decode(
                    params, cfg, db["tokens"], p_cache, db["position"])
                bits.append(torch.equal(p_logits, logits))
        if plain:
            bits += [torch.equal(p_cache[p][k], cache[p][k])
                     for p in cache for k in cache[p]]
            out[f"{tag}/plain_bitwise"] = np.array(bits)
        if c.get("own"):
            del mesh.all_gather_list
            out.update(_flat(cache, f"{tag}/own/cache"))
            out[f"{tag}/gathered_shapes"] = np.array(
                sorted(str(s_) for s_ in gathered_shapes) or [""])
        out[f"{tag}/logits"] = torch.stack(logit_list).numpy()
        out.update({f"{tag}/cache{k}": v.numpy()
                    for k, v in gathered(cache, doutl[1]).items()})
        out[f"{tag}/routes"] = np.array(sorted(moe.ROUTES) or [""])
        moe.ROUTES.clear()
    # one MoE layer at top-2 on each data shard's rows, both routes
    m = pl["moe"]
    mesh = make_host_mesh(*m["mesh"], device="cpu")
    cfg = m["cfg"]
    w = {k: sh.block(torch.from_numpy(v), sh.param_pspec(
        f"blocks/pos0/moe/{k}", v.shape, mesh.shape, train=False,
        stacked=False), mesh) for k, v in m["layer"].items()}
    for i, x in enumerate(m["xs"]):
        x = torch.from_numpy(x)
        spec = (("data",), None, None)
        y, aux = moe.moe_apply_sharded(w, sh.block(x, spec, mesh), cfg, mesh,
                                       mean_aux=True)
        out[f"moe{i}/y"] = sh.gather(mesh, y, spec).numpy()
        out[f"moe{i}/aux"] = aux.numpy()
        out[f"moe{i}/route"] = np.array(list(moe.ROUTES))
        moe.ROUTES.clear()
    out.update({f"mesh/{k}": v for k, v in _mesh_collectives(mesh).items()})
    # each (config, mesh) builds, or raises with its message
    errs = []
    for cfg, shape in pl["refused"]:
        try:
            make_model(cfg, mesh=make_host_mesh(*shape, device="cpu"))
            errs.append("")
        except ValueError as e:
            errs.append(str(e))
    out["refused"] = np.array(errs)
    # one mamba layer whose inner width does not divide "model": whole on
    # every rank (w_in's product gathered), prefill, decodes, gradients
    m = pl["mamba_whole"]
    mesh = make_host_mesh(*m["mesh"], device="cpu")
    cfg = m["cfg"]
    prefix = "blocks/pos0/mamba"
    w = sh.blocks_of({k: torch.from_numpy(v) for k, v in
                      m["weights"].items()}, mesh, prefix, stacked=False)
    x, xd = torch.from_numpy(m["x"]), torch.from_numpy(m["xd"])
    out["mamba_whole/w_in_cols"] = np.array(w["w_in"].shape[1])
    out["mamba_whole/conv_w_cols"] = np.array(w["conv_w"].shape[1])
    res, cache = ssm.mamba_prefill(w, x, cfg, mesh=mesh)
    outs = [res]
    for i in range(xd.shape[0]):
        res, cache = ssm.mamba_decode(w, xd[i], cfg, cache, mesh=mesh)
        outs.append(res)
    for i, o in enumerate(outs):
        out[f"mamba_whole/out{i}"] = o.numpy()
    for k, t in cache.items():
        out[f"mamba_whole/cache/{k}"] = t.numpy()
    wt = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ssm.mamba_fwd(wt, x, cfg, mesh=mesh).square().sum().backward()
    for k, t in wt.items():
        spec = sh.param_pspec(f"{prefix}/{k}", m["weights"][k].shape,
                              mesh.shape, train=False, stacked=False)
        out[f"mamba_whole/grad/{k}"] = sh.gather(mesh, t.grad, spec).numpy()
    return out


# ---------------------------------------------------------------------------
# the world of tests/test_torch_tp_train.py
# ---------------------------------------------------------------------------

def tp_train_world(_, pl):
    """The tensor-parallel trainer on each case's ``(data, model)`` mesh,
    the rank's training blocks of JAX-layout weights: ``steps`` steps of
    ``make_train_step`` on the case's batches (the state gathered whole
    after each, the rank's
    own blocks after the last, the losses, ``sync_ms``), a second run
    where asked; a case with ``blocks_only`` gives its blocks as cut and
    one step.  Then a (2, 2) save after two steps (mesh rank 0 writes)
    and a world-1 save resumed here for one step."""
    import torch

    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import (lm_params_from_numpy,
                                     lm_params_to_numpy, opt_state_from_numpy,
                                     opt_state_to_numpy, train_state_to_numpy)
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_step, make_train_step
    from repro_torch.optim.adamw import adamw_init

    torch.set_num_threads(1)
    B, S = pl["B"], pl["S"]
    shape = ShapeConfig("c", "train", S, B)

    def batch(i, batches=pl["batches"]):
        t = torch.from_numpy(batches[i])
        b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        if cfg.is_encoder_decoder:
            b["encoder_frames"] = torch.from_numpy(pl["frames"])
        return b

    def own(p, st):
        return {"params": lm_params_to_numpy(p, cfg),
                "m": opt_state_to_numpy(st, cfg)["m"]}

    out = {}
    for c in pl["cases"]:
        D, M = c["mesh"]
        mesh = make_host_mesh(D, M, device="cpu")
        tag, cfg = c["tag"], c["cfg"]
        for run in range(c["runs"]):
            p = lm_params_from_numpy(pl["weights"][c["name"]], cfg, "cpu",
                                     mesh=mesh, train=True)
            st = adamw_init(p)
            if run == 0:
                out.update(_flat(own(p, st), f"{tag}/init"))
            step = make_train_step(cfg, shape, mesh=mesh,
                                   microbatches=c["micro"])
            for i in range(c["steps"]):
                p, st, loss = step(p, st, batch(i, c["batches"]))
                out[f"{tag}/run{run}/loss{i}"] = np.asarray(float(loss))
                out.update(_flat(train_state_to_numpy(p, st, cfg, mesh=mesh),
                                 f"{tag}/run{run}/state{i}"))
            if run == 0:
                out.update(_flat(own(p, st), f"{tag}/own"))
                sync = step.sync_ms()
                out[f"{tag}/sync"] = np.array([sync[k] for k in
                                               sorted(sync)])
                out[f"{tag}/sync_kinds"] = np.array(sorted(sync))
        for save in c.get("saves", ()):
            tree = train_state_to_numpy(p, st, cfg, mesh=mesh)
            if mesh.rank == 0:
                ck.save(save, c["steps"], tree)
            mesh.barrier()
    # a world-1 save of the resume case, resumed on (2, 2) for one step
    r = pl["resume"]
    mesh = make_host_mesh(2, 2, device="cpu")
    cfg = r["cfg"]
    state, at = ck.restore(r["dir"], shardings=ttrain.state_shardings(
        ck.shapes(r["dir"], r["step"]), mesh))
    p = lm_params_from_numpy(state["params"], cfg, "cpu")
    st = opt_state_from_numpy(state["opt"], cfg, "cpu")
    step = make_step(cfg, mesh, shape)
    _, _, loss = step(p, st, batch(at))
    out["resumed/loss"] = np.asarray(float(loss))
    out["resumed/at"] = np.asarray(at)
    # the trainer on (2, 2): saves, for the test to resume at world 1
    _, _, losses = ttrain.train(**pl["train"], device="cpu",
                                production=True, mesh_shape=(2, 2),
                                log_every=10**6)
    out["train/losses"] = np.array(losses)
    return out


# ---------------------------------------------------------------------------
# the world of tests/test_torch_launch.py
# ---------------------------------------------------------------------------

def largevis_round_world(mesh, pl):
    """One round of ``run_layout_local_sgd`` on the edge tables of
    ``build_samplers_sharded``, with its two-level negative sampler and
    with the flat one, and the same round through
    ``make_largevis_step_sharded`` and ``make_largevis_step_local`` (the
    rank's rows of the stacked tables, flattened for the local builder)
    from the fit's start, stream and lrs: the four layouts."""
    import torch

    from repro_torch.core import layout, layout_engine
    from repro_torch.core.sampler import (build_negative_sampler,
                                          build_samplers_sharded)
    from repro_torch.launch import steps

    cfg = pl["cfg"]
    knn = torch.from_numpy(pl["knn"])
    w = torch.from_numpy(pl["w"])
    n = knn.shape[0]
    P, r = mesh.size, mesh.rank
    es, ns = build_samplers_sharded(knn, w, mesh=mesh)
    flat_ns = build_negative_sampler(knn, w)
    batch = max(1, layout._collision_capped_batch(cfg.batch_size * P, n)
                // P)
    total = max(1, int(cfg.samples_per_node) * n // (batch * P))
    lrs = layout_engine.lr_table(cfg.rho0, total, "cpu")[:cfg.sync_every]
    kw = dict(n_nodes=n, n_edges=es.src.numel(), batch=batch * P,
              n_negatives=cfg.n_negatives, sync_every=cfg.sync_every)
    edge = (es.src, es.dst, es.threshold, es.alias)
    out = {}
    for name, neg, builder, tables in (
            ("sharded", ns, steps.make_largevis_step_sharded,
             [t[r:r + 1] for t in edge] + [ns.threshold, ns.alias,
                                           ns.shard_threshold,
                                           ns.shard_alias]),
            ("local", flat_ns, steps.make_largevis_step_local,
             [t[r] for t in edge] + [flat_ns.threshold, flat_ns.alias])):
        fit = layout.run_layout_local_sgd(
            torch.Generator().manual_seed(pl["seed"]), es, neg, n, cfg, mesh)
        out[f"fit_{name}"] = fit.y.numpy().copy()
        out[f"steps_{name}"] = np.asarray(fit.steps)
        step, *_ = builder(mesh, **kw)
        gen = torch.Generator().manual_seed(pl["seed"])
        y = torch.randn((n, cfg.out_dim), generator=gen) * cfg.init_scale
        seed = int(torch.randint(0, 2**62, (1,), generator=gen))
        step(y, torch.tensor([0], dtype=torch.int32), None, *tables,
             generator=layout._rank_generator("cpu", seed, r), lrs=lrs)
        out[name] = y.numpy().copy()
    return out
