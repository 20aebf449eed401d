"""The distributed fit, or the sharded trainer, on P cards of one host
over NCCL, held against a world of one.

    python3 tools/distributed_check.py --world 4
    python3 tools/distributed_check.py --world 4 --train
    python3 tools/distributed_check.py --world 4 --serve
    python3 tools/distributed_check.py --train --mesh 2 2
    python3 tools/distributed_check.py --serve --arch jamba-v0.1-52b

Spawns P ranks, one a card, joined over NCCL (``tcp://localhost`` on a
free port, a timeout on the group and on the joins); each calls
``largevis(x, cfg=LargeVisConfig(distributed=True))`` at the defaults
(K = 150, 8 trees, perplexity 50, M = 5, batch 4096, sync every step)
on the smoke run's data (a 10-cluster Gaussian mixture, N = 100,000,
d = 100), then times one ``DataMesh.all_reduce_sum`` of y (the
local-SGD sync) and one ``ring_shift`` of its slab.  This process then
fits the same data on a world of one (card 0) and requires the ranks'
graph, distances and weights to be bitwise its, every rank's y to be
the same, and the 5-NN accuracy of both layouts to be >= 0.95.  The
kernels are built here before the ranks start.  It prints the cards'
names and power limits, a line a world, and last one JSON object of
the numbers.  ``--samples-per-node`` cuts the layout's depth (printed
as ``cut:``).  Exits non-zero if a rank fails or a check does not hold.

``--train``: each rank calls ``train(production=True)`` at
``chip_smoke.py``'s trainer settings (qwen1.5-0.5b at full width and
depth, its batch of 4096-token rows, its steps and AdamW settings), one
microbatch a rank; this process then trains on card 0 at world 1 with P
microbatches, and the ranks' losses and every final leaf must be its
bits.  It prints each world's ms a step, the ranks' sync ms
(the gradient all-reduce, the parameter gather) and peak memory.

``--train --mesh 2 2`` (four cards): the tensor-parallel trainer over
NCCL, one rank a card on a (data 2, model 2) mesh
(``chip_smoke.py::_tpt_rank``): llama3-8b at full width and depth (8.03B
parameters; each rank holds its training blocks of the parameters, the
gradients and both moments, about 32 GB), ``MESH_STEPS`` steps of 4 x 4096
tokens, two microbatches of one row a rank, bf16 with f32 master
weights: ms a step, the collectives' ms (``sync_ms``), peak memory and
the losses a rank, the flash launches.

``--serve --arch ARCH`` (four cards): ARCH at full width and depth on a
(data 2, model 2) mesh over NCCL, one rank a card (jamba-v0.1-52b: its
32 layers, about 26 GB of bf16 weights a rank, drawn from a seed and cast
as each block is cut): 2 prompts of 4096 tokens and 8 greedy decode
steps, three runs (a warm-up, a timed run, one with each collective
synchronised and timed): the weights and peak a rank, prefill ms, decode
ms a step, tokens/s, the collectives' ms by kind and axis (the
``"model"`` sums, the ``"data"`` all-to-alls, the ``"model"`` exchanges
of mamba's u and z), the flash launches a prefill a rank (its attention
layers'), and every rank's greedy tokens, which must be the same.

``--serve`` (four cards): ``chip_smoke.py``'s sharded serving phase over
NCCL, one rank a card on a (data 2, model 2) mesh: mixtral-8x7b at full
width, first its check at ``TP_LAYERS`` layers (f32, total routing,
against world 1 on card 0, the flash launches, two bf16 runs bitwise),
then at full depth (32 layers, about 23.5 GB of bf16 weights a rank): the
bf16 prefill and decode ms, tokens/s, the collectives' ms and peak memory
a rank.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as smoke  # noqa: E402  (the trainer's settings, helpers)

N_POINTS, DIM, CLUSTERS = 100_000, 100, 10
TIMEOUT_S = 600
SYNC_REPS = 50
MESH_STEPS = 3            # --train --mesh 2 2: llama3-8b's steps


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _timed(torch, fn, reps: int) -> float:
    """ms a call of ``fn``, the card synchronised around the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _rank(rank: int, world: int, port: int, out_dir: str, spn: int):
    import torch
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        from repro_torch import LargeVisConfig, largevis
        from repro_torch.core import metrics
        from repro_torch.data.synthetic import gaussian_mixture
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_data_mesh
        from repro_torch.runtime import sharding as sh

        xn, labels = gaussian_mixture(0, N_POINTS, DIM, CLUSTERS)
        x = torch.from_numpy(xn).cuda()
        cfg = LargeVisConfig(distributed=True, samples_per_node=spn)
        mesh = make_data_mesh(0, device="cuda")
        assert mesh.size == world and mesh.backend == "nccl", mesh
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = largevis(x, cfg=cfg, device="cuda")
        fit_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        sync_ms = _timed(torch, lambda: mesh.all_reduce_sum(res.y),
                         SYNC_REPS)
        slab = sh.shard_rows(x, mesh)
        shift_ms = _timed(torch, lambda: mesh.ring_shift(slab), SYNC_REPS)
        t = res.timings
        out = dict(y=res.y.cpu().numpy(), fit_s=fit_s, peak=peak,
                   sync_ms=sync_ms, shift_ms=shift_ms, steps=res.steps,
                   dispatches=res.dispatches,
                   topk=counts["topk_sqdist"],
                   fused=counts["fused_edge_step"],
                   acc=metrics.knn_classifier_accuracy(res.y, labels),
                   **{k: t[k] for k in ("knn_s", "knn_ring_s",
                                        "knn_explore_s", "weights_s",
                                        "sampler_s", "layout_s")})
        if rank == 0:
            out.update(idx=res.knn_idx.cpu().numpy(),
                       dist=res.knn_dist.cpu().numpy(),
                       w=res.weights.cpu().numpy(),
                       recall=metrics.graph_recall(res.x, res.knn_idx))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _train_run(torch, **kw) -> dict:
    """``train(**kw)`` at ``chip_smoke.py``'s trainer settings: the losses,
    a hash of every final leaf, ms a step, the sharded step's sync ms,
    peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.optim.adamw import AdamWConfig

    step_ms, sync = [], []
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, \
            smoke._timed_steps(torch, train_mod, step_ms, sync):
        params, _, losses = train_mod.train(
            smoke.TRAIN_ARCH, steps=smoke.TRAIN_STEPS,
            batch=smoke.TRAIN_BATCH, seq=smoke.TRAIN_SEQ, reduced=False,
            resume=False, ckpt_dir=tmp, log_every=10**6,
            opt_cfg=AdamWConfig(lr=smoke.TRAIN_LR,
                                warmup_steps=smoke.TRAIN_WARMUP), **kw)
    hashes = smoke.whole_hashes(params, get_config(smoke.TRAIN_ARCH)) \
        if kw.get("production") else smoke.leaf_hashes(params)
    return {"losses": [x for _, x in losses], "hashes": hashes,
            "step_ms": step_ms, "sync": sync,
            "peak": torch.cuda.max_memory_allocated()}


def _train_rank(rank: int, world: int, port: int, out_dir: str):
    import torch
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = _train_run(torch, production=True, microbatches=1)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _steady(r: dict) -> str:
    ms = r["step_ms"][1:]
    return (f"{sum(ms) / len(ms):.1f} ms a step after the first, "
            f"{smoke.TRAIN_BATCH * smoke.TRAIN_SEQ / (sum(ms) / len(ms))
               * 1e3:.0f} "
            f"tokens/s, peak {r['peak'] / 2**30:.2f} GiB a rank")


def main_train(torch, mp, P: int) -> None:
    """``--train``: world P over NCCL against world 1 at P microbatches."""
    from repro_torch.core.largevis import resolve_device
    from repro_torch.kernels import _build

    resolve_device("cuda")
    _build.build("flash_attention", "flash_attention_bwd")
    tmp = tempfile.TemporaryDirectory()
    ctx = mp.start_processes(_train_rank, args=(P, _free_port(), tmp.name),
                             nprocs=P, join=False, start_method="spawn")
    deadline = time.monotonic() + 2 * TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                sys.exit(f"the {P} ranks did not finish in {2 * TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [json.loads(Path(tmp.name, f"rank{r}.json").read_text())
             for r in range(P)]
    tmp.cleanup()
    print(f"world {P} over NCCL, {smoke.TRAIN_ARCH} at full width and "
          f"depth, batch {smoke.TRAIN_BATCH} x {smoke.TRAIN_SEQ}, 1 "
          f"microbatch a rank, {smoke.TRAIN_STEPS} steps: "
          f"{_steady(ranks[0])}; sync ms a step "
          f"{smoke.sync_line(ranks[0]['sync'][1:])}; losses "
          f"{ranks[0]['losses']}", flush=True)
    one = _train_run(torch, microbatches=P)
    print(f"world 1 on card 0, {P} microbatches: {_steady(one)}; losses "
          f"{one['losses']}", flush=True)
    same = [r["losses"] == one["losses"] and r["hashes"] == one["hashes"]
            for r in ranks]
    differ = sorted(n for n, h in one["hashes"].items()
                    if ranks[0]["hashes"].get(n) != h)
    print(f"world {P} against world 1: losses and all {len(one['hashes'])} "
          f"final leaves bitwise on ranks "
          f"{[i for i, x in enumerate(same) if x]}; leaves that differ on "
          f"rank 0: {len(differ)} {differ[:5]}", flush=True)
    print(json.dumps({"world": P, "train": True, "ok": all(same),
                      "world_ms": ranks[0]["step_ms"],
                      "one_ms": one["step_ms"], "sync_ms": ranks[0]["sync"],
                      "peak": ranks[0]["peak"],
                      "one_peak": one["peak"]}))
    if not all(same):
        sys.exit(1)


def main_train_mesh(torch) -> None:
    """``--train --mesh 2 2``: llama3-8b at full depth trained
    tensor-parallel over NCCL, one rank a card."""
    from repro_torch.configs import get_config
    from repro_torch.core.largevis import resolve_device
    from repro_torch.kernels import _build

    arch, mesh, steps = "llama3-8b", smoke.TPT_MESH, MESH_STEPS
    layers = get_config(arch).n_layers
    resolve_device("cuda")
    _build.build("flash_attention", "flash_attention_bwd")
    spec = smoke.tpt_spec(arch, layers, batch=4, steps=steps,
                          microbatches=2, check_a=False, bf16_runs=1)
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    ranks = smoke.spawn_tpt(torch, tmp.name, spec, backend="nccl",
                            init=f"tcp://localhost:{_free_port()}")
    tmp.cleanup()
    runs = [rk["b"][0] for rk in ranks]
    per_step = {"flash_attention": 2 * 2 * layers,
                "flash_attention_bwd": 2 * layers}
    same = all(r["losses"] == runs[0]["losses"] for r in runs)
    ok = same and all(r["launches"][k] == n * steps for r in runs
                      for k, n in per_step.items()) and \
        all(np.isfinite(r["losses"]).all() for r in runs)
    print(f"tensor-parallel trainer over NCCL, (data 2, model 2), {arch} "
          f"at full width and depth ({layers} layers), {steps} steps of 4 x "
          f"{smoke.TRAIN_SEQ} tokens, 2 microbatches of 1 row a rank "
          f"({time.perf_counter() - t0:.1f} s with the ranks' start and "
          f"init; init {runs[0]['init_s']:.1f} s): "
          f"{smoke.tpt_line(ranks, spec)}; the ranks' losses equal: "
          f"{same}; flash launches a step expected {per_step}", flush=True)
    print(json.dumps({"mesh": list(mesh), "train": True, "arch": arch,
                      "layers": layers, "ok": ok,
                      "step_ms": [r["step_ms"] for r in runs],
                      "sync_ms": [r["sync"] for r in runs],
                      "peak_gib": [r["peak_gib"] for r in runs],
                      "state_gib": [r["state_gib"] for r in runs],
                      "losses": runs[0]["losses"]}))
    if not ok:
        sys.exit(1)


def main_serve(torch, P: int) -> None:
    """``--serve``: the (2, 2) serving mesh over NCCL, at ``TP_LAYERS``
    against world 1 and then at full depth."""
    from repro_torch.core.largevis import resolve_device
    from repro_torch.kernels import _build

    if P != smoke.TP_MESH[0] * smoke.TP_MESH[1]:
        sys.exit(f"--serve runs the {smoke.TP_MESH} mesh: --world 4")
    resolve_device("cuda")
    _build.build("flash_attention")
    tmp = tempfile.TemporaryDirectory()
    w1 = smoke.tp_world1(torch, tmp.name)
    t0 = time.perf_counter()
    ranks = smoke.spawn_tp_serve(torch, tmp.name, backend="nccl",
                                 n_layers=smoke.TP_LAYERS, check_a=True,
                                 init=f"tcp://localhost:{_free_port()}")
    a = smoke.tp_check_a(tmp.name)
    same = all(len({x["hash"] for x in r["b"]}) == 1 for r in ranks)
    launches = [[r["a"]["launches"]] + [x["launches"] for x in r["b"]]
                for r in ranks]
    ok_a = same and all(x == [smoke.TP_LAYERS] * 4 for x in launches)
    print(f"serving mesh (data 2, model 2) over NCCL, {smoke.TP_LAYERS} "
          f"layers ({time.perf_counter() - t0:.1f} s; world 1 "
          f"{w1['s']:.1f} s): f32 total routing against world 1: logits "
          f"rel {a['logits']:.3g}, cache leaves {a['cache']} (bound "
          f"{smoke.TP_REL_TOL}); flash launches a prefill {launches}; the "
          f"bf16 runs bitwise equal: {same}", flush=True)
    print(f"bf16 top-2, {smoke._tp_line(ranks, smoke.TP_LAYERS)}",
          flush=True)
    full = 32
    t0 = time.perf_counter()
    deep = smoke.spawn_tp_serve(torch, tmp.name, backend="nccl",
                                n_layers=full, check_a=False,
                                init=f"tcp://localhost:{_free_port()}")
    tmp.cleanup()
    same_deep = all(len({x["hash"] for x in r["b"]}) == 1 for r in deep)
    ok_deep = same_deep and all(x["launches"] == full for r in deep
                                for x in r["b"])
    print(f"full depth ({time.perf_counter() - t0:.1f} s with the ranks' "
          f"start and init), bf16 top-2, {smoke._tp_line(deep, full)}; the "
          f"runs bitwise equal: {same_deep}", flush=True)
    _, r, t = deep[0]["b"]
    dec = sum(r["decode_ms"]) / len(r["decode_ms"])
    print(json.dumps({"world": P, "serve": True, "ok": ok_a and ok_deep,
                      "rel_logits": a["logits"],
                      "prefill_ms": r["prefill_ms"], "decode_ms": dec,
                      "peak_gib": [x["b"][1]["peak_gib"] for x in deep],
                      "weights_gib": [x["weights_gib"] for x in deep],
                      "prefill_coll_ms": t["prefill_coll_ms"],
                      "decode_coll_ms": t["decode_coll_ms"]}))
    if not (ok_a and ok_deep):
        sys.exit(1)


SERVE_ARCH_PROMPT = 4096      # --serve --arch: 2 prompts of 4096 tokens


def _serve_arch_rank(rank: int, world: int, port: int, out_dir: str,
                     arch: str) -> None:
    """One rank of ``--serve --arch``: ``arch`` at full width and depth on
    the (data 2, model 2) mesh over NCCL, bf16 (its blocks drawn from a
    seed and cast as they are cut), two prompts of ``SERVE_ARCH_PROMPT``
    tokens and ``smoke.TP_DECODE`` greedy decode steps, three runs: a
    warm-up, a timed run, and a run with each collective synchronised and
    timed.  Writes the ms, tokens, peak, flash launches and collectives'
    ms."""
    import torch
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    out = {}
    try:
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.core.largevis import resolve_device, seeded_generator
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.steps import (decode_cache,
                                              make_decode_step,
                                              make_prefill_step)
        from repro_torch.models.factory import make_model
        from repro_torch.runtime import sharding as sh

        resolve_device("cuda")
        mesh = make_host_mesh(*smoke.TP_MESH, device="cuda")
        dev = mesh.device
        cfg = get_config(arch)
        B, S, n = 2, SERVE_ARCH_PROMPT, smoke.TP_DECODE
        t0 = time.perf_counter()
        params = make_model(cfg, mesh=mesh)["init"](
            seeded_generator(dev, 7), inference=True)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        out["weights_gib"] = sum(p.numel() * p.element_size()
                                 for p in params.parameters()) / 2**30
        torch.cuda.empty_cache()
        pstep, _, (_, pl), pout = make_prefill_step(
            cfg, mesh, ShapeConfig("serve", "prefill", S, B))
        dshape = ShapeConfig("serve", "decode", S + n, B)
        dstep, _, (_, dl), dout = make_decode_step(cfg, mesh, dshape)
        toks = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                             generator=seeded_generator(dev, 11))
        frames = {}
        if cfg.is_encoder_decoder:
            f = torch.randn((B, cfg.enc_positions, cfg.d_model), device=dev,
                            generator=seeded_generator(dev, 13))
            frames = {"encoder_frames": sh.block(f.to(cfg.dtype),
                                                 pl["encoder_frames"], mesh)}

        def run(ms):
            ms.clear()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t = time.perf_counter()
            logits, pre = pstep(params, {
                "tokens": sh.block(toks, pl["tokens"], mesh), **frames})
            nxt = sh.gather(mesh, logits, pout[0]).argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            r = {"prefill_ms": (time.perf_counter() - t) * 1e3,
                 "launches": ops.launch_counts()["flash_attention"],
                 "prefill_coll_ms": dict(ms)}
            ms.clear()
            cache = decode_cache(cfg, mesh, dshape, pre, pout[1])
            del pre
            got, dec = [nxt], []
            for i in range(n - 1):
                pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, cache = dstep(params, {
                    "tokens": sh.block(nxt, dl["tokens"], mesh),
                    "cache": cache,
                    "position": sh.block(pos, dl["position"], mesh)})
                nxt = sh.gather(mesh, logits, dout[0]).argmax(-1,
                                                              keepdim=True)
                torch.cuda.synchronize()
                dec.append((time.perf_counter() - t) * 1e3)
                got.append(nxt)
            r["decode_ms"] = dec
            r["decode_coll_ms"] = {k: v / len(dec) for k, v in ms.items()}
            r["tokens"] = torch.cat(got, 1).tolist()
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            return r

        ms = {}
        runs = []
        for timed in (False, False, True):
            if timed:
                smoke._timed_collectives(torch, mesh, ms)
            torch.cuda.reset_peak_memory_stats()
            runs.append(run(ms))
        out["runs"] = runs
        out["coords"] = [mesh.axis_index("data"), mesh.axis_index("model")]
    finally:
        Path(out_dir, f"serve_rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()


def main_serve_arch(torch, mp, arch: str) -> None:
    """``--serve --arch ARCH``: ``arch`` at full width and depth on four
    cards over NCCL, (data 2, model 2); every rank's greedy tokens must be
    the same, and the flash launches a prefill a rank its attention
    layers'."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    _build.build("flash_attention")
    cfg = get_config(arch)
    attn_layers = sum(k in ("attn", "local", "global")
                      for k in cfg.block_pattern) * cfg.n_periods
    if cfg.is_encoder_decoder:
        attn_layers = cfg.n_layers
    P = smoke.TP_MESH[0] * smoke.TP_MESH[1]
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    ctx = mp.start_processes(_serve_arch_rank,
                             args=(P, _free_port(), tmp.name, arch),
                             nprocs=P, join=False, start_method="spawn")
    deadline = time.monotonic() + 2 * TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                sys.exit(f"the {P} ranks did not finish in {2 * TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [json.loads(Path(tmp.name, f"serve_rank{r}.json").read_text())
             for r in range(P)]
    tmp.cleanup()
    wall = time.perf_counter() - t0
    tokens = [r["tokens"] for rk in ranks for r in rk["runs"]]
    same = all(t == tokens[0] for t in tokens)
    launches = [r["launches"] for rk in ranks for r in rk["runs"]]
    ok = same and all(x == attn_layers for x in launches)
    B, S = 2, SERVE_ARCH_PROMPT
    parts = []
    for i, rk in enumerate(ranks):
        _, r, t = rk["runs"]
        dec = sum(r["decode_ms"]) / len(r["decode_ms"])
        pre = {k: round(v, 2) for k, v in sorted(t["prefill_coll_ms"].items())}
        dco = {k: round(v, 3) for k, v in sorted(t["decode_coll_ms"].items())}
        parts.append(
            f"rank {i} {tuple(rk['coords'])}: weights "
            f"{rk['weights_gib']:.2f} GiB (init {rk['init_s']:.1f} s), peak "
            f"{r['peak_gib']:.2f} GiB; prefill {r['prefill_ms']:.1f} ms "
            f"({B * S / r['prefill_ms'] * 1e3:.0f} tokens/s for the mesh), "
            f"decode {dec:.2f} ms a step ({B / dec * 1e3:.1f} tokens/s); "
            f"timed run: prefill {t['prefill_ms']:.1f} ms, collectives ms "
            f"{pre}, decode {sum(t['decode_ms']) / len(t['decode_ms']):.2f} "
            f"ms a step, collectives ms a step {dco}; flash launches "
            f"{r['launches']} a prefill")
    print(f"{arch} at full width and depth ({cfg.n_layers} layers), bf16, "
          f"(data 2, model 2) over NCCL, 2 x {S} tokens + "
          f"{smoke.TP_DECODE} greedy tokens ({wall:.1f} s with the ranks' "
          f"start and init): " + "; ".join(parts) + f"; every rank's and "
          f"run's greedy tokens the same: {same} (row 0: "
          f"{tokens[0][0]}); flash launches a prefill a rank expected "
          f"{attn_layers}", flush=True)
    _, r, t = ranks[0]["runs"]
    print(json.dumps({"serve": True, "arch": arch, "ok": ok,
                      "layers": cfg.n_layers,
                      "prefill_ms": [rk["runs"][1]["prefill_ms"]
                                     for rk in ranks],
                      "decode_ms": [sum(rk["runs"][1]["decode_ms"]) /
                                    len(rk["runs"][1]["decode_ms"])
                                    for rk in ranks],
                      "peak_gib": [rk["runs"][1]["peak_gib"] for rk in ranks],
                      "weights_gib": [rk["weights_gib"] for rk in ranks],
                      "prefill_coll_ms": t["prefill_coll_ms"],
                      "decode_coll_ms": t["decode_coll_ms"],
                      "launches": launches, "tokens": tokens[0]}))
    if not ok:
        sys.exit(1)


def _line(what: str, r: dict) -> str:
    return (f"{what}: {float(r['fit_s']):.2f} s (knn_s "
            f"{float(r['knn_s']):.3f} = ring {float(r['knn_ring_s']):.3f} "
            f"+ explore {float(r['knn_explore_s']):.3f}, weights_s "
            f"{float(r['weights_s']):.3f}, sampler_s "
            f"{float(r['sampler_s']):.3f}, layout_s "
            f"{float(r['layout_s']):.3f}; {int(r['steps'])} steps a rank in "
            f"{int(r['dispatches'])} dispatches), knn_classifier_accuracy "
            f"{float(r['acc']):.4f}, peak memory a rank "
            f"{int(r['peak']) / 2**30:.2f} GiB, launches a rank: "
            f"topk_sqdist {int(r['topk'])}, fused_edge_step "
            f"{int(r['fused'])}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--samples-per-node", type=int, default=10_000)
    ap.add_argument("--train", action="store_true",
                    help="the sharded trainer instead of the fit")
    ap.add_argument("--serve", action="store_true",
                    help="the sharded serving mesh (data 2, model 2)")
    ap.add_argument("--arch", default=None,
                    help="with --serve: this architecture at full width "
                    "and depth on the (2, 2) mesh instead of chip_smoke's "
                    "mixtral phase (e.g. jamba-v0.1-52b)")
    ap.add_argument("--mesh", nargs=2, choices=["2"], default=None,
                    help="with --train: the tensor-parallel trainer on the "
                    "(data 2, model 2) mesh, the only one it runs")
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    P = 4 if args.mesh else args.world
    if torch.cuda.device_count() < P:
        sys.exit(f"{P} ranks need {P} cards; {torch.cuda.device_count()} "
                 "found")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.train and args.mesh:
        main_train_mesh(torch)
        return
    if args.train:
        main_train(torch, mp, P)
        return
    if args.serve and args.arch:
        main_serve_arch(torch, mp, args.arch)
        return
    if args.serve:
        main_serve(torch, P)
        return
    if args.samples_per_node != 10_000:
        print(f"cut: samples_per_node 10000 -> {args.samples_per_node}",
              flush=True)
    from repro_torch import LargeVisConfig, largevis
    from repro_torch.core import metrics
    from repro_torch.core.largevis import resolve_device
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.mesh import make_data_mesh

    t0 = time.perf_counter()
    _build.build("knn_topk", "largevis_step", "largevis_grad")
    print(f"kernel build: {time.perf_counter() - t0:.2f} s", flush=True)
    tmp = tempfile.TemporaryDirectory()
    ctx = mp.start_processes(
        _rank, args=(P, _free_port(), tmp.name, args.samples_per_node),
        nprocs=P, join=False, start_method="spawn")
    deadline = time.monotonic() + 2 * TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                sys.exit(f"the {P} ranks did not finish in {2 * TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [dict(np.load(Path(tmp.name) / f"rank{r}.npz"))
             for r in range(P)]
    tmp.cleanup()
    for r in ranks[1:]:
        assert np.array_equal(r["y"], ranks[0]["y"]), "the replicas differ"
    print(_line(f"world {P} over NCCL", ranks[0]) + f"; graph_recall "
          f"{float(ranks[0]['recall']):.4f}; one sync of y (DataMesh."
          f"all_reduce_sum) {float(ranks[0]['sync_ms']):.3f} ms, one ring "
          f"shift of a slab {float(ranks[0]['shift_ms']):.3f} ms; every "
          f"rank's y the same", flush=True)

    dev = resolve_device("cuda")
    xn, labels = gaussian_mixture(0, N_POINTS, DIM, CLUSTERS)
    x = torch.from_numpy(xn).to(dev)
    cfg = LargeVisConfig(distributed=True,
                         samples_per_node=args.samples_per_node)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one = largevis(x, cfg=cfg, device="cuda")
    fit_s = time.perf_counter() - t0
    mesh = make_data_mesh(0, device="cuda")
    counts = ops.launch_counts()
    r1 = dict(fit_s=fit_s, peak=torch.cuda.max_memory_allocated(),
              steps=one.steps, dispatches=one.dispatches,
              topk=counts["topk_sqdist"], fused=counts["fused_edge_step"],
              acc=metrics.knn_classifier_accuracy(one.y, labels),
              **one.timings)
    print(_line(f"world 1 over {mesh.backend}", r1), flush=True)
    diffs = {k: int((ranks[0][k] != getattr(one, f).cpu().numpy()).sum())
             for k, f in (("idx", "knn_idx"), ("dist", "knn_dist"),
                          ("w", "weights"))}
    print(f"world {P} against world 1: entries that differ {diffs}",
          flush=True)
    torch.distributed.destroy_process_group()
    ok = (not any(diffs.values()) and float(ranks[0]["acc"]) >= 0.95
          and r1["acc"] >= 0.95)
    keys = ("fit_s", "knn_s", "knn_ring_s", "knn_explore_s", "weights_s",
            "sampler_s", "layout_s", "acc", "peak", "steps", "topk",
            "fused")
    print(json.dumps({
        "world": P, "ok": ok, "graph_diffs": diffs,
        "sync_ms": float(ranks[0]["sync_ms"]),
        "shift_ms": float(ranks[0]["shift_ms"]),
        "recall": float(ranks[0]["recall"]),
        "ranks": {k: float(ranks[0][k]) for k in keys},
        "one": {k: float(r1[k]) for k in keys}}))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
