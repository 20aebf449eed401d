"""Serve a batch of prompts on a ``(data, model)`` mesh: the sharded
prefill and greedy decode steps (``launch/steps.py``), one process a
device.

    torchrun --nproc_per_node=4 -m repro_torch.launch.serve_mesh \\
        --arch mixtral-8x7b --mesh 2 2
    torchrun --nproc_per_node=4 -m repro_torch.launch.serve_mesh \\
        --arch jamba-v0.1-52b --mesh 2 2      # or xlstm-125m, whisper-tiny

Each rank takes the card of its ``LOCAL_RANK`` (NCCL), or the CPU with
``--device cpu`` (gloo); the world's address comes from ``torchrun``'s
environment.  The model is the config at its full depth (or its reduced
form, ``--reduced``), with random weights drawn from seed 0 layer by
layer (each rank keeps its blocks, each cast to the compute dtype as it
is cut); the
batch is 2 random prompts of ``--prompt`` tokens, of which 8 new tokens
are decoded (a batch that does not cover ``"data"`` decodes
sequence-parallel); an encoder-decoder (whisper-tiny) also takes random
encoder frames (2, its 1,500 positions, d) from the seed.  Any of the ten
architectures serves (jamba's mamba layers take a prompt of at most 256
tokens or a multiple of 256).  Mesh rank 0 prints the prefill's and the decode
steps' ms, tokens/s, peak memory a rank and the first row's new tokens.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.largevis import resolve_device, seeded_generator
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (decode_cache, make_decode_step,
                                      make_prefill_step)
from repro_torch.models.factory import make_model
from repro_torch.runtime import sharding as sh

# the batch's rows, the tokens each row decodes, and the weights' seed
BATCH, NEW_TOKENS, SEED = 2, 8, 0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--mesh", type=int, nargs=2, default=(2, 2),
                    metavar=("DATA", "MODEL"))
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced form")
    ap.add_argument("--prompt", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        mesh = make_host_mesh(*args.mesh, device=args.device)
        cfg = get_config(args.arch + ("-reduced" if args.reduced else ""))
        if mesh.in_mesh:
            _serve(cfg, mesh, args.prompt)
    finally:
        dist.destroy_process_group()


def _serve(cfg, mesh, S: int) -> None:
    B, n, dev = BATCH, NEW_TOKENS, mesh.device
    params = make_model(cfg, mesh=mesh)["init"](seeded_generator(dev, SEED),
                                                inference=True)
    prefill, _, (_, pl), pout = make_prefill_step(
        cfg, mesh, ShapeConfig("serve", "prefill", S, B))
    dshape = ShapeConfig("serve", "decode", S + n, B)
    decode, _, (_, dl), dout = make_decode_step(cfg, mesh, dshape)
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                         generator=seeded_generator(dev, SEED + 1))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    batch = {"tokens": sh.block(toks, pl["tokens"], mesh)}
    if cfg.is_encoder_decoder:
        frames = torch.randn((B, cfg.enc_positions, cfg.d_model),
                             device=dev, generator=seeded_generator(
                                 dev, SEED + 2)).to(cfg.dtype)
        batch["encoder_frames"] = sh.block(frames, pl["encoder_frames"],
                                           mesh)
    prefill(params, batch)      # warm-up: the collectives' communicators
    _sync(dev)
    t0 = time.perf_counter()
    logits, pre = prefill(params, batch)
    nxt = sh.gather(mesh, logits, pout[0]).argmax(-1, keepdim=True)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    cache = decode_cache(cfg, mesh, dshape, pre, pout[1])
    out, step_ms = [nxt], []
    for i in range(n - 1):
        pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = decode(params, {
            "tokens": sh.block(nxt, dl["tokens"], mesh), "cache": cache,
            "position": sh.block(pos, dl["position"], mesh)})
        nxt = sh.gather(mesh, logits, dout[0]).argmax(-1, keepdim=True)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(nxt)
    if mesh.rank == 0:
        dec = sum(step_ms) / max(len(step_ms), 1)
        peak = f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB" \
            if dev.type == "cuda" else "not measured (CPU)"
        print(f"{cfg.name} on a (data {mesh.shape['data']}, model "
              f"{mesh.shape['model']}) mesh over {mesh.backend}, "
              f"{cfg.n_layers} layers: prefill of {B} x {S} tokens "
              f"{prefill_ms:.1f} ms ({B * S / prefill_ms * 1e3:.0f} "
              f"tokens/s), decode {dec:.2f} ms a step ({B / dec * 1e3:.1f} "
              f"tokens/s), peak {peak} a rank; row 0's new tokens "
              f"{torch.cat(out, 1)[0].tolist()}", flush=True)


if __name__ == "__main__":
    main()
