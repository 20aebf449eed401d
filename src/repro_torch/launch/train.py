"""Training driver: --arch <id> --steps N [--no-resume]
[--production-mesh [--mesh D M]] — the JAX package's ``launch/train.py``.

Wires: model factory -> train step (``launch/steps.py``: microbatched
gradients, AdamW) -> checkpoint manager (atomic, rotating, auto-resume;
the train state in the JAX trainer's tree, so either package resumes the
other's run) -> preemption guard -> straggler watchdog.  It runs on the
card unless ``device="cpu"`` (the plain versions of the kernels).

``production=False`` trains on one device (JAX's 1 x 1 host mesh).
``production=True`` trains data-parallel over ``make_data_mesh()``,
every rank of the process group (``torchrun --nproc_per_node=P``; with no
group, a world of one), the counterpart of the data axis of JAX's pod
mesh (whose full (16, 16) shape only the dry run's recording mesh has,
``launch/mesh.py::make_production_mesh``): each rank takes its
block of the batch's rows and holds its blocks of the parameters and the
moments at rest, by JAX's FSDP rules (``launch/steps.py``).  Every rank
joins the gather of the state at a save, and mesh rank 0 writes the
checkpoint, which holds whole leaves in JAX's layout; every rank resumes
its blocks through ``resume(shardings=)``, so a run saved at any world
resumes at any other.  ``mesh_shape=(D, M)`` trains on ``make_host_mesh(D,
M)`` instead: the same, with heads, ff and vocab over ``"model"`` (the
attention decoders; README).

Preemption: a SIGTERM is held until the step in flight ends; the loop
then saves the step it has reached, ``step + 1`` (unless the cadence just
saved it), and the process exits by the signal.  On a mesh the ranks
agree at each step's end, by a max over the mesh, whether any of them
was signalled; then all of them save and every rank exits by SIGTERM.
The JAX trainer saves at step -1 from inside the handler, which a later
resume ranks below its periodic saves or replays from step 0 (ROADMAP
Queue 3); the port does not.
"""
from __future__ import annotations

import argparse
import os
import signal
import tempfile
import time

import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import (lm_params_from_numpy, opt_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.core.largevis import resolve_device, seeded_generator
from repro_torch.data.synthetic import token_batch
from repro_torch.launch.mesh import make_data_mesh, make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.factory import make_model
from repro_torch.models.lm import init_lm
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.fault_tolerance import PreemptionGuard, Watchdog


def state_shardings(shapes: dict, mesh) -> dict:
    """The ``(mesh, spec)`` tree of a train checkpoint whose leaves have
    ``shapes`` (``checkpointer.shapes``), for ``resume(shardings=)``: the
    step whole, each parameter and moment by the parameter's training
    spec on the mesh's axes, JAX's ``params_shardings(train=True)`` (a
    leaf under ``blocks/`` or a layer list stacked)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        s = "/".join(path)
        return mesh, sh.param_pspec(s, tree, mesh.shape, train=True,
                                    stacked="blocks/" in s or
                                    "_layers/" in s)

    opt = shapes["opt"]
    return {"params": walk(shapes["params"], ()),
            "opt": {"m": walk(opt["m"], ()), "v": walk(opt["v"], ()),
                    "step": (mesh, ())}}


def _agree(mesh, flag: bool, dev) -> bool:
    """The max of every rank's ``flag`` over the mesh (one int each)."""
    if mesh is None or mesh.size == 1:
        return flag
    got = mesh.all_gather(torch.tensor([int(flag)], device=dev))
    return bool(got.max())


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
          ckpt_dir: str = None, save_every: int = 20, resume: bool = True,
          reduced: bool = True, production: bool = False, seed: int = 0,
          log_every: int = 10, microbatches: int = 1, device="cuda",
          opt_cfg: AdamWConfig = None, mesh_shape: tuple = None):
    """Train ``arch`` for ``steps`` steps on the synthetic Markov stream;
    returns (params, opt_state, [(step, loss), ...]) of the steps this call
    ran.  ``ckpt_dir`` defaults to ``$TMPDIR/repro_ckpt``; ``microbatches``
    0 picks them (``pick_microbatches``); ``opt_cfg`` (the port's addition)
    defaults to JAX's ``AdamWConfig()``, whose 100-step warmup moves a
    full-width model's loss very little in a few steps.  Under
    ``production`` every rank of the world calls it alike and gets the
    same losses; its ``params`` and ``opt_state`` hold its blocks (on the
    ``(data, model)`` mesh of ``mesh_shape`` where given)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder:
        raise ValueError(f"train: {cfg.name} needs encoder frames in its "
                         "batches, which the token stream does not make "
                         "(call make_train_step with them)")
    dev = resolve_device(device)
    if mesh_shape is not None and not production:
        raise ValueError("train: mesh_shape= takes production=True")
    mesh = None
    if production:
        mesh = make_data_mesh(0, device=dev) if mesh_shape is None else \
            make_host_mesh(*mesh_shape, device=dev)
        dev = mesh.device
    writer = mesh is None or mesh.rank == 0
    step_fn = make_train_step(cfg, ShapeConfig("custom", "train", seq, batch),
                              mesh=mesh, opt_cfg=opt_cfg,
                              microbatches=microbatches)
    mgr = CheckpointManager(
        ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_ckpt"),
        save_every=save_every, writes=writer)

    state, start = None, 0
    last = ckpt.latest_step(mgr.directory) if resume else None
    if last is not None and mesh is None:
        state, start = mgr.resume()
    elif last is not None:      # every rank its blocks of the state
        state, start = mgr.resume(shardings=state_shardings(
            ckpt.shapes(mgr.directory, last), mesh))
    if state is None:
        gen = seeded_generator(dev, seed)
        params = make_model(cfg)["init"](gen) if mesh is None else \
            init_lm(gen, cfg, mesh=mesh, train=True)
        opt_state = adamw_init(params)
    else:
        params = lm_params_from_numpy(state["params"], cfg, dev)
        opt_state = opt_state_from_numpy(state["opt"], cfg, dev)
        del state
    guard = PreemptionGuard(exit_after_save=True)
    guard.defer(True)
    dog = Watchdog()

    def tree():
        """The train state in JAX's layout: on a mesh of ranks every rank
        joins the gathers, and only mesh rank 0 (which writes) keeps the
        tree."""
        st = train_state_to_numpy(params, opt_state, cfg, mesh=mesh)
        return st if writer else None

    losses = []
    try:
        for step in range(start, steps):     # batch i depends on (seed, i)
            batch_data = token_batch(seed + 1, step, batch, seq,
                                     cfg.vocab_size, device=dev)
            t0 = time.time()
            params, opt_state, loss = step_fn(params, opt_state, batch_data)
            loss = float(loss)
            losses.append((step, loss))
            dt = time.time() - t0
            dog.observe(step, dt)
            if step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} ({dt*1000:.0f} ms)",
                      flush=True)
            reached = step + 1
            saved = mgr.maybe_save(reached, tree)
            stop = _agree(mesh, guard.pending is not None, dev)
            if stop and saved is None:
                saved = mgr.save_now(reached, tree)
            if saved is not None and mesh is not None:
                mesh.barrier()          # the writer has committed it
            if stop:
                guard.set_save_fn(None)
                if guard.pending is None:    # another rank was signalled
                    guard.pending = signal.SIGTERM
                print(f"preemption: checkpointed at step {reached} and "
                      "exiting", flush=True)
                guard.finish()               # exits by the signal
    finally:
        guard.restore_handlers()
    if dog.stragglers:
        print(f"stragglers flagged: {len(dog.stragglers)}")
    return params, opt_state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default $TMPDIR/repro_ckpt")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="data-parallel over every rank of the world "
                    "(torchrun --nproc_per_node=P)")
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("D", "M"), help="with --production-mesh: a "
                    "(data, model) mesh of D x M ranks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    group = args.production_mesh and "WORLD_SIZE" in os.environ
    if group:
        # started by torchrun: join its group (its env:// rendezvous)
        import torch.distributed as dist
        if torch.device(args.device).type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if torch.device(args.device).type
                                == "cuda" else "gloo")
    try:
        train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
              ckpt_dir=args.ckpt_dir, save_every=args.save_every,
              resume=not args.no_resume, reduced=not args.full_config,
              production=args.production_mesh, device=args.device,
              mesh_shape=args.mesh)
    finally:
        if group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
