"""Training driver: --arch <id> --steps N [--no-resume] — the JAX
package's ``launch/train.py`` on one device.

Wires: model factory -> train step (``launch/steps.py``: microbatched
gradients, AdamW) -> checkpoint manager (atomic, rotating, auto-resume;
the train state in the JAX trainer's tree, so either package resumes the
other's run) -> preemption guard -> straggler watchdog.  It runs on the
card unless ``device="cpu"`` (the plain versions of the kernels).

Preemption: a SIGTERM is held until the step in flight ends; the loop
then saves the step it has reached, ``step + 1`` (unless the cadence just
saved it), and the process exits by the signal.  The JAX trainer saves at
step -1 from inside the handler, which a later resume ranks below its
periodic saves or replays from step 0 (ROADMAP Queue 3); the port does
not.  ``production=True`` (JAX's pod mesh) raises: the sharded trainer is
ROADMAP Queue 1 item 7 step 8.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import (lm_params_from_numpy, opt_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.core.largevis import resolve_device, seeded_generator
from repro_torch.data.synthetic import token_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models.factory import make_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.fault_tolerance import PreemptionGuard, Watchdog


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
          ckpt_dir: str = None, save_every: int = 20, resume: bool = True,
          reduced: bool = True, production: bool = False, seed: int = 0,
          log_every: int = 10, microbatches: int = 1, device="cuda",
          opt_cfg: AdamWConfig = None):
    """Train ``arch`` for ``steps`` steps on the synthetic Markov stream;
    returns (params, opt_state, [(step, loss), ...]) of the steps this call
    ran.  ``ckpt_dir`` defaults to ``$TMPDIR/repro_ckpt``; ``microbatches``
    0 picks them (``pick_microbatches``); ``opt_cfg`` (the port's addition)
    defaults to JAX's ``AdamWConfig()``, whose 100-step warmup moves a
    full-width model's loss very little in a few steps."""
    if production:
        raise ValueError("train: production=True (the pod mesh) needs the "
                         "sharded trainer, ROADMAP Queue 1 item 7 step 8; "
                         "the port trains on one device")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder:
        raise ValueError(f"train: {cfg.name} needs encoder frames in its "
                         "batches, which the token stream does not make "
                         "(call make_train_step with them)")
    dev = resolve_device(device)
    step_fn = make_train_step(cfg, ShapeConfig("custom", "train", seq, batch),
                              opt_cfg=opt_cfg, microbatches=microbatches)
    mgr = CheckpointManager(
        ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_ckpt"),
        save_every=save_every)
    state, start = (mgr.resume() if resume else (None, 0))
    if state is None:
        params = make_model(cfg)["init"](seeded_generator(dev, seed))
        opt_state = adamw_init(params)
        start = 0
    else:
        params = lm_params_from_numpy(state["params"], cfg, dev)
        opt_state = opt_state_from_numpy(state["opt"], cfg, dev)
        del state
    guard = PreemptionGuard(exit_after_save=True)
    guard.defer(True)
    dog = Watchdog()

    def tree():
        return train_state_to_numpy(params, opt_state, cfg)

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
            saved = mgr.maybe_save(step + 1, tree)
            if guard.pending is not None:
                reached = step + 1
                guard.set_save_fn(None if saved is not None else
                                  lambda: mgr.save_now(reached, tree))
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
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
          ckpt_dir=args.ckpt_dir, save_every=args.save_every,
          resume=not args.no_resume, reduced=not args.full_config,
          production=args.production_mesh, device=args.device)


if __name__ == "__main__":
    main()
