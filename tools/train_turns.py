"""The one-card trainer before and after: a parent checkout's package and
this one in turns, parent, change, change, parent, in one process on one
CUDA card (``chip_smoke.py``'s ``load_package``/``activate``).

    git archive <parent> | tar -x -C _local/parent
    python3 tools/train_turns.py _local/parent

A turn trains ``chip_smoke.py``'s trainer model (qwen1.5-0.5b at full
width and depth, random weights from seed 0, bf16 compute on f32 master
weights) at world 1 with no mesh: ``TURN_STEPS`` steps of batch 4 x 4096
tokens in 2 microbatches (``pick_microbatches``), each step timed on the
host around a synchronised step; then the gradient norm alone on a
gradient tree of the model's leaf shapes (the parent's ``global_norm``
or the change's ``grad_norm``, whichever the package has), ms a call by
CUDA events and on the host.  Prints each turn, each package's mean,
and the losses; a package's two turns must give the same losses.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (load_package, trainer settings)

TURN_STEPS = 6        # the first is left out of the mean
NORM_REPS = 10


def _turn(torch, dev) -> dict:
    """One turn of the active package on ``dev``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.largevis import seeded_generator
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.factory import make_model
    from repro_torch.optim import adamw

    cfg = get_config(smoke.TRAIN_ARCH)
    smoke.free_card(torch)
    params = make_model(cfg)["init"](seeded_generator(dev, 0))
    opt = adamw.adamw_init(params)
    step = make_train_step(
        cfg, ShapeConfig("c", "train", smoke.TRAIN_SEQ, smoke.TRAIN_BATCH),
        opt_cfg=adamw.AdamWConfig(lr=smoke.TRAIN_LR,
                                  warmup_steps=smoke.TRAIN_WARMUP))
    ms, losses = [], []
    for i in range(TURN_STEPS):
        b = token_batch(0, i, smoke.TRAIN_BATCH, smoke.TRAIN_SEQ,
                        cfg.vocab_size, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    names = [n for n, _ in params.named_parameters()]
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = [torch.randn(p.shape, generator=gen, device=dev)
             for p in params.parameters()]
    del params, opt
    order = sorted(range(len(names)), key=names.__getitem__)

    def norm():
        if hasattr(adamw, "grad_norm"):
            return adamw.grad_norm(names, grads)
        return adamw.global_norm([grads[i] for i in order])
    norm()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    for _ in range(NORM_REPS):
        norm()
    b.record()
    host = (time.perf_counter() - t0) * 1e3 / NORM_REPS
    torch.cuda.synchronize()
    return {"step_ms": ms, "losses": losses,
            "norm_ms": a.elapsed_time(b) / NORM_REPS, "norm_host_ms": host,
            "leaves": len(names)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", type=Path,
                    help="a checkout of the parent commit")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        smoke.fail("CUDA is not available")
    src = args.parent.resolve() / "src"
    if not (src / "repro_torch").is_dir():
        smoke.fail(f"{args.parent}: no src/repro_torch there")
    print(smoke.nvidia_smi(), flush=True)
    pkgs = {"parent": smoke.load_package(src),
            "change": smoke.load_package(ROOT / "src")}
    for name, mods in pkgs.items():
        smoke.activate(mods)
        from repro_torch.core.largevis import resolve_device
        from repro_torch.kernels import _build
        resolve_device("cuda")             # also switches TF32 off
        t0 = time.perf_counter()
        _build.build("flash_attention", "flash_attention_bwd")
        print(f"{name}: kernels built in {time.perf_counter() - t0:.2f} s",
              flush=True)
    turns = []
    for name in ("parent", "change", "change", "parent"):
        smoke.activate(pkgs[name])
        r = _turn(torch, torch.device("cuda"))
        turns.append((name, r))
        steady = r["step_ms"][1:]
        print(f"turn {len(turns)} ({name}): step ms "
              f"{[round(x, 1) for x in r['step_ms']]}, "
              f"{sum(steady) / len(steady):.1f} after the first; gradient "
              f"norm over {r['leaves']} leaves {r['norm_ms']:.3f} ms a call "
              f"by CUDA events, {r['norm_host_ms']:.3f} ms on the host; "
              f"losses {r['losses']}", flush=True)
    for name in ("parent", "change"):
        a, b = (r for n, r in turns if n == name)
        smoke.check(a["losses"] == b["losses"],
                    f"the {name}'s two turns' losses differ")
        steady = a["step_ms"][1:] + b["step_ms"][1:]
        ms = sum(steady) / len(steady)
        print(f"{name}: {ms:.1f} ms a step after the first, "
              f"{smoke.TRAIN_BATCH * smoke.TRAIN_SEQ / ms * 1e3:.0f} "
              f"tokens/s; gradient norm "
              f"{(a['norm_ms'] + b['norm_ms']) / 2:.3f} ms a call, host "
              f"{(a['norm_host_ms'] + b['norm_host_ms']) / 2:.3f} ms",
              flush=True)
    print(smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
