"""Chosen LM phases of ``chip_smoke.py`` alone, on one CUDA card: the
flash checks, the serve phases of the architectures named and the
training phase, each with its own checks, after building the flash
kernels.  Quicker than the whole smoke (which runs the LargeVis fit
first) for a card check of the LM path; exits 1 at the first failed
check, as the smoke does.

    python3 tools/lm_phases.py                        # flash,jamba,xlstm,whisper
    python3 tools/lm_phases.py --phases xlstm
    python3 tools/lm_phases.py --phases flash_bwd     # the backward kernel
    python3 tools/lm_phases.py --phases train         # the training phase
    python3 tools/lm_phases.py --phases sharded       # the sharded trainer
    python3 tools/lm_phases.py --phases tp_train      # the (2, 2) trainer
    python3 tools/lm_phases.py --phases tp_serve      # the (2, 2) servers
    python3 tools/lm_phases.py --phases production    # layout_4m, serve CLI
    python3 tools/lm_phases.py --phases body_flash,body,xl8  # body cells

Phases: ``flash`` (``check_flash``), ``flash_bwd`` (``check_flash_bwd``),
``gemma3``, ``mixtral``, ``jamba``, ``xlstm``, ``whisper``
(``run_<phase>``), ``train`` (``run_training``: the backward kernel's
checks, the full-width trainer, the resume check, every architecture's
step, then the sharded trainer's phases), ``sharded`` (the resume
check, the world-1 runs the sharded phases hold world 2 to, then
``run_sharded_training`` and ``run_grad_compress``),
``tp_train`` (``run_tp_training``: the tensor-parallel trainer on a
(2, 2) mesh of four processes on the card against world 1, then xlstm
and whisper trained there), ``tp_serve`` (``run_tp_serve``: mixtral on
the (2, 2) serving mesh, then xlstm, whisper, a jamba mamba layer and
jamba at one period there), ``production`` (``run_production_cell``:
the LargeVis production cell's steps at layout_4m on the card, then the
serve CLI), ``body_flash`` (``check_body_flash``: the flash kernels at the
body cells' per-rank shapes), ``body`` (``run_body_cells``: the dry run's
period bodies of five production cells on the card, then qwen's whole
decode step), ``xl8``
(``run_xlstm_model8``: xlstm-125m on a (1, 8) mesh of eight processes).
Prints each phase's lines and seconds, then the flash launches each phase
made, as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PHASES = ("flash", "flash_bwd", "gemma3", "mixtral", "jamba", "xlstm",
          "whisper", "train", "sharded", "tp_train", "tp_serve",
          "production", "body_flash", "body", "xl8")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="flash,jamba,xlstm,whisper",
                    help=f"comma-separated, of {', '.join(PHASES)}")
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")

    import torch

    import chip_smoke as cs
    from repro_torch.core.largevis import resolve_device
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        cs.fail("CUDA is not available")
    print(cs.nvidia_smi(), flush=True)
    resolve_device("cuda")                 # also switches TF32 off
    t0 = time.perf_counter()
    for line in cs.ptxas_lines(_build.build("flash_attention",
                                            "flash_attention_bwd")):
        print(f"  {line}")
    print(f"kernel build: {time.perf_counter() - t0:.2f} s", flush=True)
    launches = {}
    for name in phases:
        t0 = time.perf_counter()
        if name == "flash":
            cs.check_flash(torch)
        elif name == "flash_bwd":
            print(json.dumps(cs.check_flash_bwd(torch)))
        elif name == "train":
            record, counts = cs.run_training(torch)
            launches[name] = counts
            print(json.dumps(record))
        elif name == "sharded":
            from repro_torch.configs import get_config
            from repro_torch.models.factory import param_shapes
            n_params = sum(p.numel() for p in param_shapes(
                get_config(cs.TRAIN_ARCH)).parameters())
            with tempfile.TemporaryDirectory() as tmp:
                counts, resumed = cs.run_resume(torch, tmp, n_params)
                launches[name] = cs._add_counts(
                    counts, cs.run_sharded_training(torch, tmp, resumed))
            cs.run_grad_compress(torch)
        elif name == "tp_train":
            launches[name] = cs.run_tp_training(torch)
        elif name == "production":
            print(json.dumps(cs.run_production_cell(torch, 0)))
        elif name == "body_flash":
            cs.check_body_flash(torch)
        elif name == "body":
            launches[name] = cs.run_body_cells(torch)
        elif name == "xl8":
            cs.run_xlstm_model8(torch)
        else:
            launches[name] = getattr(cs, f"run_{name}")(torch)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        cs.free_card(torch)
    print(json.dumps({"flash_attention_launches": launches}))
    print(cs.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
