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

Phases: ``flash`` (``check_flash``), ``flash_bwd`` (``check_flash_bwd``),
``gemma3``, ``mixtral``, ``jamba``, ``xlstm``, ``whisper``
(``run_<phase>``), ``train`` (``run_training``: the backward kernel's
checks, the full-width trainer, the resume check, every architecture's
step).  Prints each phase's lines and seconds, then the flash launches
each phase made, as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PHASES = ("flash", "flash_bwd", "gemma3", "mixtral", "jamba", "xlstm",
          "whisper", "train")


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
    for name, rep in sorted(_build.build("flash_attention",
                                         "flash_attention_bwd").items()):
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
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
        else:
            launches[name] = getattr(cs, f"run_{name}")(torch)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        cs.free_card(torch)
    print(json.dumps({"flash_attention_launches": launches}))
    print(cs.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
