"""Sweep the tile tuner's cells at the smoke fit's shapes on one CUDA card
and write the committed ``cuda`` table.

    python3 tools/autotune_table.py [--out PATH]

The cells are ``symmetrize`` (n = 100,000, k = 150) and
``neighbor_explore`` (n = 100,000, k = 150, d = 100), the shapes of the
full-width fit in ``chip_smoke.py``; each is swept by
``repro_torch.runtime.autotune.sweep`` (best-of-3 shortlist, then the
paired best-of-8 against the legacy tile) into a temporary cache.  The
table records the card's name and power limit (``nvidia-smi``) and the
torch version beside the entries.  ``--out`` defaults to
``src/repro_torch/runtime/autotune_torch_cuda.json``.  Needs one CUDA
card; about a minute.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = (("symmetrize", dict(n=100_000, k=150)),
         ("neighbor_explore", dict(n=100_000, k=150, d=100)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "src" / "repro_torch"
                    / "runtime" / "autotune_torch_cuda.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("autotune_table: CUDA is not available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.largevis import resolve_device
    from repro_torch.runtime import autotune

    resolve_device("cuda")                  # switches TF32 off, as a fit does
    name, limit = (v.strip() for v in subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].split(","))
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_AUTOTUNE_CACHE"] = tmp
        for kernel, shape in CELLS:
            chosen = autotune.sweep(kernel, shape, backend="cuda")
            print(f"{kernel} {shape}: {chosen}", flush=True)
        entries = autotune._read_entries(autotune._cache_path("cuda"))
    doc = {"version": autotune.AUTOTUNE_VERSION, "device": name,
           "power_limit": limit, "torch": torch.__version__,
           "entries": entries}
    args.out.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(json.dumps(doc, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
