"""Where the bf16 flash backward's time goes: variants of
``csrc/flash_attention_bwd.cu`` (text edits of the source, built side by
side with nvcc) timed in turns by CUDA events at the main shapes, on one
CUDA card.

    python3 tools/flash_bwd_variants.py

Variants (all but ``base`` and ``nodefer`` give wrong gradients; they only
time the parts they cut):
  base       the source as it is
  nowait     no turn wait on the dQ counters (adds race)
  nostore    the dQ accumulator's stores cut (its loads and adds kept)
  nodefer    the dQ add done in its own tile's iteration at every head dim
  headmajor  work items handed out head first (every key tile of a head
             at once) instead of key tile first
Prints one line a shape: each variant's ms a call, base first and last.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = (((2, 4096, 16, 64), 0), ((1, 8192, 32, 128), 4096),
          ((1, 8192, 16, 256), 0))
EDITS = {
    "nowait": ("""          while (ld_acquire(counters + pd.cidx) < pd.rank) {
          }""", "          {}"),
    "nostore": ("""              __stcg(a + v, make_float4(d[4 * v], d[4 * v + 1], d[4 * v + 2],
                                        d[4 * v + 3]));""",
                "              if (d[4 * v] == 1234.5f) a[v] = make_float4("
                "0.f, 0.f, 0.f, 0.f);"),
    "nodefer": ("static constexpr bool DEFER = D == 128;",
                "static constexpr bool DEFER = false;"),
    "headmajor": ("const int j = item / BH, bh = item % BH,",
                  "const int bh = item / nk, j = item % nk,"),
}


def main() -> None:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        sys.exit("flash_bwd_variants: CUDA is not available")
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    out = Path(tempfile.mkdtemp(prefix="flash_bwd_variants-"))
    shutil.copy(_build.CSRC / "sm90.cuh", out / "sm90.cuh")
    texts = {"base": src}
    for name, (old, new) in EDITS.items():
        if old not in src:
            sys.exit(f"flash_bwd_variants: {name}: its anchor is not in the "
                     "source any more")
        texts[name] = src.replace(old, new)
    flags = [f for f in _build.FLAGS if f not in ("-Xptxas", "-v")]
    t0 = time.perf_counter()
    procs = {}
    for name, text in texts.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *flags, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"flash_bwd_variants: {name} did not build:\n{log}")
    _build.build("flash_attention")
    print(f"built {len(procs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    libs = {}
    for name in texts:
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        fn = lib.flash_attention_bwd_launch
        fn.argtypes, fn.restype = fa._BWD_ARGTYPES, ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    order = ["base", *EDITS, "base"]
    for (b, s, h, d), w in SHAPES:
        q, k, v, dout = (torch.randn((b, s, h, d), generator=gen,
                                     device=dev).bfloat16()
                         for _ in range(4))
        out_, lse = fa.flash_attention(q, k, v, return_lse=True, window=w)
        res = []
        for name in order:
            _build._libs["flash_attention_bwd"] = libs[name]
            call = lambda: fa.flash_attention_bwd(  # noqa: E731
                q, k, v, out_, dout, lse, window=w)
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            for _ in range(10):
                call()
            e1.record()
            torch.cuda.synchronize()
            res.append(f"{name} {e0.elapsed_time(e1) / 10:.4f}")
        print(f"{(b, s, h, d)} W={w} bf16: " + ", ".join(res) + " ms",
              flush=True)
        del q, k, v, dout, out_, lse
    shutil.rmtree(out, ignore_errors=True)


if __name__ == "__main__":
    main()
