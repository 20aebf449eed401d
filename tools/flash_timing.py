"""Per-launch device time of the bf16 ``flash_attention`` kernel at the
serve path's shape, (1, 4096, 16, 64) causal, under the conditions that
surround it: back to back on one set of inputs, rotating through inputs
larger than L2, after an L2 flush, after a prefill-sized GEMM, on the
inputs the prefill itself hands it, and inside the 4096- and
16,384-token prefills of ``qwen1.5-0.5b`` (random weights from a seed).

Durations are the card's own, one per launch, from the profiler's trace;
the SM clock and power are sampled by ``nvidia-smi`` during each
condition.  Needs one CUDA card and nvcc; about a minute:

    python3 tools/flash_timing.py
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.largevis import resolve_device  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.serve import ServeEngine  # noqa: E402
from repro_torch.models import lm  # noqa: E402

SHAPE = (1, 4096, 16, 64)


def smi(query: str, fmt: str = "csv,noheader", *extra: str):
    return subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}", *extra],
        stdout=subprocess.PIPE, text=True)


def launches(fn, n: int, pre=None):
    """The flash kernel's device durations (us) over n calls of ``fn``
    (``pre`` before each), the idle gaps after each, and the SM clock
    (MHz) and power (W) sampled meanwhile."""
    for _ in range(3):
        if pre:
            pre()
        fn()
    torch.cuda.synchronize()
    sampler = smi("clocks.sm,power.draw", "csv,noheader,nounits", "-lms",
                  "20")
    time.sleep(0.3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if pre:
                pre()
            fn()
        torch.cuda.synchronize()
    sampler.terminate()
    samples = [[float(x) for x in line.split(",")] for line in
               sampler.communicate()[0].splitlines() if line.strip()]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    runs = sorted((e["ts"], e["dur"]) for e in events
                  if e.get("cat") == "kernel" and "flash" in e["name"])
    gaps = [b[0] - a[0] - a[1] for a, b in zip(runs, runs[1:])]
    return [d for _, d in runs], gaps, samples


def report(name: str, fn, n: int, pre=None) -> None:
    dur, gaps, samples = launches(fn, n, pre)
    clocks = [c for c, _ in samples] or [0.0]
    watts = [w for _, w in samples] or [0.0]
    gap = statistics.median(gaps) if gaps else float("nan")
    print(f"{name}: {len(dur)} launches, us median "
          f"{statistics.median(dur):.1f} (min {min(dur):.1f}, max "
          f"{max(dur):.1f}); idle after a launch median {gap:.1f} us; SM "
          f"clock median {statistics.median(clocks):.0f} MHz (min "
          f"{min(clocks):.0f}); power median {statistics.median(watts):.0f}"
          f" W", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    print(smi("name,power.limit,clocks.max.sm").communicate()[0].strip())
    dev = resolve_device("cuda")
    _build.build("flash_attention")
    gen = torch.Generator(device=dev).manual_seed(17)

    def rnd(shape=SHAPE):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    q, k, v = rnd(), rnd(), rnd()
    report("back to back, one set of inputs", lambda: fa.flash_attention(
        q, k, v), 200)
    sets = [(rnd(), rnd(), rnd()) for _ in range(8)]     # 192 MB > L2
    turn = iter(range(10 ** 9))
    report("back to back, 8 sets of inputs in turn",
           lambda: fa.flash_attention(*sets[next(turn) % 8]), 200)
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    report("after a 512 MB memset (L2 flushed)",
           lambda: fa.flash_attention(q, k, v), 200, pre=flush.zero_)
    a = rnd((4096, 1024))
    w = rnd((1024, 8448))
    report("after a 4096 x 1024 x 8448 GEMM",
           lambda: fa.flash_attention(q, k, v), 200, pre=lambda: a @ w)

    cfg = get_config("qwen1.5-0.5b")
    eng = ServeEngine(cfg, slots=1, max_len=32, seed=0, device=dev)
    caught, kernel = [], ops.flash_attention

    def grab(q, k, v, causal=True):
        caught.append((q.clone(), k.clone(), v.clone()))
        return kernel(q, k, v, causal=causal)

    toks = torch.randint(0, cfg.vocab_size, (1, SHAPE[1]), generator=gen,
                         device=dev)
    ops.flash_attention = grab
    try:
        lm.lm_prefill(eng.params, cfg, toks)
    finally:
        ops.flash_attention = kernel
    report("back to back, the prefill's layer-0 inputs",
           lambda: fa.flash_attention(*caught[0]), 200)
    report("inside the 4096-token prefill",
           lambda: lm.lm_prefill(eng.params, cfg, toks), 5)
    long = torch.randint(0, cfg.vocab_size, (1, 4 * SHAPE[1]),
                         generator=gen, device=dev)
    report("inside the 16384-token prefill",
           lambda: lm.lm_prefill(eng.params, cfg, long), 2)
    q, k, v = (rnd((1, 4 * SHAPE[1], *SHAPE[2:])) for _ in range(3))
    report("back to back at (1, 16384, 16, 64)",
           lambda: fa.flash_attention(q, k, v), 20)


if __name__ == "__main__":
    main()
