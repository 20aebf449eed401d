#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --parent PATH   # before and after, in turns

From the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit.  It imports nothing of JAX or of the JAX package.  With
``--parent PATH`` (a checkout of the parent commit) it only times the
parent's package and this one in turns, parent, change, change, parent,
in one process (``run_parent``), and requires the two packages'
``pairwise_sqdist`` outputs to be bitwise equal.  Without it, in order:

1. the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, in parallel) and prints the build time;
3. holds each kernel of the fit against its plain PyTorch version at the
   shapes the main path gives it, and times the kernel, the plain
   version, one PyTorch library call for the same function, and the
   least time the card could take (the larger of bytes over 3.35 TB/s
   and operations over 67 TFLOP/s f32, or 989 TFLOP/s for bf16 operands,
   the H100 SXM data sheet's peaks).  ``topk_sqdist``: the window fold
   through the index form, a tie-heavy integer grid with and without
   dedup, k = 1 and k > N at shapes off the kernel's tiles, k = 256
   with multi-tile dedup, ids and distances exactly the plain
   version's.  ``fused_edge_step``: bitwise at the fit's shape, on
   N = 64, on a hub batch (one row takes about 2,000 updates) and over
   200 consecutive steps, with the lr a float, a 0-d tensor on the card
   and a per-edge vector, with one device event a call.
   ``pairwise_sqdist``: graph_recall's (2000, 100) x (100000, 100), the
   layout accuracy's (1000, 2) x (99000, 2) and (777, 100) x (50001, 100)
   off the kernel's tiles, the first two timed beside ``torch.cdist``;
4. runs the full-width fit (``LargeVisConfig()`` defaults: K=150, 8
   trees, window 64, perplexity 50) on a Gaussian mixture of N=100,000
   points in d=100, with every kernel's launch count reset just before
   and read just after, and checks the layout and the graph; its layout
   runs ``steps_per_dispatch`` = 100 steps a CUDA graph replay, and
   ``fused_edge_step``'s launches must equal its steps (244,140);
5. the fit's edge and negative samplers built twice more on the card,
   bitwise equal to the fit's; a second fit from the same seed, bitwise
   equal to the first at every stage; then the crash-safe,
   health-guarded fit (``run_robust_fit``, checkpoints in a temporary
   directory): the full fit with ``checkpoint`` and ``health`` killed by
   an injected fault at layout chunk 1,201 of 2,442 and run again, which
   must restore the graph, weights and samplers from disk and end
   bitwise on the main fit's y (its launches counted with the fit's);
   graphs captured while another thread copies to the host, bitwise;
   ``layout_s`` at the cut depth plain, with ``checkpoint``, with
   ``health`` and with both, in turns, all eight bitwise equal; a NaN
   payload rolled back once (finite, 5-NN accuracy within 0.05 of the
   fit's, at the fit's depth); at the cut depth, the fused step failing
   at its first call demoted to the split route (bitwise the split
   route's layout, its launches counted with the split path's);
   ``LargeVis.save`` and ``load(device="cuda")`` of the fit, every array
   bitwise.  A ``DegradedModeWarning`` or ``DivergenceWarning`` anywhere
   else is an error;
6. from the fit's layout and samplers, 240 steps through the chunk unit
   (the first chunk eager, a 100-step and a 40-step graph replayed)
   against the per-step loop, on the fused, the split and the autograd
   route: bitwise equal, with the generator's state and the launches;
   ``transform`` of 2,000 held-out points by the loop and through its
   kept graph, bitwise equal; 10 replays under the profiler, and the
   layout's busy share from them and from the profiled eager step;
7. on the fit's graph, samplers and layout, the split path: the
   ``largevis_grads`` kernel in its indexed form (y read in place, the
   update stream written: B = 4096, 4095, 37 and a hub batch, three lr
   forms, frozen rows) and its gathered form, and the ordered scatter (at
   the step size through the linked lists, at the in-degree size through
   the sort), bitwise against their plain versions on a CPU copy; 50
   fused and 50 split SGD steps from one state, bitwise equal, with each
   route's device launches a step, eager and in 10 replays of the split
   route's 100-step graph;
   the split layout (at 2,000 samples per node, a printed cut); 200
   autograd steps of ``prob_fn="exp_quadratic"``;
8. ``LargeVis.transform`` of 10,000 held-out points of the fit's
   clusters, by the fused and by the split route (and the queries'
   top-k, (1, 10000, 100000), beside ``torch.cdist`` + ``topk`` and its
   bound); then the projection server (``run_projection_server``),
   ``ProjectionEngine(slots=1024)`` on the fit with its config (K = 150,
   M = 5, 48 steps), its step one CUDA graph replay after one eager
   step: its two kernels at its shapes (``topk_sqdist`` of an admit
   block, (1, 1024, 100) x (1, 100000, 100), exact, timed beside
   ``torch.cdist`` + ``topk`` and its bound; ``fused_edge_step`` of a
   lockstep step, B = 1024, per-slot lr, n_frozen = N, every other slot
   idle, bitwise its plain version and the split route's kernels, idle
   rows and corpus unchanged); a warm-up drain of 2,048 queries, then the
   timed drain of the same 10,000 queries, submitted at once, with the
   launch counts reset just before and read just after (line
   ``projection server:``: queries/s, p50 and p99 latency, engine steps
   and graph replays, host ms an engine step, 5-NN accuracy beside
   ``transform``'s, launches: ``topk_sqdist`` one an admit block,
   ``fused_edge_step`` one a step); 30 profiled steps of a full engine
   (device ms and events a step, busy share); the prefill of an admit
   block (ms by CUDA events and profiled), and the drain's busy share
   from its parts; then, each on a drain of 2,048 queries and each
   failing the run, two engines from one seed bitwise equal, the graph
   engine bitwise the engine that runs every step eagerly, the split
   route bitwise the fused, NaN and wrong-dimension queries quarantined
   with the healthy ones bitwise a clean run, and two step faults retried
   bitwise transparently (line ``server checks:``); every drain keeps
   the corpus rows bitwise and serves all its queries with finite
   coordinates, and the served accuracy is within 0.05 of
   ``transform``'s;
9. the tree fit (``rp_mode="tree"``: 8 trees of depth 11, its layout cut
   to 2,000 samples per node, a printed cut): the card's tree codes
   against the CPU's from one draw of pairs (a point may differ only
   within the f32 bound of its plane; the count printed), then the fit's
   ``knn_s``, graph_recall and 5-NN accuracy beside the hash fit's, with
   ``topk_sqdist`` launched once a tree; the tile tuner:
   ``symmetrize`` and ``neighbor_explore`` swept at the fit's shapes into
   a temporary cache (winner and time beside the legacy tile's), and a
   fit under ``routing.autotune="cache"`` (the committed table: the run
   points the user cache at an empty directory) bitwise one under
   ``"off"``, both at the cut depth; the baselines: LINE from the fit's
   samplers at 1,000 samples per node, twice from one seed, bitwise, one
   ordered scatter a step; exact t-SNE and symmetric SNE on the first
   10,000 points' KNN graph, 1,000 iterations (ms an iteration, the KL,
   5-NN accuracy); NN-Descent at full width, 4 exploring rounds,
   graph_recall beside the forest's; the VP-tree on the host over the
   10,000 points, 200 queries, recall against brute force and queries/s;
   then ``LargeVis.insert`` of 2,000 more points (it grows the fit's
   carrier, so it runs last on it); each phase with its launch counts
   read;
10. the distributed fit (``run_distributed``): the ring's
   ``topk_sqdist`` fold at world 1 (``ring_fold`` on a world of one,
   100000 x 100000, 8 trees' codes) and world 2 (a rank's own 50000 x
   50000 slab, and the slab-order merge of a rank's two lists, its ms
   and memory), timed beside ``torch.cdist`` + ``topk`` over 10,000-row
   blocks and its bound (operations counted over the pairs that share a
   bucket, the pair count printed), ids and distances exactly the plain
   version's on the first 2,000 rows; then
   ``LargeVisConfig(distributed=True)`` at full width on a world of one
   over NCCL (the launch counts reset just before and read just after:
   one ``topk_sqdist``, one ``fused_edge_step`` a step; ``knn_s`` split
   into ring and exploring, 5-NN accuracy >= 0.95, peak memory), its
   sharded tables bitwise the flat tables of its graph, a second fit
   bitwise the first; then world 2 over gloo, two spawned processes on
   the one card (the kernels built here first): the ring graph before
   exploring, the graph, distances and weights bitwise world 1's, the
   sharded edge marginals within ``MARGINAL_TOL`` of world 1's, the
   local-SGD layout at a printed cut of its depth, syncing every step
   (accuracy >= 0.95; one sync's ms; world 1's layout of world 1's
   graph at the same depth printed beside it), a shard fault
   at ``knn_ring_step:1`` degraded 2 -> 1 with one
   ``DegradedModeWarning`` on each rank and completed, and a layout
   checkpoint of world 2 (killed after its second save) resumed here at
   world 1 with one ``TopologyChangeWarning``;
11. runs the 2000-point quality fixture (accuracy >= 0.95), by the fused
   and by the split route: the two layouts bitwise equal;
12. the LM serving path, the fit's state released first:
   ``flash_attention`` against its plain version in bf16 and f32 at the
   serve paths' shapes, (1, 8192, 16, 256) causal and with gemma3's
   window 1024, (1, 8192, 32, 128) with mixtral's window 4096 and
   causal, (1, 4096, 16, 64) causal, jamba's (1, 4096, 32, 128) and
   whisper's (1, 4096, 6, 64) causal, and at ragged shapes (S = T = 4095
   and 4097, S < T, S > T, non-causal, head dims 16 to 256, S < W, S = W,
   S = W + 1, W = 1), each main shape timed by CUDA events and by the
   profiler's device time beside the plain version, SDPA (``is_causal``,
   or the window's boolean mask) and its bound (operations over the pairs
   under the mask); then ``ServeEngine`` with ``qwen1.5-0.5b`` at full
   width (random weights from a seed, bf16) serving 8 requests, 4 of 4096
   tokens (prefill through the flash kernel) and 4 of 16-512 tokens
   (``mha_full``), with the launch counts read just before and just
   after; the kernel's 4096-token prefill logits against the same prefill
   through the plain version; one timed prefill of a 16,384-token prompt
   (wall and device time, busy share, flash launches; no plain
   comparison at that length); decode against prefill at reduced depth
   in f32; then ``gemma3-12b`` at full width and depth through
   ``ServeEngine`` (4 slots, max_len 8224, prompts of 8192, 700, 8192 and
   1000 tokens, 16 new tokens each: the flash kernel windowed on the 40
   local layers and causal on the 8 global ones, 96 launches; the local
   layers' 1024-slot rings wrap while decoding), the long prompts' last
   logits against the plain version, prefill and decode ms, tokens/s,
   busy shares and peak memory, and decode against prefill in f32 at one
   period of 6 layers (a printed cut), prefill(2048) through the kernel
   (past the window, its cache a ring) and prefill(2049) through
   ``mha_full``;
   then ``mixtral-8x7b`` at full width and 2 of its 32 layers (a printed
   cut): decode against prefill in f32 with total routing, a decode on
   an int8 cache (``kv_quant``) within 0.15, and one 8192-token bf16
   prefill (the kernel at hd 128, W 4096, then top-2 MoE at capacity
   2560) against the plain version; then ``jamba-v0.1-52b`` at full
   width and one period of 8 of its 32 layers (a printed cut; 7 mamba
   layers and one attention layer, MoE on every other): the f32 master
   made once, decode against prefill on it (S = 200, inside one mamba
   chunk, total routing), then cast in place and served by
   ``ServeEngine`` (prompts of 4096, 256, 4096 and 200 tokens: the flash
   kernel at (1, 4096, 32, 128) once a long prompt, 2 launches);
   ``xlstm-125m`` at full width and depth: decode against prefill in f32
   (S = 256) and ``ServeEngine`` with prompts of 1024, 300, 1024 and 64
   tokens (token-by-token recurrences, no attention; the profiled
   prefill's device events a token); ``whisper-tiny`` at full width and
   depth (4 encoder and 4 decoder layers, 1500 frames): on random frames
   in f32, prefill(2048) through the kernel against the plain version and
   decode against prefill(2049), then ``ServeEngine`` (zero frames;
   prompts of 4096, 700, 4096 and 100 tokens: the kernel at (1, 4096, 6,
   64) in each of 4 decoder layers a long prompt, 8 launches); each serve
   run with its prefill and decode ms, tokens/s, profiled busy shares and
   peak memory;
13. the LM training path, the serving phases' state released first
   (``run_training``): ``flash_attention_bwd`` against its plain version
   on the forward kernel's own out and lse (that lse against the plain
   version's) at the architectures' training shapes in bf16, qwen's
   microbatch (2, 4096, 16, 64), mixtral's (1, 8192, 32, 128) with W
   4096, gemma3's (1, 8192, 16, 256) causal and with W 1024, whisper's
   (1, 4096, 6, 64), one f32 shape and ragged ones in both types, every
   case twice, bitwise; the main shapes timed beside the plain version,
   SDPA's backward and the bound; then ``launch.train.train`` on
   qwen1.5-0.5b at full width and depth, batch 4 x 4096 in 2
   microbatches, 8 steps (AdamW at lr 3e-4 from the first step), with
   the launch counts reset just before and read just after (flash forward
   96 and backward 48 a step), the loss by step, a held-out batch's loss
   before and after (it must fall), ms a step, tokens/s, peak memory and
   a profiled step; the resume check at 2 layers (a printed cut): 8
   steps against 5 resumed to 8, the losses after step 4 bitwise equal;
   every architecture's reduced f32 step on the card against the CPU's
   from one state, twice on the card, bitwise;

then prints a JSON line of the kernel records and, last, the device line.
Any failed check exits with status 1 and prints no result.  Device times
from the profiler are per launch seen, with the launches seen printed
beside those made; a busy share is printed only when the profiler saw
every launch of the hand-written kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_PER_S = 67e12          # H100 SXM f32, outside the tensor cores
PEAK_BF16_PER_S = 989e12        # H100 SXM bf16, dense tensor cores
PAPER_SAMPLES_PER_NODE = 10_000
SPLIT_SAMPLES_PER_NODE = 2_000  # the split layout's cut (printed)
N_POINTS, DIM, CLUSTERS = 100_000, 100, 10   # the full-width fit's data
N_TRANSFORM, N_INSERT = 10_000, 2_000        # held-out points
SERVE_PROJ_SLOTS, N_CHECK = 1024, 2_048     # the projection server
LM_ARCH = "qwen1.5-0.5b"
FLASH_SHAPE = (1, 4096, 16, 64)   # (B, S, H, hd) of a long prompt's prefill
# kernel vs plain version: f32, the same f32 softmax summed in another
# order (|err| <= FLASH_F32_TOL); bf16, both f32 results rounded to 8
# bits, which differ where they straddle a rounding boundary: |err| <=
# FLASH_BF16_ULPS bf16 ulps of |plain| + FLASH_F32_TOL, element by element
FLASH_F32_TOL, FLASH_BF16_ULPS = 2e-5, 2
# the bf16 model's last logits through the kernel vs the plain version,
# relative to the largest |logit|: one-ulp differences of the attention
# outputs carried through 24 layers of bf16 activations
PREFILL_REL_TOL = 5e-2
DECODE_REL_TOL = 2e-3             # the JAX package's own bound (test_models)
KV_QUANT_REL_TOL = 0.15           # the JAX package's int8-cache bound
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_MAX_NEW = 4, 4128, 16
LONG_PROMPT, N_LONG, N_SHORT = 4096, 4, 4
TIMED_PROMPT = 16_384             # one timed prefill, batch 1
GEMMA_ARCH, GEMMA_WINDOW, GEMMA_LONG = "gemma3-12b", 1024, 8192
GEMMA_LENGTHS = [GEMMA_LONG, 700, GEMMA_LONG, 1000]   # 2 long, 2 short
MIXTRAL_ARCH, MIXTRAL_WINDOW = "mixtral-8x7b", 4096
MIXTRAL_LAYERS, MIXTRAL_PROMPT = 2, 8192
JAMBA_ARCH, JAMBA_PERIODS, JAMBA_LONG = "jamba-v0.1-52b", 1, 4096
# multiples of mamba's chunk of 256, or at most one chunk
JAMBA_LENGTHS = [JAMBA_LONG, 256, JAMBA_LONG, 200]
JAMBA_DECODE_S = 200              # prefill(200) + decode vs prefill(201)
XLSTM_ARCH, XLSTM_LENGTHS = "xlstm-125m", [1024, 300, 1024, 64]
XLSTM_DECODE_S = 256
WHISPER_ARCH, WHISPER_LONG = "whisper-tiny", 4096
WHISPER_LENGTHS = [WHISPER_LONG, 700, WHISPER_LONG, 100]
WHISPER_DECODE_S = 2048           # through the kernel; S + 1 through mha_full
# the serve paths' prefill shapes (B, S, H, hd) and windows, timed
FLASH_MAIN = {((1, 8192, 16, 256), 0): "gemma3-12b global layers",
              ((1, 8192, 16, 256), 1024): "gemma3-12b local layers",
              ((1, 8192, 32, 128), 4096): "mixtral-8x7b layers",
              ((1, 8192, 32, 128), 0): "a global layer at hd 128",
              ((1, 4096, 32, 128), 0): "jamba-v0.1-52b's attention layer, "
                                       "32 query heads over 8 kv heads",
              ((1, 4096, 6, 64), 0): "whisper-tiny decoder self-attention",
              (FLASH_SHAPE, 0): "qwen1.5-0.5b layers"}
FLASH_RECORD = ((1, 8192, 16, 256), 0)   # the kernels line's shape


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def bound_ms(n_bytes: float, n_ops: float,
             peak_ops: float = PEAK_F32_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def clocks_during(torch, fn, seconds: float = 1.0) -> list:
    """Call ``fn`` back to back for about ``seconds`` while sampling the
    card's SM clock and power draw (``nvidia-smi``) from a thread; the
    samples, as nvidia-smi prints them."""
    import threading

    samples, done = [], threading.Event()

    def poll():
        while not done.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                 "power.draw", "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip())
            done.wait(0.2)
    fn()
    torch.cuda.synchronize()
    th = threading.Thread(target=poll)
    th.start()
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    done.set()
    th.join()
    return samples


def bf16_ulp(torch, x):
    """The spacing of bf16 numbers at |x|, 2^(floor(log2 |x|) - 7)."""
    a = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# The profiler's event names of each hand-written kernel, by launcher.
KERNEL_EVENTS = {
    "fused_edge_step": ("edge_step_kernel<", "true>"),
    "scatter_add_ordered": ("edge_step_kernel<", "false>"),
    "largevis_grads": ("largevis_grads_kernel",),
    "topk_sqdist": ("topk_kernel",),
    "pairwise_sqdist": ("pairwise_kernel",),
    "flash_attention": ("flash_attention",),
    "flash_attention_bwd": ("dkdv_kernel",),     # one of its three a call
}
# the backward flash launcher's three kernels
BWD_EVENTS = ("delta_kernel", "dkdv_kernel", "dq_kernel")


def _is_event_of(launcher: str, key: str) -> bool:
    if launcher == "scatter_add_ordered" and "edge_accumulate_kernel" in key:
        return True                      # the sort path's kernel
    if launcher == "largevis_grads" and "grads_stream_kernel" in key:
        return True                      # the indexed form
    if launcher == "fused_edge_step" and "edge_forces_kernel" in key:
        return True                      # a parent checkout's phase 0
    return all(part in key for part in KERNEL_EVENTS[launcher])


@dataclasses.dataclass
class Profile:
    """``n`` calls under ``torch.profiler``: host ms a call; per device
    event name (total device ms, events seen); per hand-written kernel
    the launches its wrapper made in those calls."""
    n: int
    host: float
    events: dict
    made: dict

    def kernel(self, launcher: str):
        """(device ms a launch seen, launches seen, launches made).  The
        backward flash launcher makes three kernels a call: its time is
        theirs, its launches seen its dk/dv kernel's."""
        hits = [v for key, v in self.events.items()
                if _is_event_of(launcher, key)]
        seen = sum(c for _, c in hits)
        total = sum(t for t, _ in hits)
        if launcher == "flash_attention_bwd":
            total = sum(t for key, (t, _) in self.events.items()
                        if any(e in key for e in BWD_EVENTS))
        return total / max(seen, 1), seen, self.made.get(launcher, 0)


def device_profile(torch, fn, n: int = 50) -> Profile:
    """``fn`` called n times under ``torch.profiler``.  Only the card's own
    events (kernels, memsets, copies) count as device time; host wall time
    includes the profiler's own overhead.  The profiler can miss some of
    many back-to-back launches in a long process, so a kernel's time is
    divided by the launches it saw, never by the calls made."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    before = ops.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / n * 1e3
    made = {name: c - before[name] for name, c in ops.launch_counts().items()
            if c > before[name]}
    events = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        total = getattr(e, "self_device_time_total", None)
        if total is None:
            total = e.self_cuda_time_total
        events[e.key] = (total / 1e3, e.count)
    return Profile(n, host, events, made)


def kernels_seen(prof: Profile) -> tuple[str, bool]:
    """Each hand-written kernel's device ms a launch seen, with the
    launches seen beside those made; and whether all were seen."""
    parts, complete = [], True
    for name in prof.made:
        ms, seen, made = prof.kernel(name)
        complete &= seen >= made
        parts.append(f"{name} {ms:.5f} ms a launch ({seen} of {made} "
                     "launches seen)")
    return "; ".join(parts), complete


def busy_line(prof: Profile, top: int = 3) -> str:
    """One printed summary of :func:`device_profile`.  Where the profiler
    missed launches of a hand-written kernel, the device total and busy
    share would read low: the line says so and gives no busy share."""
    dev = prof.events
    total = sum(ms for ms, _ in dev.values()) / prof.n
    names = sorted(dev, key=lambda k: -dev[k][0])[:top]

    def short(key):
        key = key.replace("(anonymous namespace)::", "")
        return key.removeprefix("void ").split("(")[0][:48]
    tops = ", ".join(f"{short(k)} {dev[k][0] / prof.n:.4f}" for k in names)
    kern, complete = kernels_seen(prof)
    launches = sum(c for _, c in dev.values()) / prof.n
    head = (f"host {prof.host:.4f} ms, device {total:.4f} ms per call, "
            f"{launches:.2f} device events per call")
    busy = (f"busy {total / prof.host:.3f}" if complete else
            "busy share not measured (the profiler missed launches; the "
            "device time is a lower bound)")
    return (f"{head}, {busy} (largest: {tops})"
            + (f"; kernels: {kern}" if kern else ""))


# ---------------------------------------------------------------------------
# kernels against their plain versions, at the main path's shapes
# ---------------------------------------------------------------------------

def agree_topk(torch, a, b, points, got, want, what: str):
    """Hold the kernel's (ids, dists) to the plain version's.

    The kernel sums each dot product in feature order, as cuBLAS does, and
    the row norms in the plain version's explicit order (``ref.sq_norms``),
    so the two agree bitwise where the library keeps that order.  The
    check allows what a change of summation order could move: a few f32
    ulps of |a|^2 + |b|^2 in a distance, and a different id only where the
    two candidates' exact (f64) distances to the row tie within that
    tolerance.  ``points`` maps ids to their vectors.  Returns (max
    distance error, id swaps, largest exact-distance gap of a swap,
    tolerance)."""
    (ki, kd), (pi, pd) = got, want
    an = (a.double() ** 2).sum(-1)
    bn = (b.double() ** 2).sum(-1)
    tol = 4e-6 * float(an.max() + bn.max())
    empty_p = pd >= 1e38
    check(torch.equal(kd >= 1e38, empty_p), f"{what}: empty slots differ")
    err = float((kd - pd)[~empty_p].abs().max())
    check(err <= tol, f"{what}: distance error {err} > {tol}")
    g, r, t = torch.nonzero(ki != pi, as_tuple=True)
    gap = 0.0
    if g.numel():
        def exact(ids):
            diff = a[g, r].double() - points[ids.long()].double()
            return (diff * diff).sum(-1)
        gap = float((exact(ki[g, r, t]) - exact(pi[g, r, t])).abs().max())
        check(gap <= tol, f"{what}: {g.numel()} id(s) differ by more than "
              f"a tie (exact distance gap {gap} > {tol})")
    return err, int(g.numel()), gap, tol


def exact_topk(torch, got, want, what: str) -> None:
    """Ids equal and distances bitwise equal to the plain version's."""
    (ki, kd), (pi, pd) = got, want
    diff = int((ki != pi).sum())
    check(diff == 0 and torch.equal(kd, pd), f"{what}: {diff} id slot(s) "
          f"differ, max |dist err| {float((kd - pd).abs().max())}")


def tie_grid(torch, n_points: int, d: int, seed: int):
    """Points on an integer grid in [0, 3)^d, each repeated 4 times and
    shuffled: products and norms are exact, so many distances tie
    exactly (the repeats at 0) and only the tie order decides the ids."""
    import numpy as np
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 3, (n_points // 4, d)).astype(np.float32)
    pts = np.repeat(base, 4, axis=0)[rng.permutation(n_points)]
    return torch.from_numpy(pts).cuda()


def check_topk(torch, x, cfg):
    """One tree's window fold at the fit's shapes through the index form
    (x and the sorted order, read in place): all ceil(N/W) blocks of W
    rows against their 3W candidates, k = K, seeded with the state the
    previous tree left, with dedup; a tie-heavy input (integer grid, each
    point 4 times) with and without dedup; k = 1 and k > N at shapes that
    are not multiples of the kernel's tiles; one exact search at the
    kernel's largest k (256) with multi-tile dedup.  Ids and distances
    must equal the plain version's exactly."""
    from repro_torch.core import knn
    from repro_torch.kernels import knn_topk, ref

    N, d = x.shape
    k, W = cfg.n_neighbors, cfg.window
    depth = knn._auto_depth(N, cfg.leaf_target)
    gen = torch.Generator(device=x.device).manual_seed(7)
    codes = knn.hash_codes(x, 2, depth, generator=gen)
    run_i = torch.full((N, k), -1, dtype=torch.int32, device=x.device)
    run_d = torch.full((N, k), ref.INVALID_DIST, device=x.device)
    run_i, run_d = knn._window_fold_one_tree(x, codes[:, 0], k, W, run_i,
                                             run_d)
    a, b, kw, _ = knn.window_fold_args(x, codes[:, 1], k, W, run_i, run_d)
    got = knn_topk.topk_sqdist(a, b, k, **kw)
    want = ref.topk_sqdist_ref(a, b, k, **kw)
    ga = ref.gather_rows(x, kw["a_idx"])
    gb = ref.gather_rows(x, kw["b_idx"])
    err, n_swaps, gap, tol = agree_topk(torch, ga, gb, x, got, want,
                                        "topk_sqdist")
    exact_topk(torch, got, want, "topk_sqdist (the fold)")

    checked = []
    ids = torch.arange(4000, dtype=torch.int32, device=x.device)
    pts = tie_grid(torch, 4000, 16, seed=3)
    for dedup, bn in ((False, None), (True, 128), (True, 1000)):
        kw_t = dict(a_ids=ids, b_ids=ids, dedup=dedup, bn=bn)
        exact_topk(torch, knn_topk.topk_sqdist(pts, pts, k, **kw_t),
                   ref.topk_sqdist_ref(pts, pts, k, **kw_t),
                   f"topk_sqdist (tie-heavy, dedup={dedup}, bn={bn})")
        checked.append(f"ties dedup={dedup} bn={bn}")
    # many columns against few rows (the queries' regime), with and
    # without a seed: long passes of ties through the filter and merges
    big = tie_grid(torch, 40_000, 16, seed=4)
    ids_b = torch.arange(40_000, dtype=torch.int32, device=x.device)
    q = big[:1000]
    kw_r = dict(a_ids=ids_b[:1000], b_ids=ids_b)
    exact_topk(torch, knn_topk.topk_sqdist(q, big, k, **kw_r),
               ref.topk_sqdist_ref(q, big, k, **kw_r),
               "topk_sqdist (ties, 1000 x 40000)")
    seed_i, seed_d = ref.topk_sqdist_ref(q, big[:15_000], k,
                                         a_ids=ids_b[:1000],
                                         b_ids=ids_b[:15_000])
    kw_s = dict(kw_r, init_ids=seed_i, init_dists=seed_d)
    exact_topk(torch, knn_topk.topk_sqdist(q, big, k, **kw_s),
               ref.topk_sqdist_ref(q, big, k, **kw_s),
               "topk_sqdist (ties, 1000 x 40000, seeded)")
    checked.append("ties 1000 x 40000, seeded and not")
    g2 = torch.Generator(device=x.device).manual_seed(8)
    for (G, M, Nc, dd), kk in (((3, 1001, 777, 37), 1), ((2, 45, 100, 9), k),
                               ((2, 33, 65, 37), 3)):
        a2 = torch.randn((G, M, dd), generator=g2, device=x.device)
        b2 = torch.randn((G, Nc, dd), generator=g2, device=x.device)
        exact_topk(torch, knn_topk.topk_sqdist(a2, b2, kk),
                   ref.topk_sqdist_ref(a2, b2, kk),
                   f"topk_sqdist (G={G}, M={M}, N={Nc}, d={dd}, k={kk})")
        checked.append(f"({G},{M},{Nc},{dd}) k={kk}")
    sub = x[None, :600].contiguous()
    ids = torch.arange(600, dtype=torch.int32, device=x.device)[None]
    kmax = knn_topk.MAX_K
    kw_max = dict(a_ids=ids, b_ids=ids, dedup=True, bn=128)
    exact_topk(torch, knn_topk.topk_sqdist(sub, sub, kmax, **kw_max),
               ref.topk_sqdist_ref(sub, sub, kmax, **kw_max),
               f"topk_sqdist (k={kmax})")
    checked.append(f"k={kmax} multi-tile dedup")

    G, M = kw["a_idx"].shape
    Nc = kw["b_idx"].shape[1]
    # the fold's own work: x (the rows and their candidates) read once,
    # the row and candidate indices, the seed state read, the result
    # written; products of every (row, candidate) pair and the norms
    n_bytes = 4 * (N * d + G * M + G * Nc + 4 * G * M * k)
    n_ops = 2 * G * M * Nc * d + 2 * N * d
    bms, by = bound_ms(n_bytes, n_ops)
    ms = time_ms(torch, lambda: knn_topk.topk_sqdist(a, b, k, **kw))

    def whole_fold():
        a2, b2, kw2, _ = knn.window_fold_args(x, codes[:, 1], k, W, run_i,
                                              run_d)
        return knn_topk.topk_sqdist(a2, b2, k, **kw2)
    fold_ms = time_ms(torch, whole_fold)
    plain = time_ms(torch, lambda: ref.topk_sqdist_ref(a, b, k, **kw),
                    reps=3, warmup=1)
    lib = time_ms(torch, lambda: torch.cdist(ga, gb).topk(
        k, dim=-1, largest=False))
    print(f"topk_sqdist: (G={G}, M={M}, N={Nc}, d={d}, k={k}, init, dedup, "
          f"x read in place through row indices) id slots differing from "
          f"the plain version: {n_swaps} of {got[0].numel()}, max |dist "
          f"err| {err:.3g}; also exact: {'; '.join(checked)}; kernel "
          f"{ms:.3f} ms, plain {plain:.3f} ms, torch.cdist+topk {lib:.3f} "
          f"ms (on the gathered blocks), bound {bms:.4f} ms ({by}); the "
          f"tree's whole fold {fold_ms:.3f} ms", flush=True)
    return dict(name="topk_sqdist", route="cuda",
                source="src/repro_torch/csrc/knn_topk.cu",
                replaces="src/repro/kernels/knn_topk.py:183",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


def _edge_batch(torch, gen, N, B, Mn, hub=None):
    """A random edge batch on N rows; with ``hub`` about 2,000 of its
    B*(2+M) updates go to that one row (300 sources, 300 targets and
    every 14th negative slot)."""
    dev = gen.device
    i = torch.randint(0, N, (B,), generator=gen, device=dev,
                      dtype=torch.int32)
    j = torch.randint(0, N, (B,), generator=gen, device=dev,
                      dtype=torch.int32)
    negs = torch.randint(0, N, (B, Mn), generator=gen, device=dev,
                         dtype=torch.int32)
    if hub is not None:
        i[:300] = hub
        j[300:600] = hub
        negs.view(-1)[::14] = hub
    mask = ((negs != i[:, None]) & (negs != j[:, None])).float()
    return i, j, negs, mask


def check_edge_step(torch, n_nodes, cfg):
    """The fit's step shape — y (N, 2), B = 4096 edges, M = 5 — a
    duplicate-dense batch on N = 64 rows and a hub batch (one row takes
    about 2,000 updates), each with a scalar lr, with the lr as a 0-d
    tensor on the card (what a captured step reads) and with per-edge lr
    and frozen rows; then 200 consecutive steps against 200 plain steps (the
    lists' heads must come back clean after every step).  Bitwise against
    the plain version run on a CPU copy (on CUDA its index_add_ is
    atomic).  The profiler's events of a call must all be the one
    kernel: no sort, no memset, no copy."""
    from repro_torch.kernels import largevis_step, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    B, Mn, s = cfg.batch_size, cfg.n_negatives, cfg.out_dim
    kw = dict(gamma=cfg.gamma, a=cfg.prob_a, clip=cfg.grad_clip)
    main, max_err = None, 0.0
    for N, hub in ((n_nodes, None), (64, None), (n_nodes, 7)):
        y = torch.randn((N, s), generator=gen, device=dev) * 10.0
        i, j, negs, mask = _edge_batch(torch, gen, N, B, Mn, hub)
        for lr, n_frozen in ((0.37, 0), (torch.tensor(0.37, device=dev), 0),
                             (torch.rand(B, generator=gen, device=dev),
                              N // 3)):
            want = ref.fused_edge_step_ref(
                y.cpu(), i.cpu(), j.cpu(), negs.cpu(), mask.cpu(),
                lr.cpu() if torch.is_tensor(lr) else lr, n_frozen=n_frozen,
                **kw)
            got = largevis_step.fused_edge_step(
                y.clone(), i, j, negs, mask, lr, n_frozen=n_frozen,
                **kw).cpu()
            err = float((got - want).abs().max())
            check(torch.equal(got, want), f"fused_edge_step: not bitwise at "
                  f"N={N}{' (hub batch)' if hub is not None else ''} "
                  f"(max err {err})")
            max_err = max(max_err, err)
        if main is None:
            main = (y, i, j, negs, mask)
    n_seq = 200
    y = torch.randn((n_nodes, s), generator=gen, device=dev) * 10.0
    yc = y.cpu()
    for t in range(n_seq):
        batch = _edge_batch(torch, gen, n_nodes, B, Mn)
        lr = 1.0 - t / n_seq
        largevis_step.fused_edge_step(y, *batch, lr, **kw)
        ref.fused_edge_step_ref(yc, *(b.cpu() for b in batch), lr, **kw)
    check(torch.equal(y.cpu(), yc), f"fused_edge_step: {n_seq} consecutive "
          "steps differ from the plain version's")

    y, i, j, negs, mask = main
    yk = y.clone()
    ms = time_ms(torch, lambda: largevis_step.fused_edge_step(
        yk, i, j, negs, mask, 0.37, **kw), reps=50)
    prof = device_profile(torch, lambda: largevis_step.fused_edge_step(
        yk, i, j, negs, mask, 0.37, **kw))
    kern_ms, seen, made = prof.kernel("fused_edge_step")
    others = [k for k in prof.events if not _is_event_of("fused_edge_step",
                                                          k)]
    check(not others, f"fused_edge_step: a call launched more than its "
          f"kernel: {others}")
    check(0 < seen <= made == prof.n, f"fused_edge_step: {seen} device "
          f"launches seen for {made} launches made in {prof.n} calls")
    yp = y.clone()
    plain = time_ms(torch, lambda: ref.fused_edge_step_ref(
        yp, i, j, negs, mask, 0.37, **kw), reps=50)
    lib, bms, by = edge_step_yardsticks(torch, gen, y, i, j, negs)
    print(f"fused_edge_step: (N={n_nodes}, s={s}, B={B}, M={Mn}) bitwise "
          f"equal to the plain version, also at N=64, on a hub batch (one "
          f"row takes about 2,000 updates), with the lr a 0-d tensor on the "
          f"card, with per-edge lr and frozen rows, and over {n_seq} "
          f"consecutive steps; device launches a "
          f"call: 1 kernel, no other event ({seen} of {made} launches "
          f"seen); kernel {ms:.4f} ms a call by CUDA events, {kern_ms:.5f} "
          f"ms of device time a launch (profiler), plain (atomic "
          f"index_add_) {plain:.4f} ms, index_add_ (the scatter alone; no "
          f"call computes the step) {lib:.4f} ms, bound {bms:.5f} ms "
          f"({by})", flush=True)
    return dict(name="fused_edge_step", route="cuda",
                source="src/repro_torch/csrc/largevis_step.cu",
                replaces="src/repro/kernels/largevis_step.py:268",
                max_abs_err=max_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


def edge_step_yardsticks(torch, gen, y, i, j, negs):
    """An edge step's library time, ``index_add_`` of as many random
    updates into the batch's rows (the scatter alone; no call computes
    the step), and its bound: the rows it touches read and written once,
    the batch read; the forces' and the updates' operations."""
    s = y.shape[1]
    B, Mn = negs.shape
    idx = torch.cat([i[:, None], j[:, None], negs], 1).reshape(-1).long()
    upd = torch.randn((idx.numel(), s), generator=gen, device=y.device)
    yl = y.clone()
    lib = time_ms(torch, lambda: yl.index_add_(0, idx, upd), reps=50)
    rows = int(torch.unique(idx).numel())
    n_bytes = 4 * (2 * rows * s + 2 * B + 2 * B * Mn)
    n_ops = B * ((4 * s + 2) + Mn * (7 * s + 3) + 2 * (2 + Mn) * s)
    return (lib, *bound_ms(n_bytes, n_ops))


def pairwise_bound(M: int, N: int, d: int) -> tuple[float, str]:
    """Bytes: a and b read once, the (M, N) matrix written once; operations:
    the products, the norms and the epilogue."""
    return bound_ms(4 * (M * d + N * d + M * N),
                    2 * M * N * d + 2 * (M + N) * d + 3 * M * N)


def pairwise_shapes(torch, x):
    """The metrics' two shapes on the fit's data: graph_recall's (2000 rows
    of x against all of x, d = 100) and the layout accuracy's at d = 2
    (1000 rows against the other 99,000)."""
    rows = torch.randperm(x.shape[0], generator=torch.Generator(
        device=x.device).manual_seed(17), device=x.device)[:2000]
    return {"recall": (x[rows].contiguous(), x),
            "accuracy": (x[:1000, :2].contiguous(),
                         x[1000:, :2].contiguous())}


def check_pairwise(torch, x):
    """graph_recall's shape (2000, 100) x (100000, 100), the layout
    accuracy's (1000, 2) x (99000, 2) and one off the 128 x 128 tiles
    (777, 100) x (50001, 100): each against the plain version (cuBLAS's
    product: bitwise where it keeps feature order, else within a few ulps
    of |a|^2 + |b|^2), the two main shapes timed beside ``torch.cdist``
    and their bounds."""
    from repro_torch.kernels import knn_topk, ref

    shapes = pairwise_shapes(torch, x)
    shapes["off-tile"] = (x[:777].contiguous(), x[:50_001])
    parts, rec = [], None
    for name, (a, b) in shapes.items():
        got = knn_topk.pairwise_sqdist(a, b)
        want = ref.pairwise_sqdist_ref(a, b)
        if name == "accuracy":
            tol = 1e-3
        else:
            an = (a.double() ** 2).sum(-1)
            bn = (b.double() ** 2).sum(-1)
            tol = 4e-6 * float(an.max() + bn.max())
        err = float((got - want).abs().max())
        check(err <= tol, f"pairwise_sqdist ({name}): error {err} > {tol}")
        M, d = a.shape
        N = b.shape[0]
        txt = (f"{name} ({M}, {d}) x ({N}, {d}): max |err| {err:.3g} (tol "
               f"{tol:.3g}, {int((got != want).sum())} of {M * N} entries "
               f"not bitwise)")
        del got, want
        if name != "off-tile":
            ms = time_ms(torch, lambda: knn_topk.pairwise_sqdist(a, b))
            plain = time_ms(torch, lambda: ref.pairwise_sqdist_ref(a, b))
            lib = time_ms(torch, lambda: torch.cdist(a, b))
            mm = time_ms(torch, lambda: a @ b.T)
            bms, by = pairwise_bound(M, N, d)
            txt += (f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                    f"torch.cdist {lib:.4f} ms, cuBLAS's f32 product alone "
                    f"(a @ b.T) {mm:.4f} ms, bound {bms:.4f} ms ({by})")
            if name == "recall":
                clk = clocks_during(torch, lambda: knn_topk.pairwise_sqdist(
                    a, b))
                txt += (f"; SM clock and power while the kernel runs "
                        f"(MHz, max MHz, W): {clk}")
            if rec is None:
                rec = dict(name="pairwise_sqdist", route="cuda",
                           source="src/repro_torch/csrc/knn_topk.cu",
                           replaces="src/repro/kernels/knn_topk.py:65",
                           max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=bms, bound_by=by, library_ms=lib)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        parts.append(txt)
    print("pairwise_sqdist: " + "; ".join(parts), flush=True)
    return rec


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def check_split_kernels(torch, cfg):
    """The split route's kernels at its shapes, each bitwise against its
    plain version run on a CPU copy (the reference: on CUDA the plain
    scatter's index_add_ is atomic).  The indexed ``largevis_grads``
    (what the split route launches) on a scale-10 y (N = 100,000, s = 2)
    at B = 4096, 4095 and 37 with M = 5 negatives, with the lr a float, a
    0-d tensor on the card and a per-edge vector with frozen rows, and on
    a hub batch (one row takes about 2,000 updates); the gathered form on
    rows of the same y at the same B, about a tenth of the negatives
    masked; the ordered scatter of the B*(2+M) update rows, also on a
    duplicate-dense N = 64 and at the in-degree sum's size."""
    from repro_torch.kernels import largevis_grad, largevis_step, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    B, Mn, s = cfg.batch_size, cfg.n_negatives, cfg.out_dim
    kw = dict(gamma=cfg.gamma, a=cfg.prob_a, clip=cfg.grad_clip)
    y = torch.randn((N_POINTS, s), generator=gen, device=dev) * 10.0
    yc = y.cpu()
    max_err, n_cases = 0.0, 0
    for b, hub in ((B, None), (B - 1, None), (37, None), (B, 7)):
        batch = _edge_batch(torch, gen, N_POINTS, b, Mn, hub)
        for lr, n_frozen in ((0.37, 0), (torch.tensor(0.37, device=dev), 0),
                             (torch.rand(b, generator=gen, device=dev),
                              N_POINTS // 3)):
            want = ref.largevis_grads_stream_ref(
                yc, *(t.cpu() for t in batch),
                lr.cpu() if torch.is_tensor(lr) else lr, n_frozen, **kw)
            got = [t.cpu() for t in largevis_grad.largevis_grads_stream(
                y, *batch, lr, n_frozen, **kw)]
            err = float((got[1] - want[1]).abs().max())
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1]),
                  f"largevis_grads (indexed): not bitwise at B={b}"
                  f"{' (hub batch)' if hub is not None else ''}, lr "
                  f"{type(lr).__name__}, n_frozen={n_frozen} (max err "
                  f"{err})")
            max_err = max(max_err, err)
            n_cases += 1
    batch = _edge_batch(torch, gen, N_POINTS, B, Mn)
    lr = torch.tensor(0.37, device=dev)      # what a captured step reads
    ms = time_ms(torch, lambda: largevis_grad.largevis_grads_stream(
        y, *batch, lr, **kw), reps=50)
    plain_ms = time_ms(torch, lambda: ref.largevis_grads_stream_ref(
        y, *batch, lr, **kw), reps=50)
    prof = device_profile(torch, lambda: largevis_grad.largevis_grads_stream(
        y, *batch, lr, **kw))
    kern_ms, kern_seen, kern_made = prof.kernel("largevis_grads")
    check(kern_seen > 0, "largevis_grads (indexed): the profiler saw no "
          "launch")
    others = [k for k in prof.events if not _is_event_of("largevis_grads",
                                                          k)]
    check(not others, f"largevis_grads (indexed): a call launched more than "
          f"its kernel: {others}")
    i, j, negs, mask = batch
    U = B * (2 + Mn)
    rows = int(torch.unique(torch.cat([i[:, None], j[:, None], negs],
                                      1)).numel())
    # read: the U indices, the rows they name, the mask; write: the U
    # indices and update rows
    n_bytes = 4 * (U + rows * s + B * Mn + U + U * s)
    n_ops = B * ((4 * s + 2) + Mn * (7 * s + 3)) + U * s
    bms, by = bound_ms(n_bytes, n_ops)

    # the gathered form (the JAX contract), bitwise as before
    card_err, g_err = 0.0, 0.0
    main = None
    for b in (B, B - 1, 37):
        i = torch.randint(0, N_POINTS, (b,), generator=gen, device=dev)
        j = torch.randint(0, N_POINTS, (b,), generator=gen, device=dev)
        negs = torch.randint(0, N_POINTS, (b, Mn), generator=gen,
                             device=dev)
        keep = torch.rand((b, Mn), generator=gen, device=dev) > 0.1
        mask = (keep & (negs != i[:, None]) & (negs != j[:, None])).float()
        args = (y[i], y[j], y[negs], mask)
        got = largevis_grad.largevis_grads(*args, **kw)
        want = ref.largevis_grads_ref(*(t.cpu() for t in args[:3]),
                                      neg_mask=mask.cpu(), **kw)
        plain = ref.largevis_grads_ref(*args[:3], neg_mask=mask, **kw)
        for g, w, c in zip(got, want, plain):
            err = float((g.cpu() - w).abs().max())
            check(torch.equal(g.cpu(), w), f"largevis_grads (gathered): not "
                  f"bitwise at B={b} (max err {err})")
            g_err = max(g_err, err)
            card_err = max(card_err, float((c - g).abs().max()))
        if main is None:
            main = args
    g_ms = time_ms(torch, lambda: largevis_grad.largevis_grads(*main, **kw),
                   reps=50)
    g_kern, g_seen, g_made = device_profile(
        torch, lambda: largevis_grad.largevis_grads(*main, **kw)).kernel(
            "largevis_grads")
    check(g_seen > 0, "largevis_grads (gathered): the profiler saw no launch")

    # the step size (linked lists, one launch) on the fit's N and on a
    # duplicate-dense N = 64; the in-degree sum's size U = N*K, s = 1
    # (above LINK_MAX_U: the sort and one thread a row segment)
    scatter_ms = {}
    U_deg = N_POINTS * cfg.n_neighbors
    for N, U, w in ((N_POINTS, B * (2 + Mn), s), (64, B * (2 + Mn), s),
                    (N_POINTS, U_deg, 1)):
        idx = torch.randint(0, N, (U,), generator=gen, device=dev,
                            dtype=torch.int32)
        upd = torch.randn((U, w), generator=gen, device=dev)
        yb = torch.randn((N, w), generator=gen, device=dev)
        want = ref.scatter_add_ordered_ref(yb.cpu(), idx.cpu(), upd.cpu())
        got = largevis_step.scatter_add_ordered(yb.clone(), idx, upd).cpu()
        check(torch.equal(got, want), f"scatter_add_ordered: not bitwise at "
              f"N={N}, U={U} (max err {float((got - want).abs().max())})")
        path = "lists" if U <= largevis_step.LINK_MAX_U else "sort"
        if N == N_POINTS:
            yk = yb.clone()
            scatter_ms[path, U] = time_ms(
                torch, lambda: largevis_step.scatter_add_ordered(yk, idx,
                                                                 upd),
                reps=50 if path == "lists" else 5)
            if path == "lists":
                prof = device_profile(torch, lambda: largevis_step
                                      .scatter_add_ordered(yk, idx, upd))
                others = [k for k in prof.events
                          if not _is_event_of("scatter_add_ordered", k)]
                check(not others, "scatter_add_ordered at the step size "
                      f"launched more than its kernel: {others}")
    scatter_txt = ", ".join(f"{path} (U={U}) {ms:.4f} ms"
                            for (path, U), ms in scatter_ms.items())
    print(f"largevis_grads (indexed: y read in place, the update stream "
          f"written): (N={N_POINTS}, s={s}, B={B}, M={Mn}) bitwise equal to "
          f"the plain version on a CPU copy in {n_cases} cases (B={B}, "
          f"{B - 1}, 37 and a hub batch; the lr a float, a 0-d tensor on "
          f"the card, per edge with frozen rows); {ms:.4f} ms a call (CUDA "
          f"events over back-to-back calls: the wrapper's host time), of "
          f"which the kernel's own device time {kern_ms:.5f} ms a launch "
          f"(profiler, {kern_seen} of {kern_made} launches seen; no other "
          f"event), plain (gathers, forces, stream) {plain_ms:.4f} ms, no "
          f"single library call, bound {bms:.6f} ms ({by}: {n_bytes} bytes, "
          f"{rows} rows of y); gathered form bitwise at B={B}, {B - 1}, 37 "
          f"(the plain version on the card: max |err| {card_err:.3g}), "
          f"{g_ms:.4f} ms a call, {g_kern:.5f} ms a launch ({g_seen} of "
          f"{g_made} seen); scatter_add_ordered bitwise equal to the plain "
          f"version at the step size (U={B * (2 + Mn)}, also on N=64; one "
          f"launch, no other event) and at the in-degree size (U={U_deg}, "
          f"s=1): {scatter_txt}", flush=True)
    return dict(name="largevis_grads", route="cuda",
                source="src/repro_torch/csrc/largevis_grad.cu",
                replaces="src/repro/kernels/largevis_grad.py:55",
                max_abs_err=max(max_err, g_err), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None)


def run_fit(torch, x, labels, cfg):
    from repro_torch import largevis
    from repro_torch.core import metrics
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = largevis(x, cfg=cfg, device="cuda")
    fit_s = time.perf_counter() - t0
    fused = ops.launch_counts()["fused_edge_step"]
    print(f"fit's layout: layout_s {res.timings['layout_s']:.3f} s, "
          f"{res.steps} steps in {res.dispatches} dispatches of "
          f"{res.steps_per_dispatch} (the first eager, the rest CUDA graph "
          f"replays), {res.timings['layout_s'] / res.steps * 1e3:.4f} ms a "
          f"step; fused_edge_step launches {fused}", flush=True)
    check(res.steps_per_dispatch == cfg.steps_per_dispatch
          and res.dispatches == -(-res.steps // cfg.steps_per_dispatch),
          f"the layout ran {res.dispatches} dispatches of "
          f"{res.steps_per_dispatch} steps")
    check(fused == res.steps, f"fused_edge_step launched {fused} times in a "
          f"layout of {res.steps} steps")
    recall = metrics.graph_recall(res.x, res.knn_idx)
    acc = metrics.knn_classifier_accuracy(res.y, labels)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    N = x.shape[0]
    t = res.timings
    print(f"fit: N={N} d={x.shape[1]} K={cfg.n_neighbors} trees="
          f"{cfg.n_trees} window={cfg.window} explore={cfg.n_explore_iters} "
          f"perplexity={cfg.perplexity} M={cfg.n_negatives} "
          f"samples_per_node={cfg.samples_per_node} batch={cfg.batch_size}: "
          f"{fit_s:.2f} s (knn {t['knn_s']:.3f} s, weights "
          f"{t['weights_s']:.3f} s, sampler {t['sampler_s']:.3f} s, layout "
          f"{t['layout_s']:.3f} s; {res.edge_samples} edge samples); "
          f"graph_recall {recall:.4f}, knn_classifier_accuracy {acc:.4f}; "
          f"launches {counts}", flush=True)
    check(tuple(res.y.shape) == (N, cfg.out_dim), f"y shape {res.y.shape}")
    check(bool(torch.isfinite(res.y).all()), "the layout is not finite")
    check(tuple(res.knn_idx.shape) == (N, cfg.n_neighbors),
          f"graph shape {res.knn_idx.shape}")
    check(bool(((res.knn_idx >= 0) & (res.knn_idx < N)).all()),
          "the graph holds an empty or out-of-range slot")
    rows = torch.arange(N, device=res.knn_idx.device)[:, None]
    check(bool((res.knn_idx != rows).all()), "the graph holds a self edge")
    check(bool((res.knn_dist.diff(dim=1) >= 0).all()),
          "graph distances are not ascending")
    check(bool(torch.isfinite(res.weights).all())
          and bool((res.weights >= 0).all()), "negative edge weights")
    # floors, not targets: the graph stage is held id for id to the JAX
    # package on the CPU; here a broken kernel or route would show as a
    # collapse (isotropic 100-d clusters make exact 150-NN hard: the
    # forest + one exploring round recovers about three quarters)
    check(recall >= 0.7, f"graph_recall {recall} < 0.7")
    check(acc >= 0.8, f"knn_classifier_accuracy {acc} < 0.8")
    for name in ("topk_sqdist", "fused_edge_step", "pairwise_sqdist"):
        check(counts[name] > 0, f"{name} was not launched on the main path")
    return res, acc, counts


def _step_kw(res, cfg):
    return dict(edge_sampler=res.edge_sampler, neg_sampler=res.neg_sampler,
                n_negatives=cfg.n_negatives, a=cfg.prob_a, gamma=cfg.gamma,
                clip=cfg.grad_clip, rho0=cfg.rho0, batch=cfg.batch_size)


def run_routes(torch, res, cfg, steps: int = 50):
    """``steps`` fused and ``steps`` split SGD steps from the fitted y and
    the fit's samplers, each from a generator seeded alike, in the order
    fused, split, split, fused: every result bitwise equal.  Host-bound
    step times compare only within one call."""
    from repro_torch.core import layout_engine

    kw = _step_kw(res, cfg)
    outs, ms = [], {"fused": [], "split": []}
    for route in ("fused", "split", "split", "fused"):
        y = res.y.clone()
        gen = torch.Generator(device=y.device).manual_seed(21)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(steps):
            y = layout_engine.sgd_edge_step(y, gen, t / steps,
                                            layout_step=route, **kw)
        torch.cuda.synchronize()
        ms[route].append((time.perf_counter() - t0) / steps * 1e3)
        outs.append(y)
    for y in outs[1:]:
        check(torch.equal(y, outs[0]), "fused and split steps differ")
    check(not torch.equal(outs[0], res.y), "the steps did not move y")
    fused, split = (sum(v) / len(v) for v in (ms["fused"], ms["split"]))
    print(f"routes: {steps} fused and {steps} split steps (B="
          f"{cfg.batch_size}) from the fitted layout bitwise equal, twice "
          f"each; fused {fused:.4f} ms/step, split {split:.4f} ms/step "
          f"(host clock, this call)", flush=True)
    profs = {}
    for route in ("fused", "split"):
        profs[route] = prof = profile_steps(torch, res, cfg, route, steps)
        print(f"  profiled {route} step: {busy_line(prof)}; device launches "
              f"a step {step_launches(prof)}", flush=True)
    H = cfg.steps_per_dispatch
    split = profile_replays(torch, res, cfg, "split", H)
    print(f"  profiled split replays (10 of {H} steps): "
          f"{replay_line(split, H)}", flush=True)
    return profs["fused"]


def layout_busy(res, replays: Profile, eager: Profile, H: int = 100):
    """The fit's layout's busy share two ways: the profiled replays'
    device ms a step, and the profiled eager step's, each times the
    layout's steps over its ``layout_s``."""
    parts = []
    for name, prof, n_steps in (("graph replays", replays, replays.n * H),
                                ("eager steps", eager, eager.n)):
        dev_ms = sum(t for t, _ in prof.events.values()) / n_steps
        seen = kernels_seen(prof)[1]
        parts.append(f"{name}: {dev_ms:.5f} ms of device time a step "
                     f"({'every' if seen else 'not every'} hand-written "
                     f"launch seen) x {res.steps} steps / layout_s = "
                     f"{dev_ms * res.steps / 1e3 / res.timings['layout_s']:.3f}")
    print(f"fit's layout busy share, from the {'; from the '.join(parts)}",
          flush=True)


def profile_steps(torch, res, cfg, route: str, n: int) -> Profile:
    """``n`` SGD steps of one route from the fitted layout, profiled."""
    from repro_torch.core import layout_engine

    kw = _step_kw(res, cfg)
    y = res.y.clone()
    gen = torch.Generator(device=y.device).manual_seed(22)
    return device_profile(torch, lambda: layout_engine.sgd_edge_step(
        y, gen, 0.5, layout_step=route, **kw), n=n)


def step_launches(prof: Profile) -> str:
    """Device events a step, with the largest few counts by name."""
    per = {k: c / prof.n for k, (_, c) in prof.events.items()}
    total = sum(per.values())

    def short(key):
        key = key.replace("(anonymous namespace)::", "")
        return key.removeprefix("void ").split("(")[0][:40]
    top = sorted(per, key=lambda k: -per[k])[:4]
    return (f"{total:.2f} ("
            + ", ".join(f"{short(k)} {per[k]:.2f}" for k in top) + ", ...)")


def run_split_layout(torch, res, labels, cfg):
    """The layout of the fit's graph by the split route, its launch
    counts read just before and just after."""
    from repro_torch import RoutingConfig
    from repro_torch.core import metrics
    from repro_torch.core.largevis import layout_graph
    from repro_torch.kernels import ops

    spn = min(SPLIT_SAMPLES_PER_NODE, cfg.samples_per_node)
    scfg = dataclasses.replace(cfg, samples_per_node=spn,
                               routing=RoutingConfig(layout_step="split"))
    print(f"cut: split layout samples_per_node {PAPER_SAMPLES_PER_NODE} -> "
          f"{spn} (a second layout of full length would add minutes to the "
          f"run; the fit's fused layout ran at {cfg.samples_per_node})",
          flush=True)
    ops.reset_launch_counts()
    lay, t = layout_graph(res.knn_idx, res.weights, cfg=scfg, device="cuda")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    acc = metrics.knn_classifier_accuracy(lay.y, labels)
    print(f"split layout: samples_per_node={spn}, {lay.steps} steps in "
          f"{lay.dispatches} dispatches, "
          f"layout_s {t['layout_s']:.3f} s ({t['layout_s'] / lay.steps * 1e3:.4f}"
          f" ms/step), sampler_s {t['sampler_s']:.3f} s; "
          f"knn_classifier_accuracy {acc:.4f}; launches {counts}",
          flush=True)
    check(bool(torch.isfinite(lay.y).all()), "split layout not finite")
    check(acc >= 0.8, f"split layout accuracy {acc} < 0.8")
    check(counts["largevis_grads"] == lay.steps
          and counts["scatter_add_ordered"] == lay.steps + 1,
          f"the split layout of {lay.steps} steps launched largevis_grads "
          f"{counts['largevis_grads']} times and the ordered scatter "
          f"{counts['scatter_add_ordered']} (one a step, one in-degree sum)")
    check(counts["fused_edge_step"] == 0,
          "the split layout launched the fused edge step")
    return counts


def run_autodiff(torch, res, cfg, steps: int = 200):
    """``steps`` split steps of ``prob_fn="exp_quadratic"`` (autograd
    forces) from the fitted layout."""
    from repro_torch.core import layout_engine

    kw = _step_kw(res, cfg)
    y = res.y.clone()
    gen = torch.Generator(device=y.device).manual_seed(23)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        y = layout_engine.sgd_edge_step(y, gen, t / steps, layout_step="split",
                                        prob_fn="exp_quadratic", **kw)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    moved = float((y - res.y).abs().max())
    print(f"autodiff: {steps} split steps of prob_fn=exp_quadratic, "
          f"{step_ms:.4f} ms/step, finite, max |dy| {moved:.4g}", flush=True)
    check(bool(torch.isfinite(y).all()), "exp_quadratic steps not finite")
    check(moved > 0, "exp_quadratic steps did not move y")


def held_out(n: int, seed: int):
    """n more points of the fit's mixture: its centres are
    ``gaussian_mixture``'s first draw from ``default_rng(0)``; labels and
    noise come from ``default_rng(seed)``."""
    import numpy as np
    centers = (np.random.default_rng(0).standard_normal((CLUSTERS, DIM))
               * 6.0 / np.sqrt(2))
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, CLUSTERS, n)
    x = centers[labels] + rng.standard_normal((n, DIM))
    return x.astype(np.float32), labels


def query_accuracy(torch, y_corpus, labels, y_query, q_labels, k=5,
                   chunk=1000):
    """5-NN label accuracy of the queries against the corpus layout, in
    row chunks (10k x 100k distances at once would be 4 GB)."""
    from repro_torch.kernels import ops

    hits = 0
    for r0 in range(0, y_query.shape[0], chunk):
        d = ops.pairwise_sqdist(y_query[r0:r0 + chunk], y_corpus)
        nn = torch.sort(d, dim=1, stable=True).indices[:, :k]
        votes = torch.nn.functional.one_hot(labels[nn], CLUSTERS).sum(1)
        hits += int((votes.argmax(1) == q_labels[r0:r0 + chunk]).sum())
    return hits / y_query.shape[0]


def run_transform(torch, res, labels, acc_fit, cfg):
    """``LargeVis.transform`` of N_TRANSFORM held-out points by the fused
    (default) and the split route; the carrier never changes.  Returns
    the fused route's 5-NN accuracy of the queries."""
    from repro_torch import LargeVis, RoutingConfig
    from repro_torch.kernels import knn_topk, ops, ref

    dev = res.y.device
    xq_np, lq_np = held_out(N_TRANSFORM, seed=1)
    xq = torch.from_numpy(xq_np).to(dev)
    lq = torch.from_numpy(lq_np).to(dev)
    lab = torch.from_numpy(labels).to(dev)
    y_before = res.y.clone()
    out, accs = {}, {}
    for route in ("auto", "split"):
        rcfg = dataclasses.replace(cfg, routing=RoutingConfig(
            layout_step=route))
        model = LargeVis(rcfg, device="cuda")
        model.result_ = dataclasses.replace(res, cfg=rcfg)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yq = model.transform(xq)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        acc = query_accuracy(torch, res.y, lab, yq, lq)
        print(f"transform ({route}): Q={N_TRANSFORM} into N={N_POINTS}, "
              f"{cfg.transform_steps} steps, {secs:.3f} s; 5-NN accuracy "
              f"{acc:.4f} (fit {acc_fit:.4f}); launches {counts}",
              flush=True)
        check(torch.equal(res.y, y_before), "transform changed the carrier")
        check(tuple(yq.shape) == (N_TRANSFORM, cfg.out_dim)
              and bool(torch.isfinite(yq).all()), "transform rows not finite")
        check(acc >= acc_fit - 0.05,
              f"transform accuracy {acc} < fit {acc_fit} - 0.05")
        check(counts["topk_sqdist"] > 0, "transform skipped topk_sqdist")
        step = "largevis_grads" if route == "split" else "fused_edge_step"
        check(counts[step] == cfg.transform_steps,
              f"transform ({route}) launched {step} {counts[step]} times")
        out[route], accs[route] = yq, acc
    check(torch.equal(out["auto"], out["split"]),
          "the fused and split transforms differ")

    a = xq[None, :1000].contiguous()
    k = min(cfg.n_neighbors, N_POINTS)
    got = knn_topk.topk_sqdist(a, res.x[None], k)
    want = ref.topk_sqdist_ref(a, res.x[None], k)
    err, swaps, gap, tol = agree_topk(torch, a, res.x[None], res.x, got,
                                      want, "topk_sqdist (queries)")
    exact_topk(torch, got, want, "topk_sqdist (queries)")
    ms, lib, bms, by = time_queries(torch, xq, res.x, k)
    print(f"query_neighbors: topk_sqdist (G=1, M=1000, N={N_POINTS}, "
          f"d={DIM}, k={k}) {swaps} id slot(s) differ from the plain "
          f"version, max |dist err| {err:.3g}; all {N_TRANSFORM} queries "
          f"(1, {N_TRANSFORM}, {N_POINTS}): kernel {ms:.3f} ms, "
          f"torch.cdist+topk {lib:.3f} ms, bound {bms:.4f} ms ({by}); the "
          f"two transforms bitwise equal", flush=True)
    return accs["auto"]


def time_queries(torch, xq, x, k: int):
    """``topk_sqdist`` of every query against the corpus, (1, Q, N): the
    kernel, ``torch.cdist`` + ``topk`` and the bound (ms)."""
    from repro_torch.kernels import knn_topk

    Q, d = xq.shape
    N = x.shape[0]
    ms = time_ms(torch, lambda: knn_topk.topk_sqdist(xq[None], x[None], k),
                 reps=3, warmup=1)
    lib = time_ms(torch, lambda: torch.cdist(xq[None], x[None]).topk(
        k, dim=-1, largest=False), reps=3, warmup=1)
    n_bytes = 4 * (Q * d + N * d + 2 * Q * k)
    n_ops = 2 * Q * N * d + 2 * (Q + N) * d
    bms, by = bound_ms(n_bytes, n_ops)
    return ms, lib, bms, by


# ---------------------------------------------------------------------------
# the projection server
# ---------------------------------------------------------------------------

def _engine_drain(res, xq, *, seed: int = 7, **kw):
    """A fresh ``ProjectionEngine`` of SERVE_PROJ_SLOTS slots on the fit,
    every query of xq (numpy) submitted, drained.  Returns (engine,
    requests, steps)."""
    from repro_torch.launch.serve_projection import (ProjectionEngine,
                                                     ProjectRequest)

    eng = ProjectionEngine(res, slots=SERVE_PROJ_SLOTS, seed=seed, **kw)
    reqs = [ProjectRequest(r, xq[r]) for r in range(xq.shape[0])]
    for r in reqs:
        check(eng.submit(r), f"request {r.rid} refused")
    return eng, reqs, eng.run()


def _served(torch, res, eng, reqs, what: str):
    """The requests' coordinates (Q, s) numpy, after checking that every
    one completed with finite coordinates and that the engine's corpus
    rows are still bitwise the fit's."""
    import numpy as np

    check(all(r.done and r.error is None and r.y is not None for r in reqs),
          f"{what}: {sum(r.error is not None for r in reqs)} request(s) "
          f"failed, {sum(not r.done for r in reqs)} not done")
    y = np.stack([r.y for r in reqs])
    check(y.shape == (len(reqs), res.y.shape[1])
          and bool(np.isfinite(y).all()), f"{what}: non-finite results")
    check(torch.equal(eng.y_full[:res.y.shape[0]], res.y),
          f"{what}: the corpus rows moved")
    return y


def check_engine_kernels(torch, res, cfg, xb):
    """The two kernels of the engine at its shapes: ``topk_sqdist`` of one
    admit block, (1, slots, d) x (1, N, d), k = K, ids and distances
    exactly the plain version's; ``fused_edge_step`` of one lockstep step,
    y (N + slots, 2), B = slots, per-slot lr from the slot lr table,
    n_frozen = N, every other slot idle (its positive looped onto itself,
    its negatives masked), bitwise the plain version on a CPU copy, the
    idle rows and the corpus keeping their bits, and the split route's
    two kernels on the same batch bitwise equal to it.  Returns the
    admit block's top-k time (ms)."""
    from repro_torch.kernels import knn_topk, largevis_grad, largevis_step, \
        ref
    from repro_torch.launch.serve_projection import slot_lr, slot_lr_table

    dev = res.y.device
    N, S, Mn = res.y.shape[0], xb.shape[0], cfg.n_negatives
    k = min(cfg.n_neighbors, N)
    a = xb[None]
    exact_topk(torch, knn_topk.topk_sqdist(a, res.x[None], k),
               ref.topk_sqdist_ref(a, res.x[None], k),
               "topk_sqdist (an admit block)")
    topk_ms, topk_lib, topk_bms, topk_by = time_queries(torch, xb, res.x, k)
    topk_plain = time_ms(torch, lambda: ref.topk_sqdist_ref(a, res.x[None],
                                                            k),
                         reps=3, warmup=1)

    gen = torch.Generator(device=dev).manual_seed(13)
    i32 = dict(dtype=torch.int32, device=dev)
    y = torch.cat([res.y, torch.randn((S, res.y.shape[1]), generator=gen,
                                      device=dev) * 10.0])
    i = N + torch.arange(S, **i32)
    idle = torch.arange(S, device=dev) % 2 == 1
    j = torch.where(idle, i, torch.randint(0, N, (S,), generator=gen, **i32))
    negs = torch.randint(0, N, (S, Mn), generator=gen, **i32)
    mask = ((negs != j[:, None]) & ~idle[:, None]).float()
    ages = torch.randint(0, cfg.transform_steps, (S,), generator=gen, **i32)
    lr = slot_lr(slot_lr_table(cfg.transform_rho0 or cfg.rho0,
                               cfg.transform_steps, dev), ages)
    kw = dict(gamma=cfg.gamma, a=cfg.prob_a, clip=cfg.grad_clip, n_frozen=N)
    want = ref.fused_edge_step_ref(y.cpu(), i.cpu(), j.cpu(), negs.cpu(),
                                   mask.cpu(), lr.cpu(), **kw)
    got = largevis_step.fused_edge_step(y.clone(), i, j, negs, mask, lr,
                                        **kw)
    err = float((got.cpu() - want).abs().max())
    check(torch.equal(got.cpu(), want), "fused_edge_step (an engine step): "
          f"not bitwise the plain version (max err {err})")
    rows = N + torch.nonzero(idle).flatten()
    check(torch.equal(got[rows], y[rows]) and torch.equal(got[:N], res.y),
          "fused_edge_step (an engine step): an idle slot or the corpus "
          "moved")
    idx, upd = largevis_grad.largevis_grads_stream(y, i, j, negs, mask, lr,
                                                   N, gamma=cfg.gamma,
                                                   a=cfg.prob_a,
                                                   clip=cfg.grad_clip)
    split = largevis_step.scatter_add_ordered(y.clone(), idx, upd)
    check(torch.equal(split, got), "the split route's kernels differ from "
          "fused_edge_step on an engine step")
    yk = y.clone()
    ms = time_ms(torch, lambda: largevis_step.fused_edge_step(
        yk, i, j, negs, mask, lr, **kw), reps=50)
    yp = y.clone()
    plain = time_ms(torch, lambda: ref.fused_edge_step_ref(
        yp, i, j, negs, mask, lr, **kw), reps=20)
    lib, bms, by = edge_step_yardsticks(torch, gen, y, i, j, negs)
    print(f"engine kernels: topk_sqdist of an admit block (1, {S}, {DIM}) x "
          f"(1, {N}, {DIM}), k={k}: ids and distances exactly the plain "
          f"version's; kernel {topk_ms:.3f} ms, plain {topk_plain:.3f} ms, "
          f"torch.cdist+topk {topk_lib:.3f} ms, bound {topk_bms:.4f} ms "
          f"({topk_by}); "
          f"fused_edge_step of a lockstep step (y ({N + S}, 2), B={S}, "
          f"M={Mn}, per-slot lr, n_frozen={N}, every other slot idle) "
          f"bitwise the plain version, idle rows and corpus unchanged, the "
          f"split route's kernels bitwise equal; kernel {ms:.4f} ms a call "
          f"by CUDA events, plain {plain:.4f} ms, index_add_ {lib:.4f} ms, "
          f"bound {bms:.5f} ms ({by})", flush=True)
    return topk_ms


def run_projection_server(torch, res, labels, acc_tr, cfg):
    """The projection server on the fit: ``ProjectionEngine(res,
    slots=1024)`` with the fit's config, its step one CUDA graph replay
    after one eager step.  The engine's kernels at its shapes; a warm-up
    drain of N_CHECK queries (the eager step and the capture), then the
    timed drain of all N_TRANSFORM held-out queries (submitted at once)
    with the launch counts reset just before and read just after; 30
    profiled steps of a full engine; the prefill of an admit block; then
    the checks, each on a drain of the first N_CHECK queries: two engines
    from one seed, the graph against every step eager, the split route
    against the fused, poisoned and wrong-dimension queries quarantined,
    and a retried step fault, each bitwise the first drain."""
    import numpy as np

    from repro_torch import RoutingConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_projection import (ProjectionEngine,
                                                     ProjectRequest,
                                                     _prefill_block)
    from repro_torch.runtime.fault_tolerance import FaultInjector

    dev = res.y.device
    S, steps = SERVE_PROJ_SLOTS, cfg.transform_steps
    k = min(cfg.n_neighbors, N_POINTS)
    xq_np, lq_np = held_out(N_TRANSFORM, seed=1)
    xb = torch.from_numpy(xq_np[:S]).to(dev)
    topk_ms = check_engine_kernels(torch, res, cfg, xb)

    eng = ProjectionEngine(res, slots=S, cfg=cfg, seed=5)
    warm = [ProjectRequest(r, xq_np[r]) for r in range(N_CHECK)]
    for r in warm:
        eng.submit(r)
    warm_steps = eng.run()
    _served(torch, res, eng, warm, "the warm-up drain")
    check(eng.graph_replays == warm_steps - 1, f"the warm-up drain replayed "
          f"{eng.graph_replays} graphs in {warm_steps} steps")
    reqs = [ProjectRequest(r, xq_np[r]) for r in range(N_TRANSFORM)]
    replays0 = eng.graph_replays
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    n_steps = eng.run()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    replays = eng.graph_replays - replays0
    y_served = _served(torch, res, eng, reqs, "the timed drain")
    blocks = -(-N_TRANSFORM // S)
    lat = np.array([r.latency for r in reqs]) * 1e3
    p50, p99 = np.percentile(lat, [50, 99])
    lab = torch.from_numpy(labels).to(dev)
    acc = query_accuracy(torch, res.y, lab, torch.from_numpy(y_served).to(
        dev), torch.from_numpy(lq_np).to(dev))
    print(f"projection server: ProjectionEngine(slots={S}) over N={N_POINTS} "
          f"d={DIM}, K={k}, M={cfg.n_negatives}, transform_steps={steps} "
          f"({cfg.routing.layout_step} route), {N_TRANSFORM} queries "
          f"submitted at once: {wall:.4f} s, {N_TRANSFORM / wall:.1f} "
          f"queries/s, latency p50 {p50:.3f} ms, p99 {p99:.3f} ms; "
          f"{n_steps} engine steps ({replays} CUDA graph replays), {blocks} "
          f"admit blocks; host {wall / n_steps * 1e3:.4f} ms an engine step "
          f"(wall / steps); 5-NN accuracy {acc:.4f} (transform "
          f"{acc_tr:.4f}); launches {counts}", flush=True)
    check(abs(acc - acc_tr) <= 0.05, f"served accuracy {acc} is not within "
          f"0.05 of transform's {acc_tr}")
    check(torch.equal(res.y, eng.y_full[:N_POINTS]), "the corpus moved")
    check(n_steps == blocks * steps and replays == n_steps,
          f"{n_steps} engine steps ({replays} replays) for {blocks} admit "
          f"blocks of {steps} steps")
    for name, want in (("topk_sqdist", blocks), ("fused_edge_step", n_steps)):
        check(counts[name] == want > 0, f"the timed drain launched {name} "
              f"{counts[name]} times, not {want}")

    for r in range(S):
        eng.submit(ProjectRequest(r, xq_np[r]))
    prof = device_profile(torch, eng.step, n=30)
    # the ages' host mirror: a step that neither admits nor retires never
    # waits for the device
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            eng.step()
    except RuntimeError as e:
        fail(f"an engine step without admit or retire synchronised with "
             f"the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.run()
    step_dev = sum(t for t, _ in prof.events.values()) / prof.n
    print(f"  profiled engine steps (30, each a replay, all {S} slots "
          f"active, no admit or retire): {busy_line(prof)}; device events a "
          f"step {step_launches(prof)}; 5 more steps under "
          f"torch.cuda.set_sync_debug_mode('error'): no synchronisation",
          flush=True)

    def prefill():
        return _prefill_block(xb, res.x, res.y, k=k,
                              perplexity=float(min(cfg.perplexity, k)),
                              iters=cfg.perplexity_iters)
    pre_ms = time_ms(torch, prefill, reps=10)
    pprof = device_profile(torch, prefill, n=10)
    pre_dev = sum(t for t, _ in pprof.events.values()) / pprof.n
    busy = (n_steps * step_dev + blocks * pre_dev) / (wall * 1e3)
    print(f"  prefill of an admit block ({S} rows): {pre_ms:.3f} ms by CUDA "
          f"events, profiled {busy_line(pprof)}; topk_sqdist "
          f"{topk_ms:.3f} ms of it; the timed drain's busy share "
          f"from its parts: ({n_steps} steps x {step_dev:.5f} ms + {blocks} "
          f"blocks x {pre_dev:.4f} ms of device time) / {wall:.4f} s = "
          f"{busy:.3f}", flush=True)

    xc = xq_np[:N_CHECK]
    base_eng, base_reqs, base_steps = _engine_drain(res, xc, cfg=cfg)
    base = _served(torch, res, base_eng, base_reqs, "the checks' drain")
    done = ["corpus bitwise frozen, every drain"]
    again_eng, again, _ = _engine_drain(res, xc, cfg=cfg)
    check(np.array_equal(_served(torch, res, again_eng, again,
                                 "a second engine"), base),
          "two engines from one seed differ")
    done.append("two engines from one seed bitwise equal")
    eager_eng, eager, _ = _engine_drain(res, xc, cfg=cfg,
                                        cuda_graph=False)
    check(eager_eng.graph_replays == 0
          and base_eng.graph_replays == base_steps - 1,
          "the eager engine replayed a graph, or the graph engine did not")
    check(np.array_equal(_served(torch, res, eager_eng, eager,
                                 "the eager engine"), base),
          "the graph engine differs from the eager engine")
    done.append(f"graph ({base_eng.graph_replays} replays) == every step "
                "eager")
    scfg = dataclasses.replace(cfg, routing=RoutingConfig(layout_step="split"))
    ops.reset_launch_counts()
    split_eng, split, split_steps = _engine_drain(res, xc, cfg=scfg)
    sc = ops.launch_counts()
    check(sc["largevis_grads"] == split_steps == sc["scatter_add_ordered"]
          and sc["fused_edge_step"] == 0, f"the split engine launched {sc}")
    check(np.array_equal(_served(torch, res, split_eng, split,
                                 "the split engine"), base),
          "the split route differs from the fused")
    done.append("split route == fused")

    chaos = ProjectionEngine(res, slots=S, cfg=cfg, seed=7)
    healthy = [ProjectRequest(r, xc[r]) for r in range(N_CHECK)]
    bad = []
    for r in healthy:
        check(chaos.submit(r), f"healthy request {r.rid} refused")
        if r.rid % 97 == 0:
            bad.append(ProjectRequest(10_000 + r.rid,
                                      np.full(DIM, np.nan, np.float32)))
        elif r.rid % 101 == 0:
            bad.append(ProjectRequest(10_000 + r.rid,
                                      np.zeros(DIM + 3, np.float32)))
        else:
            continue
        check(not chaos.submit(bad[-1]), "a poisoned query was queued")
    chaos.run()
    check(sorted(q.rid for q in chaos.quarantined) == [q.rid for q in bad]
          and all(q.error and q.y is None for q in bad),
          "the poisoned queries were not all quarantined")
    check(np.array_equal(_served(torch, res, chaos, healthy, "the chaos "
                                 "drain"), base),
          "healthy requests beside poisoned ones differ from a clean run")
    done.append(f"{len(bad)} NaN and wrong-dimension queries quarantined, "
                "the healthy ones bitwise a clean run")
    fi = FaultInjector({"step": {0: "exception",
                                 base_steps // 2: "exception"}})
    retry_eng, retry, _ = _engine_drain(res, xc, cfg=cfg, fault=fi)
    check(retry_eng.faults_retried == 2, f"{retry_eng.faults_retried} step "
          "faults retried, not 2")
    check(np.array_equal(_served(torch, res, retry_eng, retry,
                                 "the retried drain"), base),
          "a retried step fault changed the results")
    done.append("2 step faults retried, bitwise transparent")
    print(f"  server checks ({N_CHECK} queries a drain, {base_steps} engine "
          f"steps): {'; '.join(done)}", flush=True)


def run_insert(torch, res, cfg):
    """``LargeVis.insert`` of N_INSERT held-out points; it grows the
    carrier, so it runs last."""
    from repro_torch import LargeVis
    from repro_torch.kernels import ops

    dev = res.y.device
    xi = torch.from_numpy(held_out(N_INSERT, seed=2)[0]).to(dev)
    model = LargeVis(cfg, device="cuda")
    model.result_ = res
    y_before = res.y.clone()
    K = res.knn_idx.shape[1]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_new = model.insert(xi)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    r = model.result_
    n_all = N_POINTS + N_INSERT
    check(torch.equal(r.y[:N_POINTS], y_before), "insert moved fitted rows")
    check(torch.equal(r.y[N_POINTS:], y_new)
          and bool(torch.isfinite(y_new).all()), "inserted rows not finite")
    check(tuple(r.knn_idx.shape) == (n_all, K) and r.x.shape[0] == n_all,
          f"grown graph shape {tuple(r.knn_idx.shape)}")
    rows = torch.arange(n_all, device=dev)[:, None]
    check(bool((r.knn_idx != rows).all()), "the grown graph has a self edge")
    check(bool((r.knn_dist.diff(dim=1) >= 0).all()),
          "the grown graph's distances are not ascending")
    check(r.edge_sampler.n_edges == n_all * K
          and r.neg_sampler.n_nodes == n_all
          and r.neg_sampler.threshold.shape[0] == n_all,
          "the samplers do not cover the grown graph")
    hits = 0
    for r0 in range(0, N_INSERT, 500):
        d = ops.pairwise_sqdist(xi[r0:r0 + 500], r.x)
        own = torch.arange(r0, min(r0 + 500, N_INSERT), device=dev)
        d[own - r0, N_POINTS + own] = float("inf")
        true = torch.sort(d, dim=1, stable=True).indices[:, :K]
        got = r.knn_idx[N_POINTS + own].long()
        hits += int((got[:, :, None] == true[:, None, :]).any(-1).sum())
    recall = hits / (N_INSERT * K)
    print(f"insert: Q={N_INSERT} into N={N_POINTS}, {secs:.3f} s; new rows' "
          f"recall against exact {K}-NN {recall:.4f}; launches {counts}",
          flush=True)
    check(recall >= 0.99, f"inserted rows' recall {recall} < 0.99")


def check_samplers(torch, res, cfg):
    """Two edge samplers and two negative samplers built on the card from
    the fit's graph are bitwise equal, to each other and to the fit's
    own: the in-degree sum adds in stream order and the alias tables'
    f64 sums are ordered (``sampler.ordered_cumsum``)."""
    from repro_torch.core import sampler

    N, K = res.knn_idx.shape
    for name, build, own in (
            ("edge", lambda: sampler.build_edge_sampler(res.knn_idx,
                                                        res.weights),
             res.edge_sampler),
            ("negative", lambda: sampler.build_negative_sampler(
                res.knn_idx, res.weights, power=cfg.neg_power),
             res.neg_sampler)):
        for built in (build(), build()):
            diff = int((built.threshold != own.threshold).sum()
                       + (built.alias != own.alias).sum())
            check(diff == 0, f"two {name} samplers built from one graph "
                  f"differ in {diff} entries")
    print(f"samplers: two edge samplers ({N * K} entries) and two negative "
          f"samplers ({N}) built from the fit's graph (N={N}, K={K}) "
          f"bitwise equal to each other and to the fit's", flush=True)


def run_second_fit(torch, x, res, cfg):
    """A second fit from the same seed: bitwise the first, stage by stage
    (graph, distances, weights, edge sampler, negative sampler, layout);
    the first stage that differs is named."""
    from repro_torch import largevis

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = largevis(x, cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    stages = (("graph", lambda r: r.knn_idx), ("distances",
              lambda r: r.knn_dist), ("weights", lambda r: r.weights),
              ("edge sampler", lambda r: torch.cat([
                  r.edge_sampler.threshold,
                  r.edge_sampler.alias.float()])),
              ("negative sampler", lambda r: torch.cat([
                  r.neg_sampler.threshold, r.neg_sampler.alias.float()])),
              ("layout", lambda r: r.y))
    for name, get in stages:
        a, b = get(res), get(again)
        diff = int((a != b).sum())
        check(diff == 0, f"two fits from one seed differ first in the "
              f"{name} ({diff} entries)")
    print(f"second fit: {secs:.2f} s (layout_s "
          f"{again.timings['layout_s']:.3f} s); bitwise equal to the first "
          f"at every stage: {', '.join(n for n, _ in stages)}", flush=True)


# ---------------------------------------------------------------------------
# the crash-safe, health-guarded fit
# ---------------------------------------------------------------------------

ROBUST_KILL_CHUNK = 1_200       # the layout_chunk hit that kills the fit
ROBUST_NAN_CHUNK = 1_200        # the layout_chunk hit poisoned under health


def relayout(torch, res, cfg, spn: int, **kw):
    """The layout of the fit's graph from the fit's samplers at ``spn``
    samples per node, through ``run_layout`` with the fit's layout seed;
    ``kw`` replaces cfg fields (``fault`` goes to ``run_layout``).
    Returns (LayoutResult, layout_s)."""
    from repro_torch.core.layout import run_layout

    fault = kw.pop("fault", None)
    c = dataclasses.replace(cfg, samples_per_node=spn, **kw)
    gen = torch.Generator(device=res.y.device).manual_seed(cfg.seed + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lay = run_layout(gen, res.edge_sampler, res.neg_sampler,
                     res.y.shape[0], c, device=res.y.device, fault=fault)
    torch.cuda.synchronize()
    return lay, time.perf_counter() - t0


def _only(log, cls, what: str):
    """The one warning of ``cls`` in ``log``; fails on any other
    degraded-mode or divergence warning there."""
    from repro_torch.runtime.fault_tolerance import (DegradedModeWarning,
                                                     DivergenceWarning)
    got = [w.message for w in log if issubclass(w.category, cls)]
    other = [w.message for w in log if issubclass(
        w.category, (DegradedModeWarning, DivergenceWarning))
        and not issubclass(w.category, cls)]
    check(len(got) == 1 and not other, f"{what}: {len(got)} "
          f"{cls.__name__}s and {other}")
    return got[0]


def check_capture_beside_copies(torch, res, cfg, steps: int = 240):
    """``steps`` fused steps through ``StepChunks`` (the first chunk
    eager, the 100-step and the remainder's graphs captured, then
    replayed) while another thread copies a device tensor to the host in
    a loop on a stream of its own, as the checkpoint writer does: every
    capture must succeed, and y and the generator's state must equal a
    run without the copies bitwise."""
    import threading

    from repro_torch.core import layout_engine

    dev = res.y.device
    step = functools.partial(layout_engine.sgd_edge_step,
                             **{k: v for k, v in _step_kw(res, cfg).items()
                                if k != "rho0"})
    lrs = layout_engine.lr_table(cfg.rho0, steps, dev)
    outs, copies = [], []
    for beside in (False, True):
        y = res.y.clone()
        gen = torch.Generator(device=dev).manual_seed(33)
        stop = threading.Event()
        src = res.y.clone()
        torch.cuda.synchronize()

        def copier():
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                while not stop.is_set():
                    src.cpu()
                    copies.append(1)

        th = threading.Thread(target=copier)
        if beside:
            th.start()
        try:
            layout_engine.StepChunks(step, y, cfg.steps_per_dispatch
                                     ).run_all(gen, lrs)
            torch.cuda.synchronize()
        finally:
            stop.set()
            if beside:
                th.join()
        outs.append((y, gen.get_state()))
    check(torch.equal(outs[0][0], outs[1][0])
          and torch.equal(outs[0][1], outs[1][1]),
          "steps captured beside a copying thread differ")
    check(len(copies) > 0, "the copying thread made no copy")
    print(f"capture beside copies: {steps} chunked steps (two graphs "
          f"captured) while another thread made {len(copies)} device-to-"
          f"host copies: bitwise the run without them", flush=True)


def run_robust_fit(torch, x, res, labels, acc_fit, cfg):
    """The crash-safe, health-guarded fit (``cfg.checkpoint`` in a
    temporary directory, deleted after, and ``cfg.health``):

    1. the full fit killed by an injected fault at layout chunk
       ROBUST_KILL_CHUNK, then the same call again: it must restore the
       graph, weights and samplers (their build functions patched to
       raise) and the newest layout checkpoint, and end bitwise on the
       main fit's y;
       the launch counts are read over both calls;
    2. chunked steps whose graphs are captured while another thread
       copies device memory to the host (``check_capture_beside_copies``),
       then ``layout_s`` at the cut depth from the fit's samplers, plain,
       with ``checkpoint``, with ``health`` and with both, in turns (the
       eight layouts bitwise equal);
    3. at the fit's depth, a NaN payload at one layout chunk under
       ``health``: one rollback, finite, 5-NN accuracy within 0.05 of the
       fit's;
    4. at the cut depth, the fused step patched to raise at its first
       call: one DegradedModeWarning, y bitwise the split route's;
    5. ``LargeVis.save`` of the fit and ``LargeVis.load`` on the card:
       every array bitwise.

    Returns the launch counts of the killed and resumed fit and of the
    demoted layout."""
    import tempfile

    import numpy as np

    from repro_torch import LargeVis, RoutingConfig, largevis
    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.configs.largevis_default import (CheckpointConfig,
                                                      HealthConfig)
    from repro_torch.core import largevis as lv_mod
    from repro_torch.core import metrics
    from repro_torch.kernels import ops
    from repro_torch.runtime.fault_tolerance import (DegradedModeWarning,
                                                     DivergenceWarning,
                                                     FaultInjector,
                                                     InjectedFault,
                                                     PreemptionGuard)

    H = cfg.steps_per_dispatch
    steps = res.steps
    every = CheckpointConfig("").every_chunks
    k = ROBUST_KILL_CHUNK
    check(k + 1 < steps // H, f"the kill chunk {k} is past the layout")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        # 1. killed and resumed
        rcfg = dataclasses.replace(
            cfg, checkpoint=CheckpointConfig(f"{tmp}/fit"),
            health=HealthConfig())
        marks = {}

        def mark(payload):
            torch.cuda.synchronize()
            marks["layout_start"] = time.perf_counter()
            return payload

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            largevis(x, cfg=rcfg, device="cuda", fault=FaultInjector(
                {"stage:samplers": {0: mark},
                 "layout_chunk": {k: "exception"}}))
            fail("the injected layout_chunk fault did not stop the fit")
        except InjectedFault:
            pass
        killed_s = time.perf_counter() - t0
        killed_layout_s = time.perf_counter() - marks["layout_start"]
        torch.cuda.synchronize()
        killed = ops.launch_counts()

        def boom(*a, **kw):
            raise AssertionError("a stage was recomputed on resume")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        patch = mock.patch.object
        with patch(lv_mod.knn_lib, "build_knn_graph", boom), \
                patch(lv_mod.perp_lib, "edge_weights", boom), \
                patch(lv_mod.sampler_lib, "build_edge_sampler", boom), \
                patch(lv_mod.sampler_lib, "build_negative_sampler", boom):
            again = largevis(x, cfg=rcfg, device="cuda")
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        resumed = {n: counts[n] - killed[n] for n in counts}
        resumed_at = steps - again.steps
        check(resumed_at == (k // every) * every * H,
              f"resumed at step {resumed_at}, not at the last checkpoint "
              f"before chunk {k + 1}")
        check(torch.equal(again.y, res.y), "the resumed fit's y differs "
              f"from the main fit's in {int((again.y != res.y).sum())} "
              "entries")
        check(killed["fused_edge_step"] == (k + 1) * H
              and resumed["fused_edge_step"] == again.steps
              and resumed["topk_sqdist"] == 0
              and killed["topk_sqdist"] > 0,
              f"launches: killed {killed}, resumed {resumed}")
        t, tm = again.timings, res.timings
        print(f"robust fit: checkpoint (every_chunks={every}) + health, "
              f"killed by an injected fault at layout chunk {k + 1} of "
              f"{-(-steps // H)} after {killed_s:.2f} s (layout "
              f"{killed_layout_s:.3f} s for {(k + 1) * H} steps, "
              f"{killed_layout_s / ((k + 1) * H) * 1e3:.4f} ms a step); "
              f"the same call resumed at step {resumed_at} in "
              f"{resumed_s:.2f} s: loads knn_s {t['knn_s']:.3f} s, "
              f"weights_s {t['weights_s']:.3f} s, sampler_s "
              f"{t['sampler_s']:.3f} s (main fit: computed {tm['knn_s']:.3f}"
              f", {tm['weights_s']:.3f}, {tm['sampler_s']:.3f} s); layout "
              f"{t['layout_s']:.3f} s for {again.steps} steps, "
              f"{t['layout_s'] / again.steps * 1e3:.4f} ms a step (main "
              f"fit {tm['layout_s'] / steps * 1e3:.4f}); y bitwise the main "
              f"fit's; launches killed "
              f"{killed}, resumed {resumed}", flush=True)

        # 2. layout_s plain, with checkpoint, with checkpoint + health;
        # first, the writer's copies must not break a capture
        check_capture_beside_copies(torch, res, cfg)
        spn = min(SPLIT_SAMPLES_PER_NODE, cfg.samples_per_node)
        print(f"cut: the robustness layouts' samples_per_node "
              f"{cfg.samples_per_node} -> {spn} (from the fit's samplers)",
              flush=True)
        # health alone splits checkpoint+health's cost between the
        # per-chunk sync and probe and the synchronous saves
        order = ("plain", "checkpoint", "health", "checkpoint+health")
        times = {name: [] for name in order}
        ys = []
        for i, name in enumerate(order + order[::-1]):
            kw = {"health": HealthConfig()} if "health" in name else {}
            guard = None
            if "checkpoint" in name:
                # armed as largevis() arms it while checkpointing
                kw["checkpoint"] = CheckpointConfig(f"{tmp}/turn{i}")
                guard = PreemptionGuard(
                    signals=(signal.SIGTERM, signal.SIGINT),
                    exit_after_save=True).activate()
            try:
                lay, secs = relayout(torch, res, cfg, spn, **kw)
            finally:
                if guard is not None:
                    guard.restore_handlers()
            times[name].append(secs)
            ys.append(lay.y)
            if "checkpoint" in name:
                # the last save (off-thread when health is off) holds
                # the final y and the generator's state
                tree, step = ck.restore(f"{tmp}/turn{i}/layout")
                check(step == lay.steps and np.array_equal(
                    tree["y"], lay.y.cpu().numpy())
                    and tree["rng"].dtype == np.uint8,
                    f"{name}: the last layout checkpoint (step {step}) "
                    "is not the final layout")
        check(all(torch.equal(y, ys[0]) for y in ys[1:]),
              "the plain, checkpointed and health-guarded layouts differ")
        plain_s = min(times["plain"])
        print(f"robust layout_s ({lay.steps} steps, in turns "
              f"{', '.join(order + order[::-1])}; every_chunks={every}, "
              f"check_every_chunks=1): " + "; ".join(
                  f"{n} {', '.join(f'{v:.3f}' for v in vs)} s "
                  f"(min {min(vs) / plain_s:.4f}x plain)"
                  for n, vs in times.items())
              + f"; the {len(ys)} layouts bitwise equal", flush=True)

        # 3. a NaN payload, one rollback (at the fit's depth: the
        # accuracy is held to the fit's)
        with warnings.catch_warnings(record=True) as log:
            warnings.simplefilter("always")
            lay, secs = relayout(
                torch, res, cfg, cfg.samples_per_node, health=HealthConfig(),
                fault=FaultInjector({"layout_chunk": {ROBUST_NAN_CHUNK:
                                                      "nan"}}))
        w = _only(log, DivergenceWarning, "the NaN fault")
        acc = metrics.knn_classifier_accuracy(lay.y, labels)
        print(f"rollback: NaN payload after layout chunk "
              f"{ROBUST_NAN_CHUNK + 1} of "
              f"{-(-lay.steps // H)}: {w}; rollbacks {lay.rollbacks}, "
              f"rho0_scale {lay.rho0_scale}, {lay.dispatches} dispatches, "
              f"layout_s {secs:.3f} s ({lay.steps} steps, the fit's "
              f"depth), finite, knn_classifier_accuracy {acc:.4f} (main "
              f"fit {acc_fit:.4f})", flush=True)
        check(lay.rollbacks == 1 and bool(torch.isfinite(lay.y).all()),
              f"rollbacks {lay.rollbacks}, finite "
              f"{bool(torch.isfinite(lay.y).all())}")
        check(abs(acc - acc_fit) <= 0.05,
              f"rolled-back accuracy {acc} vs the fit's {acc_fit}")

        # 4. the fused step fails at its first call: demoted to split
        want, _ = relayout(torch, res, cfg, spn,
                           routing=RoutingConfig(layout_step="split"))
        real, calls = ops.largevis_edge_step, {"n": 0}

        def fails_first(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("fused edge step unavailable (a failure "
                                   "injected by chip_smoke.py)")
            return real(*a, **kw)

        ops.reset_launch_counts()
        with warnings.catch_warnings(record=True) as log, \
                mock.patch.object(ops, "largevis_edge_step", fails_first):
            warnings.simplefilter("always")
            lay, secs = relayout(torch, res, cfg, spn)
        torch.cuda.synchronize()
        demoted = ops.launch_counts()
        w = _only(log, DegradedModeWarning, "the demotion")
        print(f"demotion: {w}; {lay.steps} steps, layout_s {secs:.3f} s, y "
              f"bitwise the split route's: "
              f"{torch.equal(lay.y, want.y)}; launches {demoted}",
              flush=True)
        check(torch.equal(lay.y, want.y),
              "the demoted layout differs from the split route's")
        check(calls["n"] == 1 and demoted["fused_edge_step"] == 0
              and demoted["largevis_grads"] == lay.steps
              and demoted["scatter_add_ordered"] == lay.steps,
              f"the demoted run's launches {demoted}")

        # 5. save and load
        model = LargeVis(cfg, device="cuda")
        model.result_ = res
        path = Path(tmp) / "model"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - t0
        n_bytes = sum(f.stat().st_size for f in path.rglob("*")
                      if f.is_file())
        t0 = time.perf_counter()
        back = LargeVis.load(path, device="cuda").result_
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        arrays = {"y": lambda r: r.y, "x": lambda r: r.x,
                  "knn_idx": lambda r: r.knn_idx,
                  "knn_dist": lambda r: r.knn_dist,
                  "weights": lambda r: r.weights}
        for s_name in ("edge_sampler", "neg_sampler"):
            for f in ("threshold", "alias") + (
                    ("src", "dst") if s_name == "edge_sampler" else ()):
                arrays[f"{s_name}.{f}"] = (
                    lambda r, s=s_name, f=f: getattr(getattr(r, s), f))
        for name, get in arrays.items():
            a, b = get(res), get(back)
            check(a.dtype == b.dtype and a.device == b.device
                  and torch.equal(a, b), f"save/load changed {name}")
        check(back.cfg == cfg, "save/load changed the config")
        print(f"save/load: LargeVis.save {save_s:.3f} s, {n_bytes} bytes; "
              f"LargeVis.load(device='cuda') {load_s:.3f} s; "
              f"{', '.join(arrays)} bitwise", flush=True)
    return {n: killed[n] + resumed[n] for n in counts}, demoted


def check_chunked(torch, res, cfg, steps: int = 240, H: int = 100):
    """From the fit's layout and samplers, one generator seeded alike for
    each: ``steps`` SGD steps through ``StepChunks`` (H a dispatch: the
    first chunk eager, then a replay of the H-step graph and one of the
    remainder's) against the per-step loop, on the fused and the split
    route, and the autodiff route (``exp_quadratic``): y and the
    generator's state after bitwise equal, and the launches equal.  Then
    ``transform`` of 2,000 held-out points by the loop
    (``steps_per_dispatch=1``) and by its kept graph, called twice (eager,
    then a replay), bitwise equal.  Then 10 replays of the fused H-step
    graph under the profiler."""
    from repro_torch import LargeVis
    from repro_torch.core import layout_engine
    from repro_torch.kernels import ops

    dev = res.y.device
    kw = dict(edge_sampler=res.edge_sampler, neg_sampler=res.neg_sampler,
              n_negatives=cfg.n_negatives, a=cfg.prob_a, gamma=cfg.gamma,
              clip=cfg.grad_clip, batch=cfg.batch_size)
    lrs = layout_engine.lr_table(cfg.rho0, steps, dev)
    done = []
    for route, prob_fn in (("fused", "inv_quadratic"),
                           ("split", "inv_quadratic"),
                           ("split", "exp_quadratic")):
        step = functools.partial(layout_engine.sgd_edge_step,
                                 layout_step=route, prob_fn=prob_fn, **kw)
        outs = []
        for chunked in (False, True):
            y = res.y.clone()
            gen = torch.Generator(device=dev).manual_seed(31)
            ops.reset_launch_counts()
            if chunked:
                unit = layout_engine.StepChunks(step, y, H)
                n_disp = unit.run_all(gen, lrs)
            else:
                for t in range(steps):
                    step(y, gen, lr=lrs[t])
            torch.cuda.synchronize()
            outs.append((y, gen.get_state(), ops.launch_counts()))
        (yl, gl, cl), (yc, gc, cc) = outs
        what = f"{route} {prob_fn}"
        check(torch.equal(yl, yc), f"chunked {what} steps differ from the "
              f"loop (max |diff| {float((yl - yc).abs().max())})")
        check(torch.equal(gl, gc), f"chunked {what} steps leave the "
              "generator elsewhere than the loop")
        check(cl == cc, f"chunked {what} launches {cc}, the loop {cl}")
        check(not torch.equal(yc, res.y), f"{what} steps did not move y")
        done.append(f"{what} ({n_disp} dispatches; launches "
                    f"{ {k: v for k, v in cc.items() if v} })")

    xq = torch.from_numpy(held_out(2000, seed=3)[0]).to(dev)
    ys, counts = [], []
    for spd in (1, cfg.steps_per_dispatch, cfg.steps_per_dispatch):
        model = LargeVis(dataclasses.replace(cfg, steps_per_dispatch=spd),
                         device="cuda")
        model.result_ = res
        gen = torch.Generator(device=dev).manual_seed(32)
        ops.reset_launch_counts()
        ys.append(model.transform(xq, generator=gen))
        torch.cuda.synchronize()
        counts.append(ops.launch_counts()["fused_edge_step"])
    check(all(torch.equal(y, ys[0]) for y in ys[1:]),
          "transform through its graph differs from its loop")
    check(counts == [cfg.transform_steps] * 3,
          f"transform launched fused_edge_step {counts} times")

    prof = profile_replays(torch, res, cfg, "fused", H)
    print(f"chunked: {steps} steps (H={H}: the first chunk eager, then the "
          f"{H}-step and the {steps % H or H}-step graphs replayed) from the "
          f"fit's layout bitwise the per-step loop, generator state and "
          f"launches equal: {'; '.join(done)}; transform of 2000 held-out "
          f"points by the loop and through its kept graph (eager, then a "
          f"replay) bitwise equal, {cfg.transform_steps} fused launches "
          f"each", flush=True)
    print(f"  profiled {H}-step replays (10): {busy_line(prof)}; "
          f"{replay_line(prof, H)}", flush=True)
    return prof


def profile_replays(torch, res, cfg, route: str, H: int = 100,
                    n: int = 10) -> Profile:
    """``n`` replays of the H-step graph of one route from the fitted
    layout, under the profiler (after the eager first chunk and three
    warm-up replays)."""
    from repro_torch.core import layout_engine

    dev = res.y.device
    step = functools.partial(layout_engine.sgd_edge_step, layout_step=route,
                             **_step_kw(res, cfg))
    y = res.y.clone()
    gen = torch.Generator(device=dev).manual_seed(33)
    unit = layout_engine.StepChunks(step, y, H)
    many = layout_engine.lr_table(cfg.rho0, (n + 4) * H, dev)
    chunk = iter(range(n + 4))

    def replay():
        c = next(chunk)
        unit.run(gen, many[c * H:(c + 1) * H])
    return device_profile(torch, replay, n=n)


def replay_line(prof: Profile, H: int) -> str:
    """Device ms and device events a step of profiled graph replays."""
    dev_ms = sum(t for t, _ in prof.events.values()) / (prof.n * H)
    events = sum(c for _, c in prof.events.values()) / (prof.n * H)
    kern, complete = kernels_seen(prof)
    return (f"{dev_ms:.5f} ms of device time a step, {events:.2f} device "
            f"events a step ({'every' if complete else 'not every'} "
            f"hand-written launch seen: {kern})")


def run_fixture(torch, layout_step: str = "auto"):
    """The 2000-point quality fixture of the JAX package's engine test."""
    from repro_torch import LargeVisConfig, RoutingConfig, largevis
    from repro_torch.core import metrics
    from repro_torch.data.synthetic import gaussian_mixture

    x, labels = gaussian_mixture(0, 2000, 32, 8)
    cfg = LargeVisConfig(n_neighbors=15, n_trees=4, n_explore_iters=2,
                         window=32, perplexity=10.0, samples_per_node=2000,
                         batch_size=4096,
                         routing=RoutingConfig(layout_step=layout_step))
    res = largevis(x, cfg=cfg, device="cuda")
    acc = metrics.knn_classifier_accuracy(res.y, labels)
    print(f"fixture ({layout_step}): N=2000 d=32, knn_classifier_accuracy "
          f"{acc:.4f} (bar 0.95), {sum(res.timings.values()):.2f} s",
          flush=True)
    check(acc >= 0.95, f"fixture accuracy {acc} < 0.95")
    check(bool(torch.isfinite(res.y).all()), "fixture layout not finite")
    return acc, res.y


# ---------------------------------------------------------------------------
# the LM serving path
# ---------------------------------------------------------------------------

def flash_pairs(S: int, W: int) -> int:
    """(q, k) pairs under the top-left causal mask of S rows and S keys,
    with a window W > 0: sum over rows i of min(i + 1, W)."""
    if W <= 0 or W >= S:
        return S * (S + 1) // 2
    return W * (W + 1) // 2 + (S - W) * W


def flash_bound(B, S, H, hd, W):
    """The least time of one causal call: 4 * hd operations a pair under
    the mask at the bf16 tensor-core peak, against q, k, v read and out
    written once at the memory rate."""
    n_ops = 4 * B * H * flash_pairs(S, W) * hd
    n_bytes = 4 * B * S * H * hd * 2
    return bound_ms(n_bytes, n_ops, PEAK_BF16_PER_S)


def check_flash(torch):
    """``flash_attention`` against its plain version: at the serve paths'
    shapes in bf16 and f32 (gemma3-12b's global and local layers at hd
    256, mixtral-8x7b's windowed layers and a global one at hd 128,
    qwen1.5-0.5b's at hd 64), and at ragged shapes (S and T off the
    kernels' tiles, S < T and S > T, non-causal, head dims 16 to 256; the
    window's edges: S < W, S = W, S = W + 1, W = 1, a window before a
    row block's first tile); each main shape timed in bf16, the path's
    dtype, beside the plain version and SDPA (``is_causal``, or the
    window's boolean mask, which SDPA takes as a general mask), by CUDA
    events and by the profiler's device time of the kernel alone.
    Returns the record of gemma3's global shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    B, S, H, hd = FLASH_SHAPE
    shapes = [(FLASH_SHAPE, S, True, 0), ((2, 1000, 3, 64), 1037, True, 0),
              ((1, 300, 2, 64), 77, True, 0), ((1, 130, 4, 64), 130, False, 0),
              ((1, S - 1, H, hd), S - 1, True, 0),
              ((1, S + 1, H, hd), S + 1, True, 0),
              ((1, S, 4, 32), S, True, 0), ((2, 1000, 3, 32), 1037, True, 0),
              ((1, 130, 4, 32), 130, False, 0), ((1, S, 4, 16), S, True, 0),
              ((1, 300, 2, 16), 77, True, 0), ((1, 130, 4, 16), 130, False, 0)]
    shapes += [(shape, shape[1], True, w) for shape, w in FLASH_MAIN
               if (shape, w) != (FLASH_SHAPE, 0)]
    for d, w in ((256, GEMMA_WINDOW), (128, MIXTRAL_WINDOW)):
        shapes += [((1, w - 24, 4, d), w - 24, True, w),        # S < W
                   ((1, w, 4, d), w, True, w),                  # S = W
                   ((1, w + 1, 4, d), w + 1, True, w),          # S = W + 1
                   ((2, 1000, 3, d), 1037, True, 0),            # S < T
                   ((1, 300, 2, d), 77, True, 0),               # S > T
                   ((1, 130, 4, d), 130, False, 0),
                   ((1, 1000, 2, d), 1037, True, 100),          # S < T, W
                   ((1, 257, 2, d), 257, True, 1),              # W = 1
                   ((1, 300, 2, d), 300, True, 64)]
    max_err, errs, main = 0.0, [], {}
    for (b, s, h, d), t, causal, w in shapes:
        for name in ("bfloat16", "float32"):
            dt = getattr(torch, name)
            q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dt)
            k, v = (torch.randn((b, t, h, d), generator=gen, device=dev)
                    .to(dt) for _ in range(2))
            got = fa.flash_attention(q, k, v, causal=causal, window=w)
            want = ref.flash_attention_ref(q, k, v, causal=causal, window=w)
            diff = (got.float() - want.float()).abs()
            limit = torch.full_like(diff, FLASH_F32_TOL)
            if dt == torch.bfloat16:
                limit += FLASH_BF16_ULPS * bf16_ulp(torch, want)
            err = float(diff.max())
            worst = float((diff / limit).max())
            what = (f"({b},{s},{h},{d})xT={t}{'' if causal else ' nc'}"
                    f"{f' W={w}' if w else ''} {name}")
            check(got.dtype == dt and bool(torch.isfinite(got).all())
                  and worst <= 1.0,
                  f"flash_attention: {what}: max |err| {err}, {worst:.3g} x "
                  "its limit")
            max_err = max(max_err, err)
            errs.append(f"{what} {err:.3g} ({worst:.3g} x limit)")
            if name == "bfloat16" and causal and t == s and \
                    ((b, s, h, d), w) in FLASH_MAIN:
                main[(b, s, h, d), w] = (q, k, v)
            del q, k, v, got, want, diff, limit
    print(f"flash_attention: max |err| against the plain version (limit "
          f"f32 {FLASH_F32_TOL}; bf16 {FLASH_BF16_ULPS} bf16 ulps of "
          f"|plain| + {FLASH_F32_TOL}, per element), {len(errs)} cases: "
          f"{'; '.join(errs)}", flush=True)
    torch.cuda.empty_cache()
    recs = {}
    for shape, w in FLASH_MAIN:
        q, k, v = main[shape, w]
        b, s, h, d = shape
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, window=w))
        n_prof = 20
        kern_ms, seen, _ = device_profile(
            torch, lambda: fa.flash_attention(q, k, v, window=w),
            n=n_prof).kernel("flash_attention")
        qf, kf, vf = (x.float() for x in (q, k, v))
        ms32 = time_ms(torch, lambda: fa.flash_attention(qf, kf, vf,
                                                         window=w), reps=3)
        del qf, kf, vf
        plain = time_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, window=w), reps=2, warmup=1)
        torch.cuda.empty_cache()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if w:
            i = torch.arange(s, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            lib_what = "SDPA with the window's boolean mask"
            del mask
        else:
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
            lib_what = "SDPA is_causal"
        bms, by = flash_bound(b, s, h, d, w)
        print(f"flash_attention {shape}{f' W={w}' if w else ''} causal "
              f"({FLASH_MAIN[shape, w]}): kernel bf16 {ms:.4f} ms by CUDA "
              f"events, {kern_ms:.4f} ms of device time a launch by the "
              f"profiler ({seen} of {n_prof} launches seen); f32 kernel "
              f"{ms32:.4f} ms; plain {plain:.4f} ms; {lib_what} {lib:.4f} "
              f"ms; bound {bms:.5f} ms ({by}, bf16 tensor-core peak; "
              f"{flash_pairs(s, w) * b * h} pairs under the mask)",
              flush=True)
        recs[shape, w] = dict(ms=ms, plain_ms=plain, bound_ms=bms,
                              bound_by=by, library_ms=lib)
    main.clear()
    torch.cuda.empty_cache()
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:72",
                max_abs_err=max_err, **recs[FLASH_RECORD])


def check_prefill_plain(torch, prefill, cfg, prompts):
    """The model on the long prompts: last logits of ``prefill(tokens)``
    through the kernel against the same prefill through the plain version
    (``ops.flash_attention`` swapped for it), on the card."""

    from repro_torch.kernels import ops, ref

    worst, agree = 0.0, 0
    for p in prompts:
        toks = torch.tensor([p], dtype=torch.long, device="cuda")
        got, _ = prefill(toks)
        with mock.patch.object(ops, "flash_attention",
                               ref.flash_attention_ref):
            want, _ = prefill(toks)
        rel = float((got - want).abs().max() / want.abs().max())
        check(bool(torch.isfinite(got).all()) and rel <= PREFILL_REL_TOL,
              f"{cfg.name}: prefill logits through the kernel vs the plain "
              f"version: rel {rel} > {PREFILL_REL_TOL}")
        worst = max(worst, rel)
        agree += int(torch.equal(got.argmax(-1), want.argmax(-1)))
    print(f"prefill, {cfg.name} ({cfg.n_layers} layers, {len(prompts)} "
          f"prompts of {len(prompts[0])} tokens, "
          f"{str(cfg.dtype).removeprefix('torch.')}): last logits through "
          f"the kernel vs through the plain version max |diff| / max "
          f"|logit| {worst:.3g} (tol {PREFILL_REL_TOL}); greedy token equal "
          f"on {agree} of {len(prompts)} (printed, not required in bf16)",
          flush=True)


def time_prefill(torch, params, cfg, n_tokens: int = TIMED_PROMPT):
    """One prefill of an ``n_tokens`` prompt, batch 1, after one warm-up:
    its wall time (host clock around a synchronize), its device time and
    busy share under the profiler, and its flash launches.  Returns the
    flash launches."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import lm

    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, n_tokens)),
                        dtype=torch.long, device="cuda")
    logits, _ = lm.lm_prefill(params, cfg, toks)         # warm-up
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = lm.lm_prefill(params, cfg, toks)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()["flash_attention"]
    check(tuple(logits.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"the {n_tokens}-token prefill's logits are not finite")
    check(launches == cfg.n_layers,
          f"the {n_tokens}-token prefill launched flash_attention "
          f"{launches} times, expected {cfg.n_layers}")
    prof = device_profile(torch, lambda: lm.lm_prefill(params, cfg, toks),
                          n=1)
    flash_ms, seen, _ = prof.kernel("flash_attention")
    print(f"timed prefill: {n_tokens} tokens, batch 1: wall {wall:.2f} ms; "
          f"profiled {busy_line(prof)}; flash {launches} launches, "
          f"{flash_ms * seen:.4f} ms of device time ({flash_ms:.4f} ms a "
          f"launch, {seen} seen)", flush=True)
    return launches


def attention_layers(cfg) -> int:
    """The layers whose prefill runs self-attention: a decoder's attention
    blocks, or an encoder-decoder's decoder layers (its encoder and the
    cross-attention run ``mha_full``)."""
    from repro_torch.models import lm

    if cfg.is_encoder_decoder:
        return cfg.n_layers
    return cfg.n_periods * sum(k in lm.ATTN_KINDS for k in cfg.block_pattern)


def run_serve(torch, cfg, lengths: list, max_len: int,
              max_new: int = SERVE_MAX_NEW, params=None, profiled=None,
              prof_n: int = 3):
    """``ServeEngine`` at full width: ``SERVE_SLOTS`` slots, one request a
    prompt length (those of 2048 tokens or more prefill through the flash
    kernel, the others through ``mha_full``), ``max_new`` new tokens
    each, on ``params`` (cast in place) or random weights from a seed;
    launch counts reset just before and read just after, which must show
    ``flash_attention`` once an attention layer of each long prompt.  The
    prefills of the prompt lengths ``profiled`` (the longest and the
    shortest by default) and a decode step are then profiled, ``prof_n``
    calls each.  Returns the engine and the flash launches."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, ServeEngine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, slots=SERVE_SLOTS, max_len=max_len, seed=0,
                      params=params)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in eng.params.parameters())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    long = [p for p in prompts if len(p) >= 2048]

    def prefill(toks):
        return eng.model["prefill"](eng.params, toks, *eng.frames)

    if long:
        check_prefill_plain(torch, prefill, cfg, long)   # also warms up

    prefill_ms, decode_ms = [], []

    def timed(fn, out):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*args)
            torch.cuda.synchronize()
            out.append((args[1].shape, (time.perf_counter() - t) * 1e3))
            return res
        return call

    eng._prefill = timed(eng._prefill, prefill_ms)
    eng._decode = timed(eng._decode, decode_ms)
    reqs = [Request(i, p, max_new=max_new) for i, p in enumerate(prompts)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_tok = sum(len(r.out) for r in reqs)
    dec = [ms for _, ms in decode_ms]
    by_len = {}
    for shape, ms in prefill_ms:
        by_len.setdefault(shape[1], []).append(ms)
    pre = ", ".join(f"{n}: {sum(v) / len(v):.2f}" for n, v in
                    sorted(by_len.items()))
    print(f"serve: {cfg.name} ({n_params / 1e6:.1f}M parameters, matrices "
          f"{str(cfg.dtype).removeprefix('torch.')}, engine built in "
          f"{build_s:.2f} s), {SERVE_SLOTS} slots x max_len {max_len}, "
          f"{len(reqs)} requests (prompts of {lengths} tokens), max_new "
          f"{max_new}: {steps} engine steps, {n_tok} tokens in {wall:.3f} s "
          f"({n_tok / wall:.1f} tokens/s end to end); prefill ms by prompt "
          f"length {{{pre}}}; decode {sum(dec) / len(dec):.3f} ms per "
          f"engine step over {len(dec)} steps (min {min(dec):.3f}, max "
          f"{max(dec):.3f}); launches {counts}", flush=True)
    for n in profiled or (max(lengths), min(lengths)):
        toks = torch.tensor([prompts[lengths.index(n)]], dtype=torch.long,
                            device=eng.device)
        prof = device_profile(torch, lambda: prefill(toks), n=prof_n)
        events = sum(c for _, c in prof.events.values()) / prof.n
        print(f"  profiled {n}-token prefill ({prof_n} calls, "
              f"{events / n:.1f} device events a token): "
              f"{busy_line(prof)}", flush=True)
    last = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device=eng.device)
    pos = torch.full((SERVE_SLOTS,), max_len - 2, device=eng.device)
    prof = device_profile(torch, lambda: eng.model["decode"](
        eng.params, last, eng.cache, pos), n=10)
    print(f"  profiled decode step ({SERVE_SLOTS} slots at position "
          f"{max_len - 2}): {busy_line(prof)}", flush=True)
    want = attention_layers(cfg) * len(long)
    check(counts["flash_attention"] == want,
          f"flash_attention launched {counts['flash_attention']} times on "
          f"the {cfg.name} serve path, expected {attention_layers(cfg)} "
          f"attention layers x {len(long)} long prompts = {want}")
    check(all(r.done and len(r.out) == max_new for r in reqs),
          "a request did not finish with max_new tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
          "a token outside the vocabulary")
    return eng, counts["flash_attention"]


def decode_vs_prefill(torch, params, cfg, S: int, *, kv_quant=False,
                      seed: int = 6, ref_impl: str = "chunked"):
    """prefill(S) + decode(token S) against prefill(S + 1), B = 2, as the
    JAX package's test_models checks; prefill(S) through the flash kernel
    (``attn_impl="chunked"``), prefill(S + 1) through ``ref_impl`` (the
    chunked contract of both packages takes S + 1 only below 1024 or at a
    multiple of it, so past gemma3's window of 1024 the reference is
    ``mha_full``); the prefill cache spliced into ``init_cache``'s (local
    layers past their window as rings).  Returns (max |diff| / max
    |logit|, the cache after the decode)."""
    from repro_torch.core.largevis import seeded_generator
    from repro_torch.models import lm
    from repro_torch.models.factory import init_cache

    dev = torch.device("cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, S + 1),
                         generator=seeded_generator(dev, seed), device=dev)
    want, _ = lm.lm_prefill(params, cfg, toks, attn_impl=ref_impl)
    _, one = lm.lm_prefill(params, cfg, toks[:, :S], attn_impl="chunked",
                           kv_quant=kv_quant)
    cache = init_cache(cfg, 2, S + 1, dev, kv_quant=kv_quant)
    for p, entry in one.items():
        for name, t in entry.items():
            cache[p][name][:, :, :t.shape[2]] = t
    del one
    got, cache = lm.lm_decode(params, cfg, toks[:, S:], cache,
                              torch.full((2,), S, device=dev))
    return float((got - want).abs().max() / want.abs().max()), cache


def check_decode_matches_prefill(torch, arch: str = LM_ARCH,
                                 n_layers: int = 2, S: int = 1000,
                                 ref_impl: str = "chunked"):
    """At full width in f32, at ``n_layers`` (a printed cut below the
    architecture's depth): :func:`decode_vs_prefill` within the JAX
    package's bound."""
    from repro_torch.configs import get_config
    from repro_torch.core.largevis import seeded_generator
    from repro_torch.models import lm

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers, dtype=torch.float32)
    params = lm.init_lm(seeded_generator(torch.device("cuda"), 5), cfg)
    rel, _ = decode_vs_prefill(torch, params, cfg, S, ref_impl=ref_impl)
    if n_layers < full.n_layers:
        print(f"cut: {arch} decode vs prefill at {n_layers} of "
              f"{full.n_layers} layers", flush=True)
    paths = (f" through the kernel + decode(token {S}) vs prefill({S + 1})"
             f" through {ref_impl}" if attention_layers(cfg) else
             f" + decode(token {S}) vs prefill({S + 1}) (no attention)")
    print(f"decode vs prefill: {arch} at full width, {n_layers} layers "
          f"(pattern {cfg.block_pattern}), f32, B=2: prefill({S}){paths} "
          f"max |diff| / max |logit| {rel:.3g} (tol {DECODE_REL_TOL})",
          flush=True)
    check(rel <= DECODE_REL_TOL, f"{arch} decode vs prefill rel {rel}")


def free_card(torch) -> None:
    """Return what earlier phases left to the allocator's cache."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def run_gemma3(torch):
    """gemma3-12b at full width and depth through ``ServeEngine``, random
    bf16 weights from a seed: 2 prompts of ``GEMMA_LONG`` tokens (flash at
    hd 256: windowed on the 40 local layers, causal on the 8 global ones)
    and 2 under its window, ``max_len`` long enough to decode past the
    prompts, which wraps the local layers' 1024-slot rings.  Then decode
    vs prefill at full width in f32, one period of 6 layers (5 local, 1
    global; a printed cut), S = 2048 through the kernel: past the window
    and through the ring.  Returns the flash launches of the serve run."""
    t0 = time.perf_counter()
    free_card(torch)
    base = torch.cuda.memory_allocated() / 2**30
    from repro_torch.configs import get_config

    eng, launches = run_serve(torch, get_config(GEMMA_ARCH), GEMMA_LENGTHS,
                              GEMMA_LONG + 32)
    peak = torch.cuda.max_memory_allocated() / 2**30
    cfg = eng.cfg
    rings = {p: tuple(e["k"].shape) for p, e in eng.cache.items()}
    print(f"gemma3 serve: cache leaves (n_periods, slots, T, KVH, hd) "
          f"{rings}; device memory {base:.2f} GiB held before the engine, "
          f"peak {peak:.2f} GiB (max_memory_allocated)", flush=True)
    check(launches == cfg.n_layers * 2, f"gemma3: {launches} flash "
          f"launches, expected {cfg.n_layers} x 2")
    del eng
    free_card(torch)
    check_decode_matches_prefill(torch, GEMMA_ARCH, n_layers=6, S=2048,
                                 ref_impl="full")
    free_card(torch)
    print(f"gemma3 phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def run_mixtral(torch):
    """mixtral-8x7b at full width, 2 of its 32 layers (a printed cut: 47B
    parameters do not fit one card), random weights from a seed.  In f32
    with total routing (``topk_experts = n_experts``, as the JAX
    package's test): decode vs prefill (S = 1000, through the kernel at hd
    128 with G = 4), and a decode on an int8 cache (``kv_quant=True``)
    within the JAX package's int8 bound, the cache still int8 after it.
    Then the weights cast to bf16 and one 8192-token prefill with top-2
    routing (the kernel windowed at W = 4096, then MoE over T = 8192 at
    capacity 2560) against the same prefill through the plain version,
    with its flash launches counted.  Returns them."""
    from repro_torch.configs import get_config
    from repro_torch.core.largevis import seeded_generator
    from repro_torch.kernels import ops
    from repro_torch.models import lm, moe
    from repro_torch.models.factory import cast_for_inference

    t0 = time.perf_counter()
    free_card(torch)
    full = get_config(MIXTRAL_ARCH)
    cfg = dataclasses.replace(full, n_layers=MIXTRAL_LAYERS)
    print(f"cut: {MIXTRAL_ARCH} at {MIXTRAL_LAYERS} of {full.n_layers} "
          f"layers (full width)", flush=True)
    dev = torch.device("cuda")
    params = lm.init_lm(seeded_generator(dev, 7), cfg)
    n_params = sum(p.numel() for p in params.parameters())
    total = dataclasses.replace(cfg, dtype=torch.float32,
                                topk_experts=cfg.n_experts)
    S = 1000
    rel, _ = decode_vs_prefill(torch, params, total, S)
    check(rel <= DECODE_REL_TOL, f"mixtral decode vs prefill rel {rel}")
    relq, cache = decode_vs_prefill(torch, params, total, S, kv_quant=True)
    kinds = {str(t.dtype) for e in cache.values() for t in e.values()}
    check(relq < KV_QUANT_REL_TOL and all(
        e["k"].dtype == torch.int8 and e["v"].dtype == torch.int8
        for e in cache.values()),
        f"mixtral int8-cache decode: rel {relq}, leaves {kinds}")
    del cache
    print(f"decode vs prefill: {MIXTRAL_ARCH} at full width, "
          f"{MIXTRAL_LAYERS} layers ({n_params / 1e9:.2f}B parameters), "
          f"f32, total routing, B=2: prefill({S}) + decode(token {S}) vs "
          f"prefill({S + 1}) max |diff| / max |logit| {rel:.3g} (tol "
          f"{DECODE_REL_TOL}); on an int8 cache (kv_quant) {relq:.3g} (tol "
          f"{KV_QUANT_REL_TOL}), leaves after the decode {sorted(kinds)}",
          flush=True)
    cast_for_inference(params, cfg)
    free_card(torch)
    toks = torch.randint(0, cfg.vocab_size, (1, MIXTRAL_PROMPT),
                         generator=seeded_generator(dev, 8), device=dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, _ = lm.lm_prefill(params, cfg, toks)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t1) * 1e3
    launches = ops.launch_counts()["flash_attention"]
    check(launches == cfg.n_layers, f"mixtral prefill: {launches} flash "
          f"launches, expected {cfg.n_layers}")
    check_prefill_plain(torch, lambda t: lm.lm_prefill(params, cfg, t), cfg,
                        [toks[0].tolist()])
    prof = device_profile(torch, lambda: lm.lm_prefill(params, cfg, toks),
                          n=2)
    C = moe.capacity(MIXTRAL_PROMPT, cfg.n_experts, cfg.topk_experts)
    print(f"mixtral prefill: {MIXTRAL_PROMPT} tokens, bf16, top-"
          f"{cfg.topk_experts} of {cfg.n_experts} experts at capacity {C}: "
          f"wall {wall:.2f} ms (the first call); profiled {busy_line(prof)}; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)
    del params
    free_card(torch)
    return launches


def serve_phase_end(torch, eng, what: str, t0: float) -> None:
    """The serve run's cache leaves and peak memory, then the card freed."""
    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    print(f"{what} serve: cache leaves {shapes(eng.cache)}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(max_memory_allocated, since the phase freed the card)",
          flush=True)
    del eng
    free_card(torch)
    print(f"{what} phase: {time.perf_counter() - t0:.1f} s", flush=True)


def run_jamba(torch):
    """jamba-v0.1-52b at full width and one period of its 1:7 attention:
    mamba pattern, 8 of its 32 layers (a printed cut: its 51.5B parameters
    do not fit one card in bf16), random weights from a seed.  The f32
    master made once: decode vs prefill on it with total routing (S = 200,
    inside one mamba chunk; both prefills through the kernel, f32 at hd
    128 with 32 query heads over 8 kv heads), then cast in place and
    served by ``ServeEngine`` (prompts of 4096, 256, 4096 and 200 tokens:
    the two long ones take ``flash_attention`` at (1, 4096, 32, 128) once
    each, the mamba layers their chunked scan).  Returns the flash
    launches of the serve run."""
    from repro_torch.configs import get_config
    from repro_torch.core.largevis import seeded_generator
    from repro_torch.models import lm
    from repro_torch.models.factory import cast_for_inference

    t0 = time.perf_counter()
    free_card(torch)
    full = get_config(JAMBA_ARCH)
    cfg = dataclasses.replace(
        full, n_layers=len(full.block_pattern) * JAMBA_PERIODS)
    params = lm.init_lm(seeded_generator(torch.device("cuda"), 9), cfg)
    n = sum(p.numel() for p in params.parameters())
    tables = sum(p.numel() for name, p in params.named_parameters()
                 if not name.startswith("blocks."))
    n_full = (n - tables) * full.n_periods + tables
    print(f"cut: {JAMBA_ARCH} at {cfg.n_layers} of {full.n_layers} layers "
          f"(one period, full width): {n_full / 1e9:.2f}B parameters are "
          f"{2 * n_full / 1e9:.0f} GB in bf16; one period is {n / 1e9:.2f}B, "
          f"{4 * n / 1e9:.0f} GB as the f32 master at init", flush=True)
    total = dataclasses.replace(cfg, dtype=torch.float32,
                                topk_experts=cfg.n_experts)
    S = JAMBA_DECODE_S
    rel, _ = decode_vs_prefill(torch, params, total, S)
    check(rel <= DECODE_REL_TOL, f"jamba decode vs prefill rel {rel}")
    print(f"decode vs prefill: {JAMBA_ARCH} at full width, {cfg.n_layers} "
          f"layers (pattern {cfg.block_pattern}), f32, total routing, B=2: "
          f"prefill({S}) + decode(token {S}) vs prefill({S + 1}) max |diff| "
          f"/ max |logit| {rel:.3g} (tol {DECODE_REL_TOL}); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    cast_for_inference(params, cfg)
    free_card(torch)
    eng, launches = run_serve(torch, cfg, JAMBA_LENGTHS, JAMBA_LONG + 32,
                              params=params)
    del params
    check(launches == 2, f"jamba: {launches} flash launches, expected 2")
    serve_phase_end(torch, eng, "jamba", t0)
    return launches


def run_xlstm(torch):
    """xlstm-125m at full width and depth (12 layers, alternating mLSTM
    and sLSTM), random weights from a seed: decode vs prefill in f32 (S =
    256), then ``ServeEngine`` in bf16 with prompts of 1024, 300, 1024 and
    64 tokens.  No attention: the recurrences run token by token, and the
    profiled prefill prints the device events a token (the shortest
    prompt alone: profiling the 300-token prefill as well, about 90,000
    device events, made the phase about 50 s longer on an H100).  Returns
    the flash launches of the serve run (none)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    free_card(torch)
    cfg = get_config(XLSTM_ARCH)
    check_decode_matches_prefill(torch, XLSTM_ARCH, n_layers=cfg.n_layers,
                                 S=XLSTM_DECODE_S)
    free_card(torch)
    eng, launches = run_serve(torch, cfg, XLSTM_LENGTHS,
                              max(XLSTM_LENGTHS) + 32, profiled=(64,),
                              prof_n=1)
    check(launches == 0, f"xlstm: {launches} flash launches, expected 0")
    serve_phase_end(torch, eng, "xlstm", t0)
    return launches


def check_encdec(torch, cfg, S: int = WHISPER_DECODE_S):
    """whisper at full width in f32 on random frames, B = 2: prefill(S)
    through the kernel against the same prefill through the plain version,
    and prefill(S) + decode(token S) against prefill(S + 1) through
    ``mha_full`` (the chunked contract takes S + 1 only below 2048)."""
    from repro_torch.core.largevis import seeded_generator
    from repro_torch.kernels import ops, ref
    from repro_torch.models import encdec
    from repro_torch.models.factory import init_cache

    dev = torch.device("cuda")
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    gen = seeded_generator(dev, 11)
    params = encdec.init_encdec(gen, cfg)
    frames = torch.randn((2, cfg.enc_positions, cfg.d_model),
                         generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, S + 1), generator=gen,
                         device=dev)
    got, one = encdec.encdec_prefill(params, cfg, toks[:, :S], frames,
                                     attn_impl="chunked")
    with mock.patch.object(ops, "flash_attention", ref.flash_attention_ref):
        plain, _ = encdec.encdec_prefill(params, cfg, toks[:, :S], frames,
                                         attn_impl="chunked")
    rel_plain = float((got - plain).abs().max() / plain.abs().max())
    want, _ = encdec.encdec_prefill(params, cfg, toks, frames,
                                    attn_impl="full")
    cache = init_cache(cfg, 2, S + 1, dev)
    for name, t in one["self"].items():
        cache["self"][name][:, :, :S] = t
    cache["encoder_out"].copy_(one["encoder_out"])
    dec, _ = encdec.encdec_decode(params, cfg, toks[:, S:], cache,
                                  torch.full((2,), S, device=dev))
    rel = float((dec - want).abs().max() / want.abs().max())
    print(f"decode vs prefill: {cfg.name} at full width and depth, f32, "
          f"random frames (2, {cfg.enc_positions}, {cfg.d_model}): "
          f"prefill({S}) through the kernel vs through the plain version "
          f"max |diff| / max |logit| {rel_plain:.3g} (tol {PREFILL_REL_TOL});"
          f" prefill({S}) + decode(token {S}) vs prefill({S + 1}) through "
          f"mha_full {rel:.3g} (tol {DECODE_REL_TOL})", flush=True)
    check(rel_plain <= PREFILL_REL_TOL, f"whisper prefill vs the plain "
          f"version rel {rel_plain}")
    check(rel <= DECODE_REL_TOL, f"whisper decode vs prefill rel {rel}")


def run_whisper(torch):
    """whisper-tiny at full width and depth (4 encoder and 4 decoder
    layers over 1500 frames), random weights from a seed:
    :func:`check_encdec` in f32, then ``ServeEngine`` in bf16 (zero
    frames, as the JAX engine feeds them; prompts of 4096, 700, 4096 and
    100 tokens: the long ones take ``flash_attention`` at (1, 4096, 6, 64)
    in each decoder layer).  Returns the flash launches of the serve
    run."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    free_card(torch)
    cfg = get_config(WHISPER_ARCH)
    check_encdec(torch, cfg)
    free_card(torch)
    eng, launches = run_serve(torch, cfg, WHISPER_LENGTHS, WHISPER_LONG + 32)
    want = 2 * cfg.n_layers
    check(launches == want, f"whisper: {launches} flash launches, expected "
          f"{want}")
    serve_phase_end(torch, eng, "whisper", t0)
    return launches


# ---------------------------------------------------------------------------
# the LM training path
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen1.5-0.5b", 4, 4096, 8
# the trainer's optimizer: JAX's AdamW (lr 3e-4) with a 1-step warmup: its
# default 100-step warmup moves a full-width model's held-out loss by about
# 1e-3 in 8 steps, below the batches' spread, and lr 1e-3 from the first
# step diverges by the eighth (tools/train_lr_probe.py)
TRAIN_LR, TRAIN_WARMUP = 3e-4, 1
TRAIN_EVAL_BATCH = 10_000          # a held-out batch of the stream
# the resume check: 2 of qwen's 24 layers at full width (a printed cut; a
# full-depth train state is 5.6 GB a checkpoint, four of them here)
RESUME_LAYERS, RESUME_CUT, RESUME_EVERY = 2, 5, 4
# every architecture's reduced step at B 1, S 256 (mha_full), and three at
# S 4096 (attend's rule takes the flash path above 2048 x 2048 pairs): a
# causal decoder, a windowed one and the encoder-decoder; the others' CPU
# steps at that length take up to a minute (gemma3's 10 local layers
# through the dense plain version)
ARCH_BATCH = 1
ARCH_CASES = [(name, 256) for name in (
    "qwen1.5-0.5b", "gemma3-12b", "llama3-8b", "phi3-medium-14b",
    "whisper-tiny", "mixtral-8x7b", "dbrx-132b", "jamba-v0.1-52b",
    "chameleon-34b", "xlstm-125m")] + [
    ("qwen1.5-0.5b", 4096), ("mixtral-8x7b", 4096), ("whisper-tiny", 4096)]
# a card step against the CPU step from one state (f32): the loss, and
# every updated parameter relative to the largest |parameter|
STEP_LOSS_TOL, STEP_PARAM_TOL = 1e-5, 1e-4
# the backward kernel against its plain version on the same out and lse,
# max |err| / max |plain| of each gradient: f32, the same arithmetic
# summed in other orders; bf16, dq, dk and dv rounded once to 8 bits (2^-8
# of the largest where the two f32 sums straddle a rounding boundary) and
# p and ds rounded to 8 bits where their f32 values straddle one.  bf16
# main shapes also: the kernel's distance from the f32 gradient of the
# same inputs at most BWD_VS_F32 times the plain version's
BWD_F32_TOL, BWD_BF16_TOL, BWD_VS_F32 = 1e-5, 1e-2, 2.0
LSE_TOL = 2e-5            # forward lse vs plain, x max(1, |lse|)
BWD_MAIN = {((2, 4096, 16, 64), 0, "bfloat16"):
            "qwen1.5-0.5b's training microbatch",
            ((1, 8192, 32, 128), 4096, "bfloat16"): "mixtral-8x7b layers",
            ((1, 8192, 16, 256), 0, "bfloat16"): "gemma3-12b global layers",
            ((1, 8192, 16, 256), 1024, "bfloat16"):
            "gemma3-12b local layers",
            ((1, 4096, 6, 64), 0, "bfloat16"): "whisper-tiny decoder",
            ((1, 2048, 4, 128), 0, "float32"): "an f32 shape"}
BWD_RECORD = ((2, 4096, 16, 64), 0, "bfloat16")   # the kernels line's


def flash_bwd_bound(B, S, H, hd, W, dtype: str):
    """The least time of one backward: 5 products of 2 hd operations a
    pair under the mask at the tensor-core bf16 (or f32) peak, against
    q, k, v, out and dout read, dq, dk and dv written and lse read once."""
    size, peak = (2, PEAK_BF16_PER_S) if dtype == "bfloat16" else \
        (4, PEAK_F32_PER_S)
    n_ops = 5 * 2 * hd * B * H * flash_pairs(S, W)
    n_bytes = 8 * B * S * H * hd * size + B * H * S * 4
    return bound_ms(n_bytes, n_ops, peak)


def _bwd_errs(got, want):
    return [float((g.float() - w.float()).abs().max() /
                  w.float().abs().max()) for g, w in zip(got, want)]


def check_flash_bwd(torch):
    """``flash_attention_bwd`` against its plain version, on the forward
    kernel's own out and lse (the forward's lse held to the plain
    version's first): at the training shapes of the architectures in
    bf16 (qwen's microbatch, mixtral's windowed, gemma3's global and local
    layers at hd 256, whisper's decoder) and one f32 shape, and at ragged
    shapes in both types (S and T off the tiles, S > T, non-causal, head
    dims 16 to 256, windows of 2, 64 and 100; a window of 1 leaves each
    row its own key alone, so ds is 0 up to rounding and dq and dk are
    noise); every case called twice, bitwise
    equal; each main shape timed by CUDA events beside the plain version,
    SDPA's backward (``is_causal``, or the window's boolean mask; the
    backward alone) and its bound, with the device time of its three
    kernels.  Returns the record of qwen's shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    cases = [(shape, shape[1], True, w, dt) for shape, w, dt in BWD_MAIN]
    for dt in ("bfloat16", "float32"):
        cases += [((2, 1000, 3, 64), 1037, True, 0, dt),
                  ((1, 300, 2, 64), 77, True, 0, dt),
                  ((1, 130, 4, 64), 130, False, 0, dt),
                  ((1, 257, 2, 16), 257, True, 2, dt),
                  ((1, 300, 2, 32), 300, True, 64, dt),
                  ((1, 1000, 2, 128), 1037, True, 100, dt),
                  ((1, 500, 2, 256), 500, True, 0, dt),
                  ((1, 130, 2, 256), 130, False, 0, dt)]
    max_err, errs, recs = 0.0, [], {}
    for (b, s, h, d), t, causal, w, name in cases:
        dt = getattr(torch, name)
        q, dout = (torch.randn((b, s, h, d), generator=gen, device=dev)
                   .to(dt) for _ in range(2))
        k, v = (torch.randn((b, t, h, d), generator=gen, device=dev).to(dt)
                for _ in range(2))
        kw = dict(causal=causal, window=w)
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        _, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
        lse_err = float(((lse - want_lse).abs() /
                         want_lse.abs().clamp_min(1.0)).max())
        got = fa.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        again = fa.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, **kw)
        rel = _bwd_errs(got, want)
        tol = BWD_BF16_TOL if dt == torch.bfloat16 else BWD_F32_TOL
        what = (f"({b},{s},{h},{d})xT={t}{'' if causal else ' nc'}"
                f"{f' W={w}' if w else ''} {name}")
        check(all(g.dtype == dt and bool(torch.isfinite(g).all())
                  for g in got), f"flash_attention_bwd: {what}: not finite")
        check(lse_err <= LSE_TOL, f"flash_attention lse: {what}: "
              f"{lse_err:.3g} > {LSE_TOL}")
        check(max(rel) <= tol, f"flash_attention_bwd: {what}: dq, dk, dv "
              f"max |err| / max |plain| {rel} > {tol} (earlier cases: "
              f"{'; '.join(errs)})")
        check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
              f"flash_attention_bwd: {what}: two calls differ")
        note = ""
        if ((b, s, h, d), w, name) in BWD_MAIN and dt == torch.bfloat16:
            f32 = [x.float() for x in (q, k, v, dout)]
            out32, lse32 = ref.flash_attention_fwd_ref(*f32[:3], **kw)
            exact = ref.flash_attention_bwd_ref(*f32[:3], out32, f32[3],
                                                lse32, **kw)
            k_err, p_err = _bwd_errs(got, exact), _bwd_errs(want, exact)
            del f32, out32, exact
            check(all(a <= BWD_VS_F32 * b_ for a, b_ in zip(k_err, p_err)),
                  f"flash_attention_bwd: {what}: distance from the f32 "
                  f"gradient {k_err} > {BWD_VS_F32} x the plain version's "
                  f"{p_err}")
            note = (f", from the f32 gradient {max(k_err):.3g} (plain "
                    f"{max(p_err):.3g})")
        max_err = max(max_err, max(float((g.float() - w_.float()).abs()
                                         .max()) for g, w_ in zip(got, want)))
        errs.append(f"{what} {max(rel):.3g}{note}")
        if ((b, s, h, d), w, name) in BWD_MAIN:
            recs[(b, s, h, d), w, name] = (q, k, v, out, dout, lse)
        del q, k, v, dout, out, lse, got, again, want
    print(f"flash_attention_bwd: dq, dk, dv max |err| / max |plain| (limit "
          f"f32 {BWD_F32_TOL}, bf16 {BWD_BF16_TOL}; bf16 main shapes also "
          f"at most {BWD_VS_F32} x the plain version's distance from the "
          f"f32 gradient), the forward's lse within {LSE_TOL}, two calls "
          f"bitwise equal, {len(errs)} cases: {'; '.join(errs)}",
          flush=True)
    torch.cuda.empty_cache()
    record = None
    for key, what in BWD_MAIN.items():
        (b, s, h, d), w, name = key
        q, k, v, out, dout, lse = recs.pop(key)
        kw = dict(causal=True, window=w)
        ms = time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, out, dout, lse, **kw))
        prof = device_profile(torch, lambda: fa.flash_attention_bwd(
            q, k, v, out, dout, lse, **kw), n=5)
        dev_ms, seen, made = prof.kernel("flash_attention_bwd")
        parts = {e: sum(t for key_, (t, _) in prof.events.items()
                        if e in key_) / max(seen, 1) for e in BWD_EVENTS}
        plain = time_ms(torch, lambda: ref.flash_attention_bwd_ref(
            q, k, v, out, dout, lse, **kw), reps=2, warmup=1)
        torch.cuda.empty_cache()
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        if w:
            i = torch.arange(s, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
            o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            lib_what = "SDPA backward with the window's boolean mask"
        else:
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            lib_what = "SDPA backward is_causal"
        g = dout.transpose(1, 2)
        lib = time_ms(torch, lambda: torch.autograd.grad(
            o, (qt, kt, vt), g, retain_graph=True))
        del o, qt, kt, vt, g
        bms, by = flash_bwd_bound(b, s, h, d, w, name)
        print(f"flash_attention_bwd {(b, s, h, d)}{f' W={w}' if w else ''} "
              f"causal {name} ({what}): kernel {ms:.4f} ms by CUDA events "
              f"({dev_ms:.4f} ms of device time a call by the profiler, "
              f"{seen} of {made} calls seen: "
              + ", ".join(f"{e} {t:.4f}" for e, t in parts.items())
              + f" ms); plain {plain:.4f} ms; {lib_what} {lib:.4f} ms; "
              f"bound {bms:.5f} ms ({by}; {flash_pairs(s, w) * b * h} pairs "
              f"under the mask)", flush=True)
        if key == BWD_RECORD:
            record = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                          library_ms=lib)
        del q, k, v, out, dout, lse
        torch.cuda.empty_cache()
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces="src/repro/models/attention.py:175 (_mha_bwd_rule;"
                " no Pallas kernel)", max_abs_err=max_err, **record)


def _timed_steps(torch, train_mod, step_ms: list):
    """``train_mod.make_train_step`` wrapped so that each step's wall time
    (host clock around a synchronize) lands in ``step_ms``."""
    real = train_mod.make_train_step

    def builder(*args, **kw):
        fn = real(*args, **kw)

        def call(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            return res
        call.microbatches = fn.microbatches
        return call
    return mock.patch.object(train_mod, "make_train_step", builder)


def run_trainer(torch, ckpt_dir: str):
    """``launch.train.train`` on qwen1.5-0.5b at full width and depth (24
    layers, d 1024, vocab 151,936): batch 4 x 4096 tokens, which
    ``pick_microbatches`` cuts into 2 microbatches of (2, 4096), for 8
    steps of the Markov stream from random weights (AdamW at lr
    ``TRAIN_LR`` from the first step), with the launch counts reset just
    before and read just after: the loss by step, starting at about
    ln(vocab), and the loss of a held-out batch at the initial weights
    (the same seed's init) and after the 8 steps, which must fall; ms a
    step, tokens/s, peak memory, the flash launches a step (forward 24
    layers x 2 microbatches x 2, the period recomputed in the backward;
    backward 24 x 2); then one profiled step.  Returns (the launch counts,
    the parameter count)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.largevis import seeded_generator
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import pick_microbatches
    from repro_torch.models import lm
    from repro_torch.models.factory import make_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_config(TRAIN_ARCH)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    held = token_batch(1, TRAIN_EVAL_BATCH, 2, TRAIN_SEQ, cfg.vocab_size,
                       device="cuda")

    def held_loss(params):
        with torch.no_grad():
            return float(lm.lm_loss(params, cfg, held["tokens"],
                                    held["labels"], remat=False))

    free_card(torch)
    init = make_model(cfg)["init"](seeded_generator(torch.device("cuda"), 0))
    before = held_loss(init)
    del init
    free_card(torch)
    step_ms = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with _timed_steps(torch, train_mod, step_ms):
        params, opt, losses = train_mod.train(
            TRAIN_ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            reduced=False, microbatches=0, ckpt_dir=ckpt_dir, resume=False,
            log_every=1, opt_cfg=opt_cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = held_loss(params)
    loss = [x for _, x in losses]
    n_micro = pick_microbatches(ShapeConfig("c", "train", TRAIN_SEQ,
                                            TRAIN_BATCH))
    per_step = {"flash_attention": cfg.n_layers * n_micro * 2,
                "flash_attention_bwd": cfg.n_layers * n_micro}
    steady = step_ms[1:]
    ms = sum(steady) / len(steady)
    by_step = [round(x, 1) for x in step_ms]
    n_params = sum(p.numel() for p in params.parameters())
    print(f"train: {TRAIN_ARCH} at full width and depth ({n_params / 1e6:.1f}"
          f"M parameters, f32 master weights, bf16 compute), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {n_micro} microbatches, "
          f"{TRAIN_STEPS} steps of the Markov stream (AdamW lr {TRAIN_LR}, "
          f"warmup {TRAIN_WARMUP}) in {wall:.1f} s: loss by step "
          f"{[round(x, 4) for x in loss]} (ln vocab "
          f"{math.log(cfg.vocab_size):.4f}); a held-out batch's loss "
          f"{before:.5f} at the initial weights, {after:.5f} after; step ms "
          f"{by_step}, {ms:.1f} ms a step after the first, "
          f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} tokens/s; peak "
          f"{peak:.2f} GiB; launches {counts} ({per_step} a step expected)",
          flush=True)
    check(len(loss) == TRAIN_STEPS and all(math.isfinite(x) for x in loss),
          f"train: losses {loss}")
    check(abs(loss[0] - math.log(cfg.vocab_size)) < 1.0,
          f"train: first loss {loss[0]}, not about ln(vocab)")
    check(after < before, f"train: the held-out loss did not fall: "
          f"{before} -> {after}")
    for name, n in per_step.items():
        check(counts[name] == n * TRAIN_STEPS, f"train: {name} launched "
              f"{counts[name]} times, expected {n} x {TRAIN_STEPS}")
    step_fn = train_mod.make_train_step(
        cfg, ShapeConfig("c", "train", TRAIN_SEQ, TRAIN_BATCH),
        opt_cfg=opt_cfg, microbatches=0)
    batch = token_batch(1, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                        cfg.vocab_size, device="cuda")
    prof = device_profile(torch, lambda: step_fn(params, opt, batch), n=1)
    attn_ms = sum(ms * seen for ms, seen, _ in (
        prof.kernel(k) for k in ("flash_attention", "flash_attention_bwd")))
    print(f"  profiled train step: {busy_line(prof, top=8)}; the flash "
          f"kernels {attn_ms:.3f} ms of it", flush=True)
    del params, opt, step_fn, batch
    free_card(torch)
    return counts, n_params


def run_resume(torch, ckpt_root: str, full_params: int) -> dict:
    """JAX's ``test_restart_bit_identical`` on the card, at full width and
    ``RESUME_LAYERS`` layers (a printed cut): an 8-step run against a
    5-step run resumed to 8, both saving every 4 steps; the resumed run
    restarts at step 4 and its losses from there are bitwise the
    uninterrupted run's.  Returns the launch counts of the three runs."""
    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.optim.adamw import AdamWConfig

    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=RESUME_LAYERS)
    print(f"cut: the resume check at {RESUME_LAYERS} of {full.n_layers} "
          f"layers (full width; a full-depth train state, parameters and "
          f"two moments in f32, is {12 * full_params / 1e9:.2f} GB a "
          "checkpoint)", flush=True)

    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)

    def run(steps, d, resume):
        return dict(train_mod.train(
            TRAIN_ARCH, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            reduced=False, microbatches=0, ckpt_dir=d,
            save_every=RESUME_EVERY, resume=resume, log_every=10**6,
            opt_cfg=opt_cfg)[2])

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(train_mod, "get_config", lambda name: cfg):
        ref = run(TRAIN_STEPS, os.path.join(ckpt_root, "ref"), False)
        d = os.path.join(ckpt_root, "int")
        run(RESUME_CUT, d, False)
        resumed = run(TRAIN_STEPS, d, True)
    counts = ops.launch_counts()
    after = list(range(RESUME_EVERY, TRAIN_STEPS))
    same = all(resumed.get(s) == ref[s] for s in after)
    got, want = [resumed.get(s) for s in after], [ref[s] for s in after]
    print(f"resume: {TRAIN_ARCH} at {RESUME_LAYERS} layers, {TRAIN_STEPS} "
          f"steps against {RESUME_CUT} resumed to {TRAIN_STEPS} (saves every "
          f"{RESUME_EVERY}) in {time.perf_counter() - t0:.1f} s: resumed "
          f"steps {sorted(resumed)}, losses {got} against {want}: "
          f"{'bitwise equal' if same else 'DIFFER'}; checkpoints "
          f"{ck.all_steps(d)}", flush=True)
    check(sorted(resumed) == after, f"resume: ran steps {sorted(resumed)}")
    check(all(resumed[s] == ref[s] for s in after),
          "resume: the resumed losses are not bitwise the uninterrupted "
          "run's")
    free_card(torch)
    return counts


def run_arch_steps(torch) -> dict:
    """Every architecture at ``cfg.reduced()`` (f32): one ``make_train_step``
    step on the card against the same step on the CPU (the plain versions)
    from one state, routers scaled by 100 (stable top-2 membership, as the
    CPU tests hold MoE), at the lengths of ``ARCH_CASES`` (S 4096 through
    the f32 flash kernels); the loss within ``STEP_LOSS_TOL`` relative, every updated
    parameter within ``STEP_PARAM_TOL`` of the largest |parameter|; a
    second card step from the same state bitwise the first.  Returns the
    launch counts of the card steps."""
    import numpy as np

    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.core.largevis import seeded_generator
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.factory import make_model
    from repro_torch.optim.adamw import adamw_init

    total, lines = {}, []
    t0 = time.perf_counter()
    check({n for n, _ in ARCH_CASES} == set(ARCH_NAMES),
          "ARCH_CASES must hold every architecture")
    for name, S in ARCH_CASES:
        cfg = get_config(name).reduced()
        init = make_model(cfg)["init"](seeded_generator("cpu", 3))
        tree = lm_params_to_numpy(init, cfg)
        del init

        def routers(t):
            return {k: (v * np.float32(100) if k == "router" else
                        routers(v) if isinstance(v, dict) else v)
                    for k, v in t.items()}
        tree = routers(tree)
        batch = token_batch(7, 0, ARCH_BATCH, S, cfg.vocab_size)
        if cfg.is_encoder_decoder:
            batch["encoder_frames"] = torch.from_numpy(
                np.random.default_rng(8).standard_normal(
                    (ARCH_BATCH, cfg.enc_positions, cfg.d_model))
                .astype(np.float32))
        step = make_train_step(cfg, ShapeConfig("c", "train", S,
                                                ARCH_BATCH), microbatches=1)

        def run(device):
            p = lm_params_from_numpy(tree, cfg, device)
            b = {k: v.to(device) for k, v in batch.items()}
            p, _, loss = step(p, adamw_init(p), b)
            return lm_params_to_numpy(p, cfg), float(loss)

        before = ops.launch_counts()
        got, loss = run("cuda")
        total = _add_counts(total, {k: c - before[k] for k, c in
                                    ops.launch_counts().items()})
        again, loss2 = run("cuda")
        want, want_loss = run("cpu")

        def flat(t):
            return [x for v in t.values() for x in (
                flat(v) if isinstance(v, dict) else [v])]
        scale = max(float(np.abs(x).max()) for x in flat(want))
        p_err = max(float(np.abs(a - b).max()) for a, b in
                    zip(flat(got), flat(want))) / scale
        l_err = abs(loss - want_loss) / abs(want_loss)
        same = loss2 == loss and all(np.array_equal(a, b) for a, b in
                                     zip(flat(again), flat(got)))
        lines.append(f"{name} S={S} loss {loss:.6f} (cpu {want_loss:.6f}, "
                     f"rel {l_err:.2g}) params {p_err:.2g}"
                     f"{'' if same else ' NOT BITWISE'}")
        check(l_err <= STEP_LOSS_TOL and p_err <= STEP_PARAM_TOL,
              f"train step {name}: card vs CPU loss rel {l_err}, parameters "
              f"{p_err} of max |param|")
        check(same, f"train step {name}: two card steps from one state "
              "differ")
    print(f"train steps, reduced f32, card vs CPU from one state (loss tol "
          f"{STEP_LOSS_TOL} relative, parameters {STEP_PARAM_TOL} of max "
          f"|param|; two card steps bitwise) in {time.perf_counter() - t0:.1f}"
          f" s: {'; '.join(lines)}; launches {total}", flush=True)
    free_card(torch)
    return total


def run_training(torch) -> tuple[dict, dict]:
    """The LM training phase (the serving phases' state released first):
    the backward kernel's checks, the full-width trainer, the resume check
    and every architecture's step.  Returns (the backward kernel's record,
    the launch counts of the training paths)."""
    free_card(torch)
    t0 = time.perf_counter()
    record = check_flash_bwd(torch)
    print(f"flash backward checks: {time.perf_counter() - t0:.1f} s",
          flush=True)
    free_card(torch)
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        counts, n_params = run_trainer(torch, os.path.join(tmp, "main"))
        print(f"trainer: {time.perf_counter() - t1:.1f} s", flush=True)
        counts = _add_counts(counts, run_resume(torch, tmp, n_params))
    counts = _add_counts(counts, run_arch_steps(torch))
    record["launches"] = counts["flash_attention_bwd"]
    print(f"training phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return record, counts


# ---------------------------------------------------------------------------
# the tree forest, the tuner and the baselines
# ---------------------------------------------------------------------------

TREE_SAMPLES_PER_NODE = 2_000   # the tree fit's layout (printed cut)
LINE_SAMPLES_PER_NODE = 1_000   # the JAX package's line_layout default
N_SUBSET = 10_000               # exact t-SNE / SNE and the VP-tree
TSNE_ITERS = 1_000              # the JAX package's tsne_layout default
SNE_LR = 20.0                   # fig5's symmetric-SNE lr (t-SNE: 200)
NND_ITERS = 4                   # the JAX package's nn_descent default
VP_QUERIES = 200                # VP-tree queries on the host


def _counted(torch, fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after (the card synchronised): (result, counts)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts()


def _add_counts(total: dict, counts: dict) -> dict:
    for name, c in counts.items():
        total[name] = total.get(name, 0) + c
    return total


def check_tree_codes(torch, x, cfg, depth: int):
    """The card's tree codes against the CPU's from one draw of pairs: a
    point may differ only within the f32 bound of the plane that split
    it (``knn.tree_code_flips``)."""
    from repro_torch.core import knn

    gen = torch.Generator(device=x.device).manual_seed(5)
    pairs = torch.randint(0, x.shape[0], (cfg.n_trees, (1 << depth) - 1, 2),
                          generator=gen, device=x.device)
    card = knn.tree_codes(x, cfg.n_trees, depth, pairs=pairs)
    ms = time_ms(torch, lambda: knn.tree_codes(x, cfg.n_trees, depth,
                                                pairs=pairs), reps=3)
    hash_ms = time_ms(torch, lambda: knn.hash_codes(
        x, cfg.n_trees, depth, generator=gen), reps=3)
    cpu = knn.tree_codes(x.cpu(), cfg.n_trees, depth, pairs=pairs.cpu())
    pt, tr, margin, bound = knn.tree_code_flips(x, pairs, card, cpu, depth)
    check(bool((margin <= bound).all()), f"tree codes: points "
          f"{pt[margin > bound].tolist()[:10]} differ from the CPU's beyond "
          f"the f32 bound of their plane")
    print(f"tree codes: {cfg.n_trees} trees x depth {depth} on (N="
          f"{x.shape[0]}, d={x.shape[1]}): {ms:.3f} ms on the card "
          f"(hash_codes {hash_ms:.3f} ms); equal to the CPU's from the same "
          f"pairs except {len(pt)} point-tree codes, each within the f32 "
          f"bound of its plane (largest margin / bound "
          f"{float((margin / bound).max(initial=0.0)):.3g})", flush=True)


def run_tree_fit(torch, x, labels, res, acc_fit, cfg):
    """``largevis`` with ``rp_mode="tree"`` at full width, its layout cut;
    its forest folds through ``topk_sqdist`` once a tree.  Returns its
    launch counts."""
    from repro_torch import largevis
    from repro_torch.core import knn, metrics

    spn = min(TREE_SAMPLES_PER_NODE, cfg.samples_per_node)
    tcfg = dataclasses.replace(cfg, rp_mode="tree", samples_per_node=spn)
    print(f"cut: the tree fit's layout samples_per_node "
          f"{PAPER_SAMPLES_PER_NODE} -> {spn} (its graph stage is the "
          f"point; the hash fit ran at {cfg.samples_per_node})", flush=True)
    depth = cfg.tree_depth or knn._auto_depth(x.shape[0], cfg.leaf_target)
    check_tree_codes(torch, x, cfg, depth)

    def fit():
        tree = largevis(x, cfg=tcfg, device=x.device)
        return (tree, metrics.graph_recall(tree.x, tree.knn_idx),
                metrics.knn_classifier_accuracy(tree.y, labels))

    (tree, recall, acc), counts = _counted(torch, fit)
    recall_hash = metrics.graph_recall(res.x, res.knn_idx)
    t = tree.timings
    print(f"tree fit: rp_mode='tree', {cfg.n_trees} trees of depth {depth}, "
          f"samples_per_node={spn}: knn_s {t['knn_s']:.3f} s (hash "
          f"{res.timings['knn_s']:.3f} s), graph_recall {recall:.4f} (hash "
          f"{recall_hash:.4f}), knn_classifier_accuracy {acc:.4f} (hash fit "
          f"{acc_fit:.4f}, at {cfg.samples_per_node}); layout_s "
          f"{t['layout_s']:.3f} s for {tree.steps} steps; topk_sqdist "
          f"launches {counts['topk_sqdist']}; launches {counts}", flush=True)
    check(bool(torch.isfinite(tree.y).all()), "the tree fit is not finite")
    check(bool(((tree.knn_idx >= 0) & (tree.knn_idx < x.shape[0])).all()),
          "the tree graph holds an empty or out-of-range slot")
    check(counts["topk_sqdist"] == cfg.n_trees, f"the tree forest launched "
          f"topk_sqdist {counts['topk_sqdist']} times for {cfg.n_trees} trees")
    check(counts["fused_edge_step"] == tree.steps,
          f"fused_edge_step launched {counts['fused_edge_step']} times in a "
          f"layout of {tree.steps} steps")
    # floors against a collapse, as the hash fit's: the tree forest on
    # these isotropic clusters leaves exploring less to start from than
    # the hash forest (recall 0.4805 against 0.7661 on the card; the port
    # holds JAX's tree graph slot for slot on the CPU), while a forest of
    # random buckets plus one round would stay near (K^2 + K) / N = 0.23
    check(recall >= 0.4, f"tree graph_recall {recall} < 0.4")
    check(acc >= 0.8, f"tree fit accuracy {acc} < 0.8")
    return counts


def run_autotuner(torch, x, res, cfg):
    """Sweeps of ``symmetrize`` and ``neighbor_explore`` at the fit's
    shapes, in ``sweep`` mode into a temporary cache (winner and time
    beside the legacy tile's); then, with the user cache empty, a fit under
    ``routing.autotune="cache"`` (the committed table), bitwise one under
    ``"off"`` (the layout cut as the tree fit's).  Returns the two fits'
    launch counts."""
    from repro_torch import RoutingConfig, largevis
    from repro_torch.runtime import autotune

    backend = x.device.type
    N, K = res.knn_idx.shape
    cells = (("symmetrize", dict(n=N, k=K)),
             ("neighbor_explore", dict(n=N, k=K, d=x.shape[1])))
    empty = os.environ["REPRO_AUTOTUNE_CACHE"]
    parts = []
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_AUTOTUNE_CACHE"] = tmp
        autotune.set_mode("sweep")
        try:
            for kernel, shape in cells:
                # the committed table holds these cells, so a lookup
                # would not miss: sweep them outright
                t0 = time.perf_counter()
                got = autotune.sweep(kernel, shape, backend=backend)
                secs = time.perf_counter() - t0
                entry = autotune._read_entries(autotune._cache_path(
                    backend))[autotune.bucket_key(kernel, shape, backend)]
                parts.append(
                    f"{kernel} {shape} (bucket {entry['shape']}): {got} "
                    f"{entry['us']:.1f} us, legacy "
                    f"{autotune.legacy_default(kernel)} "
                    f"{entry['us_default']:.1f} us, swept in {secs:.2f} s")
        finally:
            autotune.set_mode(None)
            os.environ["REPRO_AUTOTUNE_CACHE"] = empty
    print("autotune sweep: " + "; ".join(parts), flush=True)
    spn = min(TREE_SAMPLES_PER_NODE, cfg.samples_per_node)
    table = autotune._read_entries(autotune._defaults_path(backend))
    check(bool(table), f"the committed {backend} table is missing or empty")
    fits, counts = {}, {}
    for m in ("cache", "off"):
        mcfg = dataclasses.replace(cfg, samples_per_node=spn,
                                   routing=RoutingConfig(autotune=m))
        autotune._mem.clear()
        fits[m], c = _counted(torch, lambda: largevis(x, cfg=mcfg,
                                                      device=x.device))
        _add_counts(counts, c)
        if m == "cache":
            used = sorted(k for k in autotune._mem if k in table)
            check(bool(used), "the cache fit used no committed entry")
            print(f"autotune cache fit: committed entries used "
                  f"{ {k: table[k]['config'] for k in used} }", flush=True)
    autotune.set_mode(None)
    for name in ("knn_idx", "knn_dist", "weights", "y"):
        a, b = getattr(fits["cache"], name), getattr(fits["off"], name)
        check(torch.equal(a, b), f"the tuned and the untuned fit differ in "
              f"{name} ({int((a != b).sum())} entries)")
    tc, to = fits["cache"].timings, fits["off"].timings
    print(f"autotune: the fit under routing.autotune='cache' (committed "
          f"table) bitwise equal to 'off' at samples_per_node={spn} "
          f"(graph, distances, weights, layout); cache / off: knn_s "
          f"{tc['knn_s']:.3f} / {to['knn_s']:.3f} s, weights_s "
          f"{tc['weights_s']:.3f} / {to['weights_s']:.3f} s", flush=True)
    return counts


def _subset_graph(torch, x, labels, cfg):
    """The first N_SUBSET points, their KNN graph and weights (the fit's
    graph stage at the fit's settings)."""
    from repro_torch.core.largevis import build_graph
    xs = x[:N_SUBSET].contiguous()
    idx, _, w, _ = build_graph(xs, cfg=cfg, device=xs.device)
    return xs, labels[:N_SUBSET], idx, w


def run_line(torch, res, labels, acc_fit, cfg):
    """LINE from the fit's samplers at the JAX default depth, twice from
    one seed (bitwise); one ordered scatter a step."""
    from repro_torch.core import metrics
    from repro_torch.core.baselines.line import line_layout
    from repro_torch.core.largevis import seeded_generator

    def run():
        t0 = time.perf_counter()
        y, steps = line_layout(seeded_generator(res.y.device, 21),
                               res.edge_sampler,
                               res.neg_sampler, res.y.shape[0],
                               samples_per_node=LINE_SAMPLES_PER_NODE,
                               n_negatives=cfg.n_negatives,
                               batch=cfg.batch_size)
        torch.cuda.synchronize()
        return y, steps, time.perf_counter() - t0

    (y, steps, secs), counts = _counted(torch, run)
    (y2, _, secs2), _ = _counted(torch, run)
    acc = metrics.knn_classifier_accuracy(y, labels)
    print(f"LINE (2-D, first order): samples_per_node="
          f"{LINE_SAMPLES_PER_NODE}, {steps} steps, {secs:.3f} s "
          f"({secs / steps * 1e3:.4f} ms a step; again {secs2:.3f} s), "
          f"bitwise equal twice from one seed; scatter_add_ordered launches "
          f"{counts['scatter_add_ordered']}; knn_classifier_accuracy "
          f"{acc:.4f} (the LargeVis fit {acc_fit:.4f})", flush=True)
    check(torch.equal(y, y2), "two LINE runs from one seed differ")
    check(bool(torch.isfinite(y).all()), "the LINE layout is not finite")
    check(counts["scatter_add_ordered"] == steps, f"LINE launched the "
          f"ordered scatter {counts['scatter_add_ordered']} times in "
          f"{steps} steps")
    return counts


def run_tsne(torch, sub):
    """Exact t-SNE and symmetric SNE on the subset's KNN graph."""
    from repro_torch.core import metrics
    from repro_torch.core.baselines.tsne import tsne_layout
    from repro_torch.core.largevis import seeded_generator

    xs, ls, idx, w = sub
    parts, total = [], {}
    for name, kw in (("t-SNE", dict(student_t=True)),
                     ("symmetric SNE", dict(student_t=False, lr=SNE_LR))):
        def run():
            t0 = time.perf_counter()
            out = tsne_layout(idx, w, n_iter=TSNE_ITERS,
                              generator=seeded_generator(w.device, 22), **kw)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        ((y, kls), secs), counts = _counted(torch, run)
        _add_counts(total, counts)
        acc = metrics.knn_classifier_accuracy(y, ls)
        check(bool(torch.isfinite(y).all()) and all(
            math.isfinite(k) for k in kls), f"{name}: not finite")
        parts.append(f"{name} {secs:.3f} s ({secs / TSNE_ITERS * 1e3:.3f} ms "
                     f"an iteration), KL at iteration "
                     f"{(len(kls) - 1) * 100} {kls[-1]:.4f}, "
                     f"knn_classifier_accuracy {acc:.4f}")
    print(f"exact SNE on the first {N_SUBSET} points' KNN graph (K="
          f"{idx.shape[1]}), {TSNE_ITERS} iterations: " + "; ".join(parts),
          flush=True)
    return total


def run_nn_descent(torch, x, res, cfg):
    """NN-Descent (random init + exploring) at full width: recall against
    brute force on the sampled rows, beside the forest's."""
    from repro_torch.core import metrics
    from repro_torch.core.baselines.nn_descent import nn_descent
    from repro_torch.core.largevis import seeded_generator

    def run():
        t0 = time.perf_counter()
        out = nn_descent(x, cfg.n_neighbors, iters=NND_ITERS,
                         generator=seeded_generator(x.device, 23))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    ((idx, _), secs), counts = _counted(torch, run)
    recall = metrics.graph_recall(x, idx)
    print(f"NN-Descent: random init + {NND_ITERS} exploring rounds, K="
          f"{cfg.n_neighbors}: {secs:.3f} s, graph_recall {recall:.4f} (the "
          f"fit's forest + {cfg.n_explore_iters} round: knn_s "
          f"{res.timings['knn_s']:.3f} s, graph_recall "
          f"{metrics.graph_recall(res.x, res.knn_idx):.4f})", flush=True)
    check(recall > 0.05, f"NN-Descent graph_recall {recall}")
    return counts


def run_vptree(torch, sub, k: int):
    """The VP-tree on the host over the subset: recall of VP_QUERIES
    queries against brute force on the card, and queries/s (the tree's
    build included, as ``vptree_knn`` builds it)."""
    import numpy as np

    from repro_torch.core.baselines.vptree import vptree_knn
    from repro_torch.kernels import ops

    xs = sub[0]
    xh = xs.cpu().numpy()
    t0 = time.perf_counter()
    got = vptree_knn(xh, k, n_query=VP_QUERIES)
    secs = time.perf_counter() - t0
    d = ops.pairwise_sqdist(xs[:VP_QUERIES], xs)
    rows = torch.arange(VP_QUERIES, device=xs.device)
    d[rows, rows] = 3.4e38
    true = torch.sort(d, dim=1, stable=True).indices[:, :k].cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / k
                            for a, b in zip(got, true)]))
    print(f"VP-tree (host, numpy): {xh.shape[0]} points in d={xh.shape[1]}, "
          f"K={k}, eps=0: {VP_QUERIES} queries in {secs:.3f} s with the "
          f"build, {VP_QUERIES / secs:.2f} queries/s; recall {recall:.4f} "
          f"against brute force on the card", flush=True)
    check(recall >= 0.99, f"VP-tree recall {recall} < 0.99")


def run_baselines(torch, x, labels, res, acc_fit, cfg):
    """LINE, exact t-SNE and SNE, NN-Descent and the VP-tree; returns the
    launch counts of the paths on the card."""
    counts = {}
    _add_counts(counts, run_line(torch, res, labels, acc_fit, cfg))
    sub, c = _counted(torch, lambda: _subset_graph(torch, x, labels, cfg))
    _add_counts(counts, c)
    _add_counts(counts, run_tsne(torch, sub))
    _add_counts(counts, run_nn_descent(torch, x, res, cfg))
    run_vptree(torch, sub, cfg.n_neighbors)
    return counts


# ---------------------------------------------------------------------------
# before and after: a parent checkout's package and this one, in turns
# ---------------------------------------------------------------------------

PARENT_STEPS = 2_000


# ---------------------------------------------------------------------------
# the distributed fit: world 1 over NCCL, world 2 over gloo on one card
# ---------------------------------------------------------------------------

DIST_CUT_SPN = 2_000          # world 2's local-SGD layout (a printed cut)
DIST_SMALL_N = 20_000         # the fault and elastic phases' points
MARGINAL_TOL = 1e-4           # |m_P - m_1| * E: of one uniform slot's mass


def ring_fold_inputs(torch, x, cfg):
    """The ring's slab codes and ids at the fit's shapes: the 8 trees'
    codes of all N points at the depth the fit takes for N."""
    from repro_torch.core import knn as knn_lib
    from repro_torch.core.knn_sharded import slab_codes

    N, d = x.shape
    depth = cfg.tree_depth or knn_lib._auto_depth(N, cfg.leaf_target)
    gen = torch.Generator(device=x.device).manual_seed(5)
    proj = torch.randn((d, cfg.n_trees * depth), generator=gen,
                       device=x.device)
    codes = slab_codes(x, proj, cfg.n_trees, depth)
    ids = torch.arange(N, dtype=torch.int32, device=x.device)
    return codes, ids


def bucket_pairs(torch, ca, cb, a_ids, b_ids, rows: int = 1024) -> int:
    """The (row, column) pairs the fold's output depends on: those that
    share a bucket code in at least one tree, self pairs left out."""
    n = 0
    for r0 in range(0, ca.shape[0], rows):
        share = (ca[r0:r0 + rows, None, :] == cb[None, :, :]).any(-1)
        share &= a_ids[r0:r0 + rows, None] != b_ids[None, :]
        n += int(share.sum())
    return n


def check_ring_fold(torch, x, cfg):
    """The ring fold's ``topk_sqdist`` at world 1 (N x N, the call
    ``knn_sharded.ring_fold`` makes on a world of one) and world 2 (a
    rank's fold of its own N/2 slab, launched as ``ring_fold`` launches
    it, and the slab-order merge of a rank's two lists): ms by CUDA
    events, ids and distances exactly the plain version's on the first
    2,000 rows (the plain version at N x N would sort 10^10 candidates),
    the library's time (``torch.cdist`` + ``topk`` over 10,000-row
    blocks: the full cdist does not fit), and the bound, whose operations
    are 2d a pair that shares a bucket with its row in a tree (the only
    pairs the output depends on), counted from this run's codes."""
    from repro_torch.core import knn_sharded
    from repro_torch.kernels import knn_topk, ref
    from repro_torch.launch.mesh import make_data_mesh

    out = {}
    N, d = x.shape
    k = cfg.n_neighbors
    codes, ids = ring_fold_inputs(torch, x, cfg)
    T = codes.shape[1]
    mesh = make_data_mesh(0, device="cuda")
    check(mesh.size == 1, "the ring fold's check runs on a world of one")
    for world in (1, 2):
        n = N // world
        xs, cs, si = x[:n], codes[:n], ids[:n]
        if world == 1:
            def fold():
                return knn_sharded.ring_fold(mesh, xs, si, cs, k, N)
        else:
            def fold():
                return knn_topk.topk_sqdist(xs, xs, k, a_ids=si, b_ids=si,
                                            codes_a=cs, codes_b=cs)
        ms = time_ms(torch, fold, reps=3, warmup=1)
        ki, kd = fold()
        kw2 = dict(a_ids=si[:2000], b_ids=si, codes_a=cs[:2000], codes_b=cs)
        want = ref.topk_sqdist_ref(xs[:2000], xs, k, **kw2)
        exact_topk(torch, (ki[:2000], kd[:2000]), want,
                   f"the ring fold at world {world}")
        plain = time_ms(
            torch, lambda: ref.topk_sqdist_ref(xs[:2000], xs, k, **kw2),
            reps=2, warmup=1)

        def library():
            for r0 in range(0, n, 10_000):
                torch.cdist(xs[r0:r0 + 10_000], xs).topk(
                    k, dim=1, largest=False)
        lib = time_ms(torch, library, reps=2, warmup=1)
        pairs = bucket_pairs(torch, cs, cs, si, si)
        sq = sum(int((torch.bincount(cs[:, t].long()) ** 2).sum())
                 for t in range(T))
        n_bytes = 4 * (2 * n * d + 2 * n * T + n) + 2 * 8 * n * k
        bound, by = bound_ms(n_bytes, 2.0 * pairs * d)
        rec = dict(ms=ms, plain_2000_ms=plain, library_ms=lib,
                   bound_ms=bound, bound_by=by, pairs=pairs)
        merge = ""
        if world == 2:
            other = knn_topk.topk_sqdist(xs, x[n:2 * n], k, a_ids=si,
                                         b_ids=ids[n:2 * n], codes_a=cs,
                                         codes_b=codes[n:2 * n])
            parts = [(ki, kd), other]
            mi, md = knn_sharded.merge_slab_lists(parts, k)
            check(torch.equal(mi, knn_sharded.ring_fold(
                mesh, x[:2 * n], ids[:2 * n], codes[:2 * n], k, N)[0][:n]),
                "the merged world-2 lists are not world 1's fold")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            knn_sharded.merge_slab_lists(parts, k)
            torch.cuda.synchronize()
            mib = (torch.cuda.max_memory_allocated() - base) / 2**20
            mms = time_ms(torch, lambda: knn_sharded.merge_slab_lists(
                parts, k), reps=5, warmup=1)
            rec.update(merge_ms=mms, merge_mib=mib)
            merge = (f"; the merge of a rank's two ({n}, {k}) lists in "
                     f"slab order (torch.sort) {mms:.3f} ms, {mib:.1f} MiB "
                     f"at its peak, its ids world 1's fold's")
        out[world] = rec
        print(f"ring fold, world {world}: topk_sqdist ({n}, {d}) x ({n}, "
              f"{d}), k={k}, {T} trees' codes, no initial state: "
              f"{ms:.3f} ms a launch (CUDA events); {pairs} pairs share a "
              f"bucket ({pairs / n / n:.3e} of n^2; the sum over trees of "
              f"bucket sizes squared {sq}), bound {bound:.4f} ms ({by}); "
              f"plain version on the first 2,000 rows {plain:.3f} ms (ids "
              f"and distances exactly its), torch.cdist + topk over "
              f"10,000-row blocks {lib:.3f} ms{merge}", flush=True)
        check(pairs <= sq, f"{pairs} pairs share a bucket, more than {sq}")
    return out


def _counts_and_peak(torch):
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def run_distributed_fit(torch, x, labels, cfg):
    """The distributed fit at world 1 over NCCL, at full width, twice
    (bitwise), its sharded tables against the flat tables of its graph,
    and its timings, quality, peak memory and launches."""
    from repro_torch import largevis
    from repro_torch.core import metrics, sampler
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_data_mesh

    _counts_and_peak(torch)
    t0 = time.perf_counter()
    res = largevis(x, cfg=cfg, device="cuda")
    fit_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    mesh = make_data_mesh(cfg.data_shards, device="cuda")
    check(mesh.size == 1 and mesh.backend == "nccl",
          f"the world-1 mesh is {mesh.size} ranks over {mesh.backend}")
    recall = metrics.graph_recall(res.x, res.knn_idx)
    acc = metrics.knn_classifier_accuracy(res.y, labels)
    t = res.timings
    N = x.shape[0]
    print(f"distributed fit, world 1 over {mesh.backend}: N={N} "
          f"d={x.shape[1]} K={cfg.n_neighbors} trees={cfg.n_trees} "
          f"perplexity={cfg.perplexity} M={cfg.n_negatives} batch="
          f"{cfg.batch_size} samples_per_node={cfg.samples_per_node} "
          f"sync_every={cfg.sync_every}: {fit_s:.2f} s (knn_s "
          f"{t['knn_s']:.3f} = ring {t['knn_ring_s']:.3f} + explore "
          f"{t['knn_explore_s']:.3f}, weights_s {t['weights_s']:.3f}, "
          f"sampler_s {t['sampler_s']:.3f}, layout_s {t['layout_s']:.3f}; "
          f"{res.steps} steps in {res.dispatches} dispatches of "
          f"{res.steps_per_dispatch}); graph_recall {recall:.4f}, "
          f"knn_classifier_accuracy {acc:.4f}; peak memory {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); launches {counts}",
          flush=True)
    check(tuple(res.y.shape) == (N, cfg.out_dim)
          and bool(torch.isfinite(res.y).all()), "distributed layout")
    check(bool(((res.knn_idx >= 0) & (res.knn_idx < N)).all()),
          "the distributed graph holds an empty or out-of-range slot")
    check(bool((res.knn_dist.diff(dim=1) >= 0).all()),
          "distributed graph distances are not ascending")
    check(acc >= 0.95, f"distributed accuracy {acc} < 0.95")
    check(recall >= 0.4, f"distributed graph_recall {recall} < 0.4")
    check(counts["topk_sqdist"] == 1, f"the world-1 ring made "
          f"{counts['topk_sqdist']} topk_sqdist launches, not 1")
    check(counts["fused_edge_step"] == res.steps,
          f"fused_edge_step launched {counts['fused_edge_step']} times in "
          f"{res.steps} local steps")
    es, ns = sampler.build_samplers_sharded(res.knn_idx, res.weights,
                                            power=cfg.neg_power, mesh=mesh)
    ef = sampler.build_edge_sampler(res.knn_idx, res.weights)
    nf = sampler.build_negative_sampler(res.knn_idx, res.weights,
                                        power=cfg.neg_power)
    loc = es.local(0)
    for name, a, b in (("src", loc.src, ef.src), ("dst", loc.dst, ef.dst),
                       ("edge threshold", loc.threshold, ef.threshold),
                       ("edge alias", loc.alias, ef.alias),
                       ("node threshold", ns.threshold[0], nf.threshold),
                       ("node alias", ns.alias[0], nf.alias)):
        check(torch.equal(a, b), f"the world-1 sharded {name} table is not "
              "the flat table's")
    _counts_and_peak(torch)
    res2 = largevis(x, cfg=cfg, device="cuda")
    more = ops.launch_counts()
    for f in ("knn_idx", "knn_dist", "weights", "y"):
        check(torch.equal(getattr(res, f), getattr(res2, f)),
              f"two distributed fits from one seed differ in {f}")
    print(f"distributed fit, world 1: the sharded tables ({N * cfg.n_neighbors}"
          f" edges, {N} nodes) bitwise the flat tables of its graph; a "
          f"second fit from the same seed bitwise the first (graph, "
          f"distances, weights, layout), {sum(res2.timings.values()):.2f} s",
          flush=True)
    return res, acc, _add_counts(dict(counts), more), peak


def _world2_rank(rank, store, out_dir, xn, labels, cfg_fields, small):
    """One rank of the world-2 phase (a spawned process)."""
    import datetime
    import warnings as w

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import LargeVisConfig, largevis
    from repro_torch.configs.largevis_default import CheckpointConfig
    from repro_torch.core import metrics, sampler
    from repro_torch.core.largevis import build_graph, layout_graph
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.runtime.fault_tolerance import (DegradedModeWarning,
                                                     FaultInjector,
                                                     InjectedFault)

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=900))
    out = {}
    try:
        cfg = LargeVisConfig(**cfg_fields)
        mesh = make_data_mesh(0, device="cuda")
        assert mesh.size == 2 and mesh.backend == "gloo", mesh
        x = torch.from_numpy(xn).cuda()
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        idx, dist_, wts, t_graph = build_graph(x, cfg=cfg, device="cuda")
        graph_topk = ops.launch_counts()["topk_sqdist"]
        from repro_torch.core.knn_sharded import build_knn_graph_sharded
        ring_cfg = dataclasses.replace(cfg, n_explore_iters=0)
        ring_i, ring_d = build_knn_graph_sharded(
            x, ring_cfg, mesh=mesh,
            generator=torch.Generator(device="cuda").manual_seed(cfg.seed))
        out.update(ring_idx=ring_i.cpu().numpy(),
                   ring_dist=ring_d.cpu().numpy())
        es, _ = sampler.build_samplers_sharded(idx, wts, power=cfg.neg_power,
                                               mesh=mesh)
        marg = sampler.edge_marginals(es)
        out.update(idx=idx.cpu().numpy(), dist=dist_.cpu().numpy(),
                   w=wts.cpu().numpy(), marg=marg,
                   graph_s=np.array([t_graph["knn_s"], t_graph["knn_ring_s"],
                                     t_graph["knn_explore_s"],
                                     t_graph["weights_s"]]),
                   graph_topk=np.array(graph_topk),
                   peak=np.array(torch.cuda.max_memory_allocated()))
        # the local-SGD layout at the cut depth
        cut = LargeVisConfig(**{**cfg_fields, "samples_per_node":
                                DIST_CUT_SPN})
        ops.reset_launch_counts()
        res, _, timings = layout_graph(idx, wts, cfg=cut, device="cuda",
                                       return_samplers=True)
        fused = ops.launch_counts()["fused_edge_step"]
        move = torch.ones_like(res.y)
        mesh.all_reduce_sum(move)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            mesh.all_reduce_sum(move)
        torch.cuda.synchronize()
        out.update(acc=np.array(metrics.knn_classifier_accuracy(
            res.y, labels)), layout_s=np.array(timings["layout_s"]),
            sampler_s=np.array(timings["sampler_s"]),
            layout_steps=np.array(res.steps),
            sync_ms=np.array((time.perf_counter() - t0) / 50 * 1e3),
            layout_fused=np.array(fused), y=res.y.cpu().numpy())
        # a shard fault in the ring: 2 -> 1 with one DegradedModeWarning
        xs, ls = small
        scfg = LargeVisConfig(**{**cfg_fields,
                                 "samples_per_node": DIST_CUT_SPN})
        with w.catch_warnings(record=True) as log:
            w.simplefilter("always")
            sres = largevis(xs, cfg=scfg, device="cuda",
                            fault=FaultInjector(
                                {"knn_ring_step:1": {0: "exception"}}))
        degraded = [m for m in log
                    if issubclass(m.category, DegradedModeWarning)]
        out.update(degraded=np.array(len(degraded)),
                   degraded_msg=np.array(str(degraded[0].message)
                                         if degraded else ""),
                   fault_acc=np.array(metrics.knn_classifier_accuracy(
                       sres.y, ls)),
                   fault_finite=np.array(bool(torch.isfinite(sres.y).all())))
        # a layout checkpoint written here (killed after its second save),
        # resumed at world 1 by the parent
        ckpt = LargeVisConfig(**{**cfg_fields,
                                 "samples_per_node": DIST_CUT_SPN,
                                 "checkpoint": CheckpointConfig(
                                     str(Path(out_dir) / "ckpt"),
                                     every_chunks=100)})
        sidx, _, sw, _ = build_graph(xs, cfg=ckpt, device="cuda")
        try:
            layout_graph(sidx, sw, cfg=ckpt, device="cuda",
                         fault=FaultInjector({"layout_saved":
                                              {1: "exception"}}))
            killed = False
        except InjectedFault:
            killed = True
        out.update(killed=np.array(killed), small_idx=sidx.cpu().numpy(),
                   small_w=sw.cpu().numpy())
    finally:
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
        dist.destroy_process_group()


def run_world2(torch, xn, labels, cfg, world1, small):
    """World 2 over gloo, two processes on the one card (the kernels
    built by this process first): the ring graph, the weights and the
    sharded tables' marginals against world 1's; the local-SGD layout at
    a cut depth; a shard fault degrading 2 -> 1; a layout checkpoint of
    world 2 resumed here at world 1.  Returns the ranks' launches."""
    import numpy as np
    import torch.multiprocessing as mp

    from repro_torch.configs.largevis_default import CheckpointConfig
    from repro_torch.core import metrics
    from repro_torch.core.largevis import layout_graph
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.runtime.fault_tolerance import TopologyChangeWarning

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name in ("distributed", "sync_every")}
    tmp = tempfile.TemporaryDirectory()
    print(f"cut: world 2's local-SGD layout at samples_per_node "
          f"{cfg.samples_per_node} -> {DIST_CUT_SPN} (sync_every "
          f"{cfg.sync_every}, the default), beside world 1's layout of "
          f"world 1's graph at that depth; the fault and checkpoint phases "
          f"on the first {DIST_SMALL_N} points at that depth", flush=True)
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _world2_rank, args=(str(Path(tmp.name) / "store"), tmp.name, xn,
                            labels, fields, small),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.perf_counter() + 900
    try:
        while not ctx.join(timeout=10):
            check(time.perf_counter() < deadline,
                  "the world-2 ranks did not finish in 900 s")
    except Exception as e:            # a rank's exception or exit code
        fail(f"a world-2 rank failed: {type(e).__name__}: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t0
    r = [dict(np.load(Path(tmp.name) / f"rank{i}.npz")) for i in (0, 1)]
    for key in ("idx", "dist", "w", "marg", "y", "small_idx", "small_w"):
        check(np.array_equal(r[0][key], r[1][key]),
              f"the world-2 ranks' {key} differ")
    res1 = world1["res"]
    for key, ref_ in (("ring_idx", world1["ring"][0]),
                      ("ring_dist", world1["ring"][1])):
        diff = int((r[0][key] != ref_.cpu().numpy()).sum())
        print(f"world 2's ring graph before exploring: {key} differs from "
              f"world 1's in {diff} entries", flush=True)
        check(diff == 0, f"world 2's {key} differs from world 1's")
    for key, ref_ in (("idx", res1.knn_idx), ("dist", res1.knn_dist),
                      ("w", res1.weights)):
        diff = int((r[0][key] != ref_.cpu().numpy()).sum())
        check(diff == 0, f"world 2's {key} differs from world 1's in "
              f"{diff} entries")
    E = r[0]["marg"].shape[0]
    m_err = float(np.abs(r[0]["marg"] - world1["marg"]).max()) * E
    check(m_err <= MARGINAL_TOL, f"world 2's edge marginals are "
          f"{m_err} of a slot from world 1's (> {MARGINAL_TOL})")
    acc = float(r[0]["acc"])
    gs = r[0]["graph_s"]
    print(f"world 2 over gloo, two processes on one card ({wall:.1f} s "
          f"with their start): ring graph and weights bitwise world 1's "
          f"(ids, distances, weights); edge marginals within "
          f"{m_err:.3e} of a slot of world 1's (limit {MARGINAL_TOL}); "
          f"knn_s {gs[0]:.3f} = ring {gs[1]:.3f} + explore {gs[2]:.3f}, "
          f"weights_s {gs[3]:.3f}, topk_sqdist launches a rank "
          f"{int(r[0]['graph_topk'])}, peak memory a rank "
          f"{int(r[0]['peak']) / 2**30:.2f} GiB; local SGD at "
          f"{DIST_CUT_SPN} samples per node, sync every {cfg.sync_every} "
          f"step(s): sampler_s "
          f"{float(r[0]['sampler_s']):.3f}, layout_s "
          f"{float(r[0]['layout_s']):.3f} ({int(r[0]['layout_steps'])} "
          f"steps a rank, the replicas bitwise equal; one sync of y, "
          f"DataMesh.all_reduce_sum over gloo, {float(r[0]['sync_ms']):.3f}"
          f" ms), knn_classifier_accuracy {acc:.4f}", flush=True)
    flat, flat_counts = _counted(torch, lambda: layout_graph(
        res1.knn_idx, res1.weights, cfg=dataclasses.replace(
            cfg, samples_per_node=DIST_CUT_SPN), device="cuda")[0])
    acc_flat = metrics.knn_classifier_accuracy(flat.y, labels)
    print(f"world 1 at the same cut: layout of world 1's graph at "
          f"{DIST_CUT_SPN} samples per node ({flat.steps} steps of "
          f"{cfg.batch_size}, no sync), knn_classifier_accuracy "
          f"{acc_flat:.4f}, against world 2's {acc:.4f}", flush=True)
    check(int(r[0]["graph_topk"]) == 2, "the world-2 ring made "
          f"{int(r[0]['graph_topk'])} topk_sqdist launches a rank, not 2")
    check(acc >= 0.95, f"world 2 local-SGD accuracy {acc} < 0.95")
    for i in (0, 1):
        check(int(r[i]["degraded"]) == 1, f"rank {i} saw "
              f"{int(r[i]['degraded'])} DegradedModeWarnings, not 1")
        check(bool(r[i]["fault_finite"]), "the degraded fit is not finite")
        check(bool(r[i]["killed"]), "the world-2 layout was not killed")
    print(f"shard fault: knn_ring_step:1 at world 2 -> one "
          f"DegradedModeWarning on each rank ({r[0]['degraded_msg']}), "
          f"the fit completed on one shard and was handed to the other "
          f"rank: knn_classifier_accuracy {float(r[0]['fault_acc']):.4f} "
          f"on {DIST_SMALL_N} points", flush=True)
    check(float(r[0]["fault_acc"]) >= 0.95, "the degraded fit's accuracy "
          f"{float(r[0]['fault_acc'])} < 0.95")
    # the world-2 layout checkpoint resumed here, at world 1
    mesh = make_data_mesh(0, device="cuda")
    check(mesh.size == 1, "the resume runs at world 1")
    ckpt = dataclasses.replace(
        cfg, samples_per_node=DIST_CUT_SPN,
        checkpoint=CheckpointConfig(str(Path(tmp.name) / "ckpt"),
                                    every_chunks=100))
    sidx = torch.from_numpy(r[0]["small_idx"]).cuda()
    sw = torch.from_numpy(r[0]["small_w"]).cuda()
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        res, _ = layout_graph(sidx, sw, cfg=ckpt, device="cuda")
    topo = [m for m in log if issubclass(m.category, TopologyChangeWarning)]
    acc_r = metrics.knn_classifier_accuracy(res.y, small[1])
    print(f"elastic resume: a layout checkpoint written at world 2 "
          f"(killed after its second save) resumed at world 1 with "
          f"{len(topo)} TopologyChangeWarning ({topo[0].message if topo else ''}"
          f"); {res.steps} steps run here, knn_classifier_accuracy "
          f"{acc_r:.4f}", flush=True)
    check(len(topo) == 1, f"{len(topo)} TopologyChangeWarnings, not 1")
    check(bool(torch.isfinite(res.y).all()), "the resumed layout")
    tmp.cleanup()
    return _add_counts({"fused_edge_step": int(r[0]["layout_fused"])
                        + int(r[1]["layout_fused"]),
                        "topk_sqdist": 2 * int(r[0]["graph_topk"])},
                       flat_counts)


def run_distributed(torch, x, xn, labels, cfg):
    """Both distributed phases; returns their launches by kernel."""
    from repro_torch.core import sampler
    from repro_torch.launch.mesh import make_data_mesh

    dcfg = dataclasses.replace(cfg, distributed=True)
    res, acc, counts, peak = run_distributed_fit(torch, x, labels, dcfg)
    mesh = make_data_mesh(0, device="cuda")
    es, _ = sampler.build_samplers_sharded(res.knn_idx, res.weights,
                                           power=cfg.neg_power, mesh=mesh)
    from repro_torch.core.knn_sharded import build_knn_graph_sharded
    ring = build_knn_graph_sharded(
        x, dataclasses.replace(dcfg, n_explore_iters=0), mesh=mesh,
        generator=torch.Generator(device="cuda").manual_seed(cfg.seed))
    world1 = {"res": res, "marg": sampler.edge_marginals(es), "ring": ring}
    small = (xn[:DIST_SMALL_N], labels[:DIST_SMALL_N])
    more = run_world2(torch, xn, labels, dcfg, world1, small)
    return _add_counts(counts, more)


def _drop_package() -> None:
    for name in [n for n in sys.modules
                 if n == "repro_torch" or n.startswith("repro_torch.")]:
        del sys.modules[name]


def load_package(src: Path) -> dict:
    """Import the ``repro_torch`` under ``src``, every module of it, and
    return its ``sys.modules`` entries (left active)."""
    import importlib
    import pkgutil

    _drop_package()
    sys.path.insert(0, str(src))
    try:
        pkg = importlib.import_module("repro_torch")
        for info in pkgutil.walk_packages(pkg.__path__, "repro_torch."):
            importlib.import_module(info.name)
    finally:
        sys.path.remove(str(src))
    return {n: m for n, m in sys.modules.items()
            if n == "repro_torch" or n.startswith("repro_torch.")}


def activate(mods: dict) -> None:
    """Make one loaded package the ``repro_torch`` that imports find."""
    _drop_package()
    sys.modules.update(mods)


def bench_turn(torch, x, xq, spn: int) -> dict:
    """One turn of the active package: the fit (``layout_s``),
    ``transform`` of the held-out queries twice (a package that keeps the
    projection's graph replays it from the second call on, in the next
    turn of the same package too), PARENT_STEPS fused and split
    SGD steps on the fit's samplers (host ms, device ms and device
    launches a step), one tree's window fold and the queries' top-k,
    ``pairwise_sqdist`` at the metrics' two shapes (time and output), and
    10 profiled replays of the fused and the split 100-step graphs
    (device ms and device events a step)."""
    from repro_torch import LargeVis, LargeVisConfig, largevis
    from repro_torch.core import knn, layout_engine
    from repro_torch.kernels import knn_topk, ref

    cfg = LargeVisConfig(samples_per_node=spn)
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = largevis(x, cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    out["layout_s"] = res.timings["layout_s"]
    out["knn_s"] = res.timings["knn_s"]
    model = LargeVis(cfg, device="cuda")
    model.result_ = res
    for key in ("transform_s", "transform_again_s"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.transform(xq)
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
    kw = _step_kw(res, cfg)
    for route in ("fused", "split"):
        y = res.y.clone()
        gen = torch.Generator(device=y.device).manual_seed(21)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(PARENT_STEPS):
            y = layout_engine.sgd_edge_step(y, gen, t / PARENT_STEPS,
                                            layout_step=route, **kw)
        torch.cuda.synchronize()
        out[f"{route}_host_ms"] = ((time.perf_counter() - t0)
                                   / PARENT_STEPS * 1e3)
        prof = profile_steps(torch, res, cfg, route, 50)
        out[f"{route}_device_ms"] = sum(t for t, _ in prof.events.values()
                                        ) / prof.n
        out[f"{route}_launches"] = sum(c for _, c in prof.events.values()
                                       ) / prof.n
        out[f"{route}_all_seen"] = kernels_seen(prof)[1]
        out[f"{route}_kernels"] = kernels_seen(prof)[0]
    N, d = x.shape
    k, W = cfg.n_neighbors, cfg.window
    depth = knn._auto_depth(N, cfg.leaf_target)
    codes = knn.hash_codes(x, 2, depth, generator=torch.Generator(
        device=x.device).manual_seed(7))
    run_i = torch.full((N, k), -1, dtype=torch.int32, device=x.device)
    run_d = torch.full((N, k), ref.INVALID_DIST, device=x.device)
    run_i, run_d = knn._window_fold_one_tree(x, codes[:, 0], k, W, run_i,
                                             run_d)
    a, b, fkw, _ = knn.window_fold_args(x, codes[:, 1], k, W, run_i, run_d)
    out["fold_kernel_ms"] = time_ms(
        torch, lambda: knn_topk.topk_sqdist(a, b, k, **fkw))

    def whole_fold():
        a2, b2, kw2, _ = knn.window_fold_args(x, codes[:, 1], k, W, run_i,
                                              run_d)
        return knn_topk.topk_sqdist(a2, b2, k, **kw2)
    out["fold_whole_ms"] = time_ms(torch, whole_fold)
    out["queries_ms"] = time_ms(torch, lambda: knn_topk.topk_sqdist(
        xq[None], x[None], k), reps=3, warmup=1)
    for name, (a, b) in pairwise_shapes(torch, x).items():
        out[f"pairwise_{name}_ms"] = time_ms(
            torch, lambda: knn_topk.pairwise_sqdist(a, b))
        out[f"pairwise_{name}"] = knn_topk.pairwise_sqdist(a, b)
    H = cfg.steps_per_dispatch
    for route in ("fused", "split"):
        prof = profile_replays(torch, res, cfg, route, H)
        out[f"{route}_graph_device_ms"] = sum(
            t for t, _ in prof.events.values()) / (prof.n * H)
        out[f"{route}_graph_events"] = sum(
            c for _, c in prof.events.values()) / (prof.n * H)
        out[f"{route}_graph_all_seen"] = kernels_seen(prof)[1]
    out["y"] = res.y.cpu()
    return out


def run_parent(torch, parent: Path, spn: int) -> None:
    """Time a parent checkout's package and this one in turns, parent,
    change, change, parent, in one process on one card (``bench_turn``),
    and print each turn and the means."""
    import numpy as np

    src = parent / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"--parent {parent}: no src/repro_torch there")
    pkgs = {"parent": load_package(src), "change": load_package(ROOT / "src")}
    for name, mods in pkgs.items():
        activate(mods)
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build("knn_topk", "largevis_step", "largevis_grad")
        print(f"{name}: kernels built in {time.perf_counter() - t0:.2f} s "
              f"({mods['repro_torch'].__file__})", flush=True)
    from repro_torch.core.largevis import resolve_device
    from repro_torch.data.synthetic import gaussian_mixture
    dev = resolve_device("cuda")
    x = torch.from_numpy(gaussian_mixture(0, N_POINTS, DIM, CLUSTERS)[0]
                         ).to(dev)
    xq = torch.from_numpy(held_out(N_TRANSFORM, seed=1)[0]).to(dev)
    turns = []
    for name in ("parent", "change", "change", "parent"):
        activate(pkgs[name])
        r = bench_turn(torch, x, xq, spn)
        turns.append((name, r))
        print(f"turn {len(turns)} ({name}): " + ", ".join(
            f"{key} {val:.4f}" if isinstance(val, float) else f"{key} {val}"
            for key, val in r.items() if not torch.is_tensor(val)),
            flush=True)
    for key in ("pairwise_recall", "pairwise_accuracy"):
        outs = [r[key] for _, r in turns]
        diff = [int((o != outs[0]).sum()) for o in outs[1:]]
        print(f"{key.replace('_', ' ')}: the four turns' outputs differ "
              f"from the first turn's (the parent's) in {diff} entries",
              flush=True)
        check(not any(diff), f"{key}: the parent's and the change's "
              "kernels differ")
        for _, r in turns:
            del r[key]
    same = {n: torch.equal(*(r["y"] for m, r in turns if m == n))
            for n in ("parent", "change")}
    print(f"the parent's two fits' layouts bitwise equal: {same['parent']}; "
          f"the change's: {same['change']}; parent and change: "
          f"{torch.equal(turns[0][1]['y'], turns[1][1]['y'])}", flush=True)
    check(same["change"], "the change's two fits from one seed differ")
    for key in turns[0][1]:
        if key == "y" or not isinstance(turns[0][1][key], float):
            continue
        mean = {n: float(np.mean([r[key] for m, r in turns if m == n]))
                for n in ("parent", "change")}
        print(f"  {key}: parent {mean['parent']:.4f}, change "
              f"{mean['change']:.4f}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples-per-node", type=int,
                    default=PAPER_SAMPLES_PER_NODE)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit: time its "
                    "package and this one in turns, and nothing else")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail("src/repro_torch is missing: run from a checkout of the "
             "repository")
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if args.parent is not None:
        print(nvidia_smi(), flush=True)
        run_parent(torch, args.parent.resolve(), args.samples_per_node)
        print(nvidia_smi())
        return
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import LargeVisConfig
    from repro_torch.core.largevis import resolve_device
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels import _build
    from repro_torch.runtime.fault_tolerance import (DegradedModeWarning,
                                                     DivergenceWarning)

    # a fit that quietly demoted or rolled back fails the run; the two
    # phases that provoke them record their own (run_robust_fit)
    warnings.simplefilter("error", DegradedModeWarning)
    warnings.simplefilter("error", DivergenceWarning)

    # the tuner reads the committed table and no user cache
    tune_cache = tempfile.TemporaryDirectory()
    os.environ["REPRO_AUTOTUNE_CACHE"] = tune_cache.name

    smi = nvidia_smi()
    print(smi, flush=True)
    dev = resolve_device("cuda")           # also switches TF32 off
    t0 = time.perf_counter()
    reports = _build.build("knn_topk", "largevis_step", "largevis_grad",
                           "flash_attention", "flash_attention_bwd")
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(sorted(reports)) or 'cached'})", flush=True)
    for name, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    cfg = LargeVisConfig(samples_per_node=args.samples_per_node)
    if args.samples_per_node != PAPER_SAMPLES_PER_NODE:
        print(f"cut: samples_per_node {PAPER_SAMPLES_PER_NODE} -> "
              f"{args.samples_per_node} (the fit's layout; the split "
              f"layout's own cut is printed with it)", flush=True)
    xn, labels = gaussian_mixture(0, N_POINTS, DIM, CLUSTERS)
    x = torch.from_numpy(xn).to(dev)
    kernels = [check_topk(torch, x, cfg),
               check_edge_step(torch, N_POINTS, cfg),
               check_pairwise(torch, x)]
    res, acc_fit, counts = run_fit(torch, x, labels, cfg)
    for rec in kernels:
        rec["launches"] = counts[rec["name"]]
    check_samplers(torch, res, cfg)
    run_second_fit(torch, x, res, cfg)
    robust, demoted = run_robust_fit(torch, x, res, labels, acc_fit, cfg)
    for rec in kernels:
        rec["launches"] += robust[rec["name"]]
    replays = check_chunked(torch, res, cfg)
    grads = check_split_kernels(torch, cfg)
    layout_busy(res, replays, run_routes(torch, res, cfg),
                H=cfg.steps_per_dispatch)
    grads["launches"] = (run_split_layout(torch, res, labels,
                                          cfg)["largevis_grads"]
                         + robust["largevis_grads"]
                         + demoted["largevis_grads"])
    kernels.append(grads)
    run_autodiff(torch, res, cfg)
    acc_tr = run_transform(torch, res, labels, acc_fit, cfg)
    run_projection_server(torch, res, labels, acc_tr, cfg)
    paths = _add_counts({}, run_tree_fit(torch, x, labels, res, acc_fit,
                                         cfg))
    _add_counts(paths, run_autotuner(torch, x, res, cfg))
    base = run_baselines(torch, x, labels, res, acc_fit, cfg)
    _add_counts(paths, base)
    for rec in kernels:
        rec["launches"] += paths[rec["name"]]
    # LINE's gradient scatter is the ordered-scatter launch of
    # csrc/largevis_step.cu, fused_edge_step's source
    next(rec for rec in kernels if rec["name"] == "fused_edge_step")[
        "launches"] += base["scatter_add_ordered"]
    run_insert(torch, res, cfg)          # grows res: the last on the fit
    check_ring_fold(torch, x, cfg)
    torch.cuda.empty_cache()             # room for the world-2 ranks
    dist_counts = run_distributed(torch, x, xn, labels, cfg)
    for rec in kernels:
        rec["launches"] += dist_counts.get(rec["name"], 0)
    acc_auto, y_auto = run_fixture(torch)
    acc_split, y_split = run_fixture(torch, "split")
    check(torch.equal(y_auto, y_split),
          "the fused and split fixture fits differ")
    print(f"fixture: fused {acc_auto:.4f}, split {acc_split:.4f}: the two "
          f"fits' layouts bitwise equal", flush=True)

    # the LM phases hold large models: release the fit's state first
    del res, x, xn, labels, y_auto, y_split
    free_card(torch)
    t0 = time.perf_counter()
    flash = check_flash(torch)
    print(f"flash checks: {time.perf_counter() - t0:.1f} s", flush=True)
    free_card(torch)
    import numpy as np
    long = [LONG_PROMPT] * N_LONG + \
        np.random.default_rng(0).integers(16, 513, N_SHORT).tolist()
    from repro_torch.configs import get_config
    eng, flash["launches"] = run_serve(torch, get_config(LM_ARCH), long,
                                       SERVE_MAX_LEN)
    time_prefill(torch, eng.params, eng.cfg)
    del eng
    check_decode_matches_prefill(torch)
    flash["launches"] += run_gemma3(torch)
    flash["launches"] += run_mixtral(torch)
    flash["launches"] += run_jamba(torch)
    flash["launches"] += run_xlstm(torch)
    flash["launches"] += run_whisper(torch)
    bwd, train_counts = run_training(torch)
    flash["launches"] += train_counts["flash_attention"]
    kernels += [flash, bwd]

    import torch.distributed as dist
    dist.destroy_process_group()         # the distributed fit's world of one

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in kernels]}))
    tune_cache.cleanup()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
