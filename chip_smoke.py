#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit.  It imports nothing of JAX or of the JAX package.  In order:

1. the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, in parallel) and prints the build time;
3. holds each kernel of the fit against its plain PyTorch version at the
   shapes the main path gives it, and times the kernel, the plain
   version, one PyTorch library call for the same function, and the
   least time the card could take (the larger of bytes over 3.35 TB/s
   and operations over 67 TFLOP/s f32, the H100 SXM data sheet's peaks);
4. runs the full-width fit (``LargeVisConfig()`` defaults: K=150, 8
   trees, window 64, perplexity 50) on a Gaussian mixture of N=100,000
   points in d=100, with every kernel's launch count reset just before
   and read just after, and checks the layout and the graph;
5. on the fit's graph, samplers and layout, the split path: the
   ``largevis_grads`` kernel and the ordered scatter against their plain
   versions; 50 fused and 50 split SGD steps from one state, bitwise
   equal; the split layout (at 2,000 samples per node, a printed cut);
   200 autograd steps of ``prob_fn="exp_quadratic"``;
6. ``LargeVis.transform`` of 10,000 held-out points of the fit's
   clusters, by the fused and by the split route, and
   ``LargeVis.insert`` of 2,000 more, each with its launch counts read;
7. runs the 2000-point quality fixture (accuracy >= 0.95), by the fused
   and by the split route;

then prints a JSON line of the kernel records and, last, the device line.
Any failed check exits with status 1 and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_PER_S = 67e12          # H100 SXM f32, outside the tensor cores
PAPER_SAMPLES_PER_NODE = 10_000
SPLIT_SAMPLES_PER_NODE = 2_000  # the split layout's cut (printed)
N_POINTS, DIM, CLUSTERS = 100_000, 100, 10   # the full-width fit's data
N_TRANSFORM, N_INSERT = 10_000, 2_000        # held-out points


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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def device_profile(torch, fn, n: int = 50):
    """``fn`` called n times under ``torch.profiler``: (host ms per call,
    {device event name: (device ms per call, events seen)}).  Only the
    card's own events (kernels, memsets, copies) count as device time;
    host wall time includes the profiler's own overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / n * 1e3
    dev = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        total = getattr(e, "self_device_time_total", None)
        if total is None:
            total = e.self_cuda_time_total
        dev[e.key] = (total / n / 1e3, e.count)
    return host, dev


def busy_line(host, dev, top: int = 3) -> str:
    """One printed summary of :func:`device_profile`."""
    total = sum(ms for ms, _ in dev.values())
    names = sorted(dev, key=lambda k: -dev[k][0])[:top]
    def short(key):
        key = key.replace("(anonymous namespace)::", "")
        return key.removeprefix("void ").split("(")[0][:48]
    tops = ", ".join(f"{short(k)} {dev[k][0]:.4f}" for k in names)
    return (f"host {host:.4f} ms, device {total:.4f} ms per call, busy "
            f"{total / host:.3f} (largest: {tops})")


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


def check_topk(torch, x, cfg):
    """One tree's window fold at the fit's shapes: all ceil(N/W) blocks of
    W rows against their 3W candidates, k = K, seeded with the state the
    previous tree left, with dedup; and one exact search at the kernel's
    largest k (256) with multi-tile dedup."""
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
    err, n_swaps, gap, tol = agree_topk(torch, a, b, x, got, want,
                                        "topk_sqdist")

    sub = x[None, :600].contiguous()
    ids = torch.arange(600, dtype=torch.int32, device=x.device)[None]
    kmax = knn_topk.MAX_K
    kw_max = dict(a_ids=ids, b_ids=ids, dedup=True, bn=128)
    _, swaps_max, _, _ = agree_topk(
        torch, sub, sub, sub[0],
        knn_topk.topk_sqdist(sub, sub, kmax, **kw_max),
        ref.topk_sqdist_ref(sub, sub, kmax, **kw_max),
        f"topk_sqdist (k={kmax})")
    G, M, _ = a.shape
    Nc = b.shape[1]
    # the fold's own work: the candidates are sorted x's blocks j-1..j+1,
    # so x (and its ids) is read once, not the wrapper's 3x gathered b
    n_bytes = 4 * (G * M * d + N * d + G * M + N
                   + 2 * G * M * k + 2 * G * M * k)
    n_ops = 2 * G * M * Nc * d + 2 * (G * M + N) * d
    bms, by = bound_ms(n_bytes, n_ops)
    ms = time_ms(torch, lambda: knn_topk.topk_sqdist(a, b, k, **kw))

    def whole_fold():
        a2, b2, kw2, _ = knn.window_fold_args(x, codes[:, 1], k, W, run_i,
                                              run_d)
        return knn_topk.topk_sqdist(a2, b2, k, **kw2)
    fold_ms = time_ms(torch, whole_fold)
    plain = time_ms(torch, lambda: ref.topk_sqdist_ref(a, b, k, **kw),
                    reps=3, warmup=1)
    lib = time_ms(torch, lambda: torch.cdist(a, b).topk(
        k, dim=-1, largest=False))
    print(f"topk_sqdist: (G={G}, M={M}, N={Nc}, d={d}, k={k}, init, dedup) "
          f"id slots differing from the plain version: {n_swaps} of "
          f"{got[0].numel()} (only ties allowed; largest gap {gap:.3g}), "
          f"max |dist err| {err:.3g} (tol {tol:.3g}); kernel {ms:.3f} ms, "
          f"plain {plain:.3f} ms, torch.cdist+topk {lib:.3f} ms, "
          f"bound {bms:.4f} ms ({by}); the tree's whole fold with the "
          f"wrapper's gather of b {fold_ms:.3f} ms; exact search at "
          f"k={kmax} (600 points, multi-tile dedup): {swaps_max} slot(s) "
          f"differ", flush=True)
    return dict(name="topk_sqdist", route="cuda",
                source="src/repro_torch/csrc/knn_topk.cu",
                replaces="src/repro/kernels/knn_topk.py:183",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


def check_edge_step(torch, n_nodes, cfg):
    """The fit's step shape — y (N, 2), B = 4096 edges, M = 5 — and one
    duplicate-dense batch on N = 64 rows; bitwise against the plain
    version run on a CPU copy (on CUDA its index_add_ is atomic)."""
    from repro_torch.kernels import largevis_step, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    B, Mn, s = cfg.batch_size, cfg.n_negatives, cfg.out_dim
    kw = dict(gamma=cfg.gamma, a=cfg.prob_a, clip=cfg.grad_clip)
    main, max_err = None, 0.0
    for N in (n_nodes, 64):
        y = torch.randn((N, s), generator=gen, device=dev) * 10.0
        i = torch.randint(0, N, (B,), generator=gen, device=dev,
                          dtype=torch.int32)
        j = torch.randint(0, N, (B,), generator=gen, device=dev,
                          dtype=torch.int32)
        negs = torch.randint(0, N, (B, Mn), generator=gen, device=dev,
                             dtype=torch.int32)
        mask = ((negs != i[:, None]) & (negs != j[:, None])).float()
        for lr, n_frozen in ((0.37, 0), (torch.rand(B, generator=gen,
                                                    device=dev), N // 3)):
            want = ref.fused_edge_step_ref(
                y.cpu(), i.cpu(), j.cpu(), negs.cpu(), mask.cpu(),
                lr.cpu() if torch.is_tensor(lr) else lr, n_frozen=n_frozen,
                **kw)
            got = largevis_step.fused_edge_step(
                y.clone(), i, j, negs, mask, lr, n_frozen=n_frozen,
                **kw).cpu()
            err = float((got - want).abs().max())
            check(torch.equal(got, want),
                  f"fused_edge_step: not bitwise at N={N} (max err {err})")
            max_err = max(max_err, err)
        if main is None:
            main = (y, i, j, negs, mask)
    y, i, j, negs, mask = main
    yk = y.clone()
    ms = time_ms(torch, lambda: largevis_step.fused_edge_step(
        yk, i, j, negs, mask, 0.37, **kw), reps=50)
    yp = y.clone()
    plain = time_ms(torch, lambda: ref.fused_edge_step_ref(
        yp, i, j, negs, mask, 0.37, **kw), reps=50)
    idx = torch.cat([i[:, None], j[:, None], negs], 1).reshape(-1).long()
    upd = torch.randn((idx.numel(), s), generator=gen, device=dev)
    yl = y.clone()
    lib = time_ms(torch, lambda: yl.index_add_(0, idx, upd), reps=50)
    rows = int(torch.unique(idx).numel())
    n_bytes = 4 * (2 * rows * s + 2 * B + 2 * B * Mn)
    n_ops = B * ((4 * s + 2) + Mn * (7 * s + 3) + 2 * (2 + Mn) * s)
    bms, by = bound_ms(n_bytes, n_ops)
    print(f"fused_edge_step: (N={n_nodes}, s={s}, B={B}, M={Mn}) bitwise "
          f"equal to the plain version, also at N=64 and with per-edge lr "
          f"and frozen rows; kernel {ms:.4f} ms, plain (atomic index_add_) "
          f"{plain:.4f} ms, index_add_ alone {lib:.4f} ms, bound "
          f"{bms:.5f} ms ({by})", flush=True)
    return dict(name="fused_edge_step", route="cuda",
                source="src/repro_torch/csrc/largevis_step.cu",
                replaces="src/repro/kernels/largevis_step.py:268",
                max_abs_err=max_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


def check_pairwise(torch, x):
    """graph_recall's shape: 2000 rows of x against all of x."""
    from repro_torch.kernels import knn_topk, ref

    rows = torch.randperm(x.shape[0], device=x.device)[:2000]
    a = x[rows].contiguous()
    got = knn_topk.pairwise_sqdist(a, x)
    want = ref.pairwise_sqdist_ref(a, x)
    an = (a.double() ** 2).sum(-1)
    bn = (x.double() ** 2).sum(-1)
    tol = 4e-6 * float(an.max() + bn.max())
    err = float((got - want).abs().max())
    check(err <= tol, f"pairwise_sqdist: error {err} > {tol}")
    small = x[:1000, :2].contiguous(), x[1000:, :2].contiguous()
    err2 = float((knn_topk.pairwise_sqdist(*small)
                  - ref.pairwise_sqdist_ref(*small)).abs().max())
    check(err2 <= 1e-3, f"pairwise_sqdist (d=2): error {err2}")
    M, d = a.shape
    N = x.shape[0]
    n_bytes = 4 * (M * d + N * d + M * N)
    n_ops = 2 * M * N * d + 2 * (M + N) * d + 3 * M * N
    bms, by = bound_ms(n_bytes, n_ops)
    ms = time_ms(torch, lambda: knn_topk.pairwise_sqdist(a, x))
    plain = time_ms(torch, lambda: ref.pairwise_sqdist_ref(a, x))
    lib = time_ms(torch, lambda: torch.cdist(a, x))
    print(f"pairwise_sqdist: ({M}, {d}) x ({N}, {d}) max |err| {err:.3g} "
          f"(tol {tol:.3g}), (1000, 2) x ({N - 1000}, 2) max |err| "
          f"{err2:.3g}; kernel {ms:.3f} ms, plain {plain:.3f} ms, "
          f"torch.cdist {lib:.3f} ms, bound {bms:.4f} ms ({by})", flush=True)
    return dict(name="pairwise_sqdist", route="cuda",
                source="src/repro_torch/csrc/knn_topk.cu",
                replaces="src/repro/kernels/knn_topk.py:65",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def check_split_kernels(torch, cfg):
    """The split route's kernels at its shapes: ``largevis_grads`` on rows
    of a scale-10 y (N = 100,000, s = 2) at B = 4096, 4095 and 37 with
    M = 5 negatives, about a tenth masked, and the ordered scatter of the
    B*(2+M) update rows, also on a duplicate-dense N = 64; each bitwise
    against its plain version run on a CPU copy (the reference: on CUDA
    the plain scatter's index_add_ is atomic)."""
    from repro_torch.kernels import largevis_grad, largevis_step, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    B, Mn, s = cfg.batch_size, cfg.n_negatives, cfg.out_dim
    kw = dict(gamma=cfg.gamma, a=cfg.prob_a, clip=cfg.grad_clip)
    y = torch.randn((N_POINTS, s), generator=gen, device=dev) * 10.0
    main, max_err, card_err = None, 0.0, 0.0
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
            check(torch.equal(g.cpu(), w), f"largevis_grads: not bitwise at "
                  f"B={b} (max err {err})")
            max_err = max(max_err, err)
            card_err = max(card_err, float((c - g).abs().max()))
        if main is None:
            main = args
    ms = time_ms(torch, lambda: largevis_grad.largevis_grads(*main, **kw),
                 reps=50)
    plain_ms = time_ms(torch, lambda: ref.largevis_grads_ref(
        *main[:3], neg_mask=main[3], **kw), reps=50)
    n_bytes = 4 * B * (4 * s + 2 * Mn * s + Mn)
    n_ops = B * ((4 * s + 2) + Mn * (7 * s + 3))
    bms, by = bound_ms(n_bytes, n_ops)
    _, dev_events = device_profile(
        torch, lambda: largevis_grad.largevis_grads(*main, **kw))
    kern = [(ms_, n) for k, (ms_, n) in dev_events.items()
            if "largevis_grads_kernel" in k]
    check(len(kern) == 1, f"largevis_grads: the profiler saw {len(kern)} "
          "kernels of that name")
    kern_ms = kern[0][0] * 50 / kern[0][1]      # per launch it saw

    scatter_ms = None
    for N in (N_POINTS, 64):
        idx = torch.randint(0, N, (B * (2 + Mn),), generator=gen, device=dev)
        upd = torch.randn((idx.numel(), s), generator=gen, device=dev)
        yb = torch.randn((N, s), generator=gen, device=dev)
        want = ref.scatter_add_ordered_ref(yb.cpu(), idx.cpu(), upd.cpu())
        got = largevis_step.scatter_add_ordered(yb.clone(), idx, upd).cpu()
        check(torch.equal(got, want), f"scatter_add_ordered: not bitwise at "
              f"N={N} (max err {float((got - want).abs().max())})")
        if scatter_ms is None:
            yk = yb.clone()
            scatter_ms = time_ms(torch, lambda: largevis_step
                                 .scatter_add_ordered(yk, idx, upd), reps=50)
    print(f"largevis_grads: (B={B}, M={Mn}, s={s}) bitwise equal to the "
          f"plain version on a CPU copy, also at B={B - 1} and B=37 with "
          f"masked negatives (the plain version on the card: max |err| "
          f"{card_err:.3g}); kernel {ms:.4f} ms a call (CUDA events over "
          f"back-to-back calls: the wrapper's host time), of which the "
          f"kernel's own device time {kern_ms:.5f} ms (profiler), plain "
          f"{plain_ms:.4f} ms, no single library call, bound {bms:.5f} ms "
          f"({by}); "
          f"scatter_add_ordered of {B * (2 + Mn)} rows bitwise equal to the "
          f"plain version, also on N=64: {scatter_ms:.4f} ms", flush=True)
    return dict(name="largevis_grads", route="cuda",
                source="src/repro_torch/csrc/largevis_grad.cu",
                replaces="src/repro/kernels/largevis_grad.py:55",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def run_fit(torch, x, labels, cfg):
    from repro_torch import largevis
    from repro_torch.core import metrics
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = largevis(x, cfg=cfg, device="cuda")
    fit_s = time.perf_counter() - t0
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
    for route in ("fused", "split"):
        y = res.y.clone()
        gen = torch.Generator(device=y.device).manual_seed(22)
        host, dev = device_profile(torch, lambda: layout_engine.sgd_edge_step(
            y, gen, 0.5, layout_step=route, **kw), n=steps)
        print(f"  profiled {route} step: {busy_line(host, dev)}",
              flush=True)


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
    print(f"split layout: samples_per_node={spn}, {lay.steps} steps, "
          f"layout_s {t['layout_s']:.3f} s ({t['layout_s'] / lay.steps * 1e3:.4f}"
          f" ms/step), sampler_s {t['sampler_s']:.3f} s; "
          f"knn_classifier_accuracy {acc:.4f}; launches {counts}",
          flush=True)
    check(bool(torch.isfinite(lay.y).all()), "split layout not finite")
    check(acc >= 0.8, f"split layout accuracy {acc} < 0.8")
    check(counts["largevis_grads"] > 0 and counts["scatter_add_ordered"] > 0,
          "the split layout did not launch largevis_grads and the ordered "
          "scatter")
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
    (default) and the split route; the carrier never changes."""
    from repro_torch import LargeVis, RoutingConfig
    from repro_torch.kernels import knn_topk, ops, ref

    dev = res.y.device
    xq_np, lq_np = held_out(N_TRANSFORM, seed=1)
    xq = torch.from_numpy(xq_np).to(dev)
    lq = torch.from_numpy(lq_np).to(dev)
    lab = torch.from_numpy(labels).to(dev)
    y_before = res.y.clone()
    out = {}
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
        out[route] = yq
    check(torch.equal(out["auto"], out["split"]),
          "the fused and split transforms differ")

    a = xq[None, :1000].contiguous()
    k = min(cfg.n_neighbors, N_POINTS)
    got = knn_topk.topk_sqdist(a, res.x[None], k)
    want = ref.topk_sqdist_ref(a, res.x[None], k)
    err, swaps, gap, tol = agree_topk(torch, a, res.x[None], res.x, got,
                                      want, "topk_sqdist (queries)")
    ms = time_ms(torch, lambda: knn_topk.topk_sqdist(xq[None], res.x[None],
                                                     k), reps=3, warmup=1)
    print(f"query_neighbors: topk_sqdist (G=1, M=1000, N={N_POINTS}, "
          f"d={DIM}, k={k}) {swaps} id slot(s) differ from the plain "
          f"version (only ties allowed; largest gap {gap:.3g}), max |dist "
          f"err| {err:.3g} (tol {tol:.3g}); all {N_TRANSFORM} queries "
          f"{ms:.3f} ms; the two transforms bitwise equal", flush=True)


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples-per-node", type=int,
                    default=PAPER_SAMPLES_PER_NODE)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail("src/repro_torch is missing: run from a checkout of the "
             "repository")
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import LargeVisConfig
    from repro_torch.core.largevis import resolve_device
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    print(smi, flush=True)
    dev = resolve_device("cuda")           # also switches TF32 off
    t0 = time.perf_counter()
    reports = _build.build("knn_topk", "largevis_step", "largevis_grad")
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
    grads = check_split_kernels(torch, cfg)
    run_routes(torch, res, cfg)
    grads["launches"] = run_split_layout(torch, res, labels,
                                         cfg)["largevis_grads"]
    kernels.append(grads)
    run_autodiff(torch, res, cfg)
    run_transform(torch, res, labels, acc_fit, cfg)
    run_insert(torch, res, cfg)
    run_fixture(torch)
    run_fixture(torch, "split")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
