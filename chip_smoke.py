#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit.  It imports nothing of JAX or of the JAX package.  In order:

1. the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, in parallel) and prints the build time;
3. holds each kernel against its plain PyTorch version at the shapes the
   main path gives it, and times the kernel, the plain version, one
   PyTorch library call for the same function, and the least time the
   card could take (the larger of bytes over 3.35 TB/s and operations
   over 67 TFLOP/s f32, the H100 SXM data sheet's peaks);
4. runs the full-width fit (``LargeVisConfig()`` defaults: K=150, 8
   trees, window 64, perplexity 50) on a Gaussian mixture of N=100,000
   points in d=100, with every kernel's launch count reset just before
   and read just after, and checks the layout and the graph;
5. runs the 2000-point quality fixture (accuracy >= 0.95);

then prints a JSON line of the kernel records and, last, the device line.
Any failed check exits with status 1 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_PER_S = 67e12          # H100 SXM f32, outside the tensor cores
PAPER_SAMPLES_PER_NODE = 10_000
N_POINTS, DIM = 100_000, 100    # the full-width fit's data


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
    main = None
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
                max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bms,
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
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the main path")
    return counts


def run_fixture(torch):
    """The 2000-point quality fixture of the JAX package's engine test."""
    from repro_torch import LargeVisConfig, largevis
    from repro_torch.core import metrics
    from repro_torch.data.synthetic import gaussian_mixture

    x, labels = gaussian_mixture(0, 2000, 32, 8)
    cfg = LargeVisConfig(n_neighbors=15, n_trees=4, n_explore_iters=2,
                         window=32, perplexity=10.0, samples_per_node=2000,
                         batch_size=4096)
    res = largevis(x, cfg=cfg, device="cuda")
    acc = metrics.knn_classifier_accuracy(res.y, labels)
    print(f"fixture: N=2000 d=32, knn_classifier_accuracy {acc:.4f} "
          f"(bar 0.95), {sum(res.timings.values()):.2f} s", flush=True)
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
    reports = _build.build("knn_topk", "largevis_step")
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(sorted(reports)) or 'cached'})", flush=True)
    for name, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    cfg = LargeVisConfig(samples_per_node=args.samples_per_node)
    if args.samples_per_node != PAPER_SAMPLES_PER_NODE:
        print(f"cut: samples_per_node {PAPER_SAMPLES_PER_NODE} -> "
              f"{args.samples_per_node} (nothing else is cut)", flush=True)
    xn, labels = gaussian_mixture(0, N_POINTS, DIM, 10)
    x = torch.from_numpy(xn).to(dev)

    kernels = [check_topk(torch, x, cfg),
               check_edge_step(torch, N_POINTS, cfg),
               check_pairwise(torch, x)]
    counts = run_fit(torch, x, labels, cfg)
    for rec in kernels:
        rec["launches"] = counts[rec["name"]]
    run_fixture(torch)

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
