"""LargeVis on PyTorch: data matrix in, 2-D/3-D layout out.

    from repro_torch import largevis
    result = largevis(x, device="cuda")   # x: (N, d) array or tensor
    coords = result.y                      # (N, 2) tensor on the device

The pipeline is the paper's two stages, on one device: (1) the
approximate KNN graph (projection forest + neighbor exploring) and its
perplexity-calibrated weights, (2) the alias samplers and the
edge-sampling SGD layout.  Each stage is timed after
``torch.cuda.synchronize()``, so the timings split the work honestly.

The entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, the plain versions of the kernels); without CUDA and
without that request they raise.  Randomness comes from
``torch.Generator``s on the device: the graph stage's seeded with
``cfg.seed``, the layout's with ``cfg.seed + 1``.  TF32 is switched off
for matrix products and convolutions: a TF32 product in ``hash_codes``
flips code bits.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.largevis_default import LargeVisConfig
from repro_torch.core import knn as knn_lib
from repro_torch.core import layout as layout_lib
from repro_torch.core import perplexity as perp_lib
from repro_torch.core import sampler as sampler_lib


@dataclasses.dataclass
class LargeVisResult:
    """Fitted-model carrier: embedding, graph, weights, samplers."""
    y: torch.Tensor                # (N, s) layout
    knn_idx: torch.Tensor          # (N, K) int32
    knn_dist: torch.Tensor         # (N, K) squared distances
    weights: torch.Tensor          # (N, K) symmetrized edge weights
    timings: dict
    edge_samples: int
    x: torch.Tensor | None = None  # (N, d) corpus points
    edge_sampler: sampler_lib.EdgeSampler | None = None
    neg_sampler: sampler_lib.NodeSampler | None = None
    cfg: LargeVisConfig | None = None


def resolve_device(device) -> torch.device:
    """The device to run on; "cuda" (the default) raises without CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "the plain versions of the kernels on the CPU")
    if dev.type == "cuda":
        # full f32 products: TF32 flips hash-code bits near the hyperplanes
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def as_tensor(v, device, dtype=None) -> torch.Tensor:
    """``v`` (array or tensor) on ``device``; numpy input is copied, so a
    read-only array never backs a tensor."""
    if not torch.is_tensor(v):
        v = torch.from_numpy(np.array(v))
    return v.to(device=device, dtype=dtype)


def seeded_generator(device, seed: int) -> torch.Generator:
    """A torch.Generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_graph(x, *, cfg: LargeVisConfig | None = None, device="cuda",
                generator: torch.Generator | None = None, proj=None):
    """Stage 1: KNN graph + calibrated weights.

    Returns (idx, dist, weights, {"knn_s", "weights_s"}).  ``proj``
    (d, n_trees*depth) fixes the forest's hyperplanes."""
    cfg = cfg if cfg is not None else LargeVisConfig()
    dev = resolve_device(device)
    x = as_tensor(x, dev, torch.float32)
    if proj is not None:
        proj = as_tensor(proj, dev, torch.float32)
    if generator is None:
        generator = seeded_generator(dev, cfg.seed)
    _sync(dev)
    t0 = time.perf_counter()
    idx, dist = knn_lib.build_knn_graph(x, cfg, generator=generator,
                                        proj=proj)
    _sync(dev)
    t1 = time.perf_counter()
    w = perp_lib.edge_weights(idx, dist, cfg.perplexity,
                              iters=cfg.perplexity_iters)
    _sync(dev)
    t2 = time.perf_counter()
    return idx, dist, w, {"knn_s": t1 - t0, "weights_s": t2 - t1}


def layout_graph(knn_idx, weights, *, cfg: LargeVisConfig | None = None,
                 device="cuda", generator: torch.Generator | None = None,
                 return_samplers: bool = False):
    """Stage 2: alias samplers + SGD layout of a weighted KNN graph.

    Returns (LayoutResult, timings), or (LayoutResult, (edge_sampler,
    neg_sampler), timings) with ``return_samplers``."""
    cfg = cfg if cfg is not None else LargeVisConfig()
    dev = resolve_device(device)
    knn_idx = as_tensor(knn_idx, dev)
    weights = as_tensor(weights, dev, torch.float32)
    if generator is None:
        generator = seeded_generator(dev, cfg.seed + 1)
    _sync(dev)
    t0 = time.perf_counter()
    edge_s = sampler_lib.build_edge_sampler(knn_idx, weights)
    neg_s = sampler_lib.build_negative_sampler(knn_idx, weights,
                                               power=cfg.neg_power)
    _sync(dev)
    t1 = time.perf_counter()
    res = layout_lib.run_layout(generator, edge_s, neg_s, knn_idx.shape[0],
                                cfg, device=dev)
    _sync(dev)
    t2 = time.perf_counter()
    timings = {"sampler_s": t1 - t0, "layout_s": t2 - t1}
    if return_samplers:
        return res, (edge_s, neg_s), timings
    return res, timings


def largevis(x, *, cfg: LargeVisConfig | None = None, device="cuda",
             proj=None) -> LargeVisResult:
    """Run the full pipeline on one device; see the module docstring."""
    cfg = cfg if cfg is not None else LargeVisConfig()
    dev = resolve_device(device)
    x = as_tensor(x, dev, torch.float32)
    idx, dist, w, t_graph = build_graph(x, cfg=cfg, device=dev, proj=proj)
    res, (edge_s, neg_s), t_layout = layout_graph(
        idx, w, cfg=cfg, device=dev, return_samplers=True)
    return LargeVisResult(y=res.y, knn_idx=idx, knn_dist=dist, weights=w,
                          timings={**t_graph, **t_layout},
                          edge_samples=res.edge_samples, x=x,
                          edge_sampler=edge_s, neg_sampler=neg_s, cfg=cfg)
