"""LargeVis default hyper-parameters — the paper's own configuration (§4.3).

The same fields, names and defaults as the JAX package's config:
perplexity 50, K=150 neighbors, M=5 negatives, gamma=7, rho0=1.0,
f(x) = 1/(1+x^2), T proportional to N.  ``dtype`` is a torch dtype here.

Not carried over: the deprecated flat routing aliases (``knn_impl``,
``sampler_impl``, ``fused_step``, ``knn_distributed``) and the
``checkpoint``/``health`` behaviour, which the port does not have yet.
Routing in the port is by tensor device (see ``kernels/ops.py``); the
``RoutingConfig`` fields are kept so configs read the same in both
packages, and ``layout_step`` is checked by the layout engine.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class RoutingConfig:
    """Implementation routing knobs (same names as the JAX package).

    The port honours ``layout_step`` ("auto" and "fused" run the fused
    edge-step kernel for ``prob_fn="inv_quadratic"``; "split", and any
    other ``prob_fn``, run the gather / forces / ordered-scatter path) and
    ignores the rest: kernels are chosen by the device of the tensors.
    """
    knn: str = "auto"
    sampler: str = "auto"
    layout_step: str = "auto"
    knn_stage: str = "auto"
    autotune: str = "auto"


@dataclasses.dataclass(frozen=True)
class LargeVisConfig:
    # --- KNN graph construction (paper §3.1, Algo 1) ---
    n_neighbors: int = 150          # K
    n_trees: int = 8                # NT random projection "trees" (tables)
    n_explore_iters: int = 1        # Iter; paper: 1-3 suffices
    tree_depth: int = 0             # 0 -> auto from N and leaf target
    leaf_target: int = 64           # target points per bucket
    window: int = 64                # sorted-window candidate half-width
    explore_sample: int = 0         # 0 -> all K^2 + K candidates
    rp_mode: str = "hash"           # only "hash" is ported
    perplexity: float = 50.0        # u in Eqn (1)
    perplexity_iters: int = 64      # bisection steps for sigma_i
    # --- distributed pipeline (not ported; must stay False) ---
    distributed: bool = False
    data_shards: int = 0
    # --- layout (paper §3.2) ---
    out_dim: int = 2                # s
    n_negatives: int = 5            # M
    gamma: float = 7.0
    rho0: float = 1.0               # initial lr; rho_t = rho0 * (1 - t/T)
    samples_per_node: int = 10_000  # T = samples_per_node * N edge samples
    prob_fn: str = "inv_quadratic"  # f(x)=1/(1+a x^2); or "exp_quadratic"
    prob_a: float = 1.0
    grad_clip: float = 5.0          # reference-impl per-coordinate clip
    batch_size: int = 4096          # edge samples per SGD step
    steps_per_dispatch: int = 100   # read by the JAX scan engine only
    sync_every: int = 1             # local-SGD period (not ported)
    init_scale: float = 1e-4        # initial layout ~ N(0, init_scale)
    neg_power: float = 0.75         # P_n(j) ∝ d_j^0.75
    # --- out-of-sample transform / insert ---
    transform_steps: int = 48
    transform_rho0: float = 0.0
    # --- implementation routing ---
    routing: RoutingConfig = dataclasses.field(default_factory=RoutingConfig)
    dtype: Any = torch.float32
    seed: int = 0

