"""LargeVis default hyper-parameters — the paper's own configuration (§4.3).

The same fields, names and defaults as the JAX package's config:
perplexity 50, K=150 neighbors, M=5 negatives, gamma=7, rho0=1.0,
f(x) = 1/(1+x^2), T proportional to N.  ``dtype`` is a torch dtype here.
``checkpoint`` (:class:`CheckpointConfig`: stage checkpoints and a
bitwise resume) and ``health`` (:class:`HealthConfig`: the layout's
divergence guard and rollback) behave as in the JAX package.

``distributed`` runs every stage on the data mesh of ``data_shards``
ranks of a ``torch.distributed`` process group (0 = all of them; a world
of one when there is no group), with the local-SGD layout syncing every
``sync_every`` steps (``core/largevis.py``).

Not carried over: the deprecated flat routing aliases (``knn_impl``,
``sampler_impl``, ``fused_step``, ``knn_distributed``; the last one's
``routing.knn_stage`` is honoured).  Kernels are routed by tensor device
(see ``kernels/ops.py``); the ``RoutingConfig`` fields are kept so
configs read the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Stage-checkpointed crash recovery for ``largevis()`` / ``fit()``.

    When set on ``LargeVisConfig.checkpoint``, every stage boundary of the
    pipeline — the KNN graph, the calibrated and symmetrized weights, the
    alias samplers, and the layout ``(y, generator state, step)`` every
    ``every_chunks`` dispatches — is written atomically (write, rename,
    then commit; ``checkpoint/checkpointer.py``) under ``directory``.  A
    killed fit rerun with the same ``(x, cfg)`` on the same device
    resumes from the last committed stage or chunk and gives a
    **bitwise-identical** embedding (``tests/test_torch_resume.py``); a
    fingerprint of the data, the generators and the config refuses a
    directory written by another run, with a warning, and starts fresh.
    """
    directory: str
    # layout save cadence, in steps_per_dispatch chunks: a crash replays
    # at most every_chunks * steps_per_dispatch steps
    every_chunks: int = 4
    keep: int = 2             # keep-last-k layout checkpoints
    resume: bool = True       # False: checkpoint but never auto-resume


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Numerical-health guard + divergence rollback for the layout stage.

    When set on ``LargeVisConfig.health``, every ``check_every_chunks``
    dispatches a probe reduces the embedding to (non-finite count, max
    |coordinate|).  A non-finite entry or a coordinate beyond ``max_abs``
    is a divergence: ``run_layout`` rolls the layout (y and its generator)
    back to the last healthy chunk, scales the learning rate by
    ``lr_backoff``, and reruns from there (one ``DivergenceWarning``).
    More than ``max_rollbacks`` rollbacks raises ``LayoutDivergedError``.
    The probe syncs the device once a check, so runs with ``health=None``
    keep the replays queued.
    """
    check_every_chunks: int = 1
    max_abs: float = 1e6          # embedding-norm blowup bound
    lr_backoff: float = 0.5       # rho0 multiplier per rollback
    max_rollbacks: int = 3


@dataclasses.dataclass(frozen=True)
class RoutingConfig:
    """Implementation routing knobs (same names as the JAX package).

    The port honours ``layout_step`` ("auto" and "fused" run the fused
    edge-step kernel for ``prob_fn="inv_quadratic"``; "split", and any
    other ``prob_fn``, run the gather / forces / ordered-scatter path),
    ``knn_stage`` (under ``distributed``: "auto" and "ring" build the
    graph on the ring, "forest" keeps the single-device forest for that
    stage) and ``autotune`` ("auto" leaves the mode to the ``AUTOTUNE``
    variable, default "cache"; "off", "cache" or "sweep" pins it for the
    process: ``runtime/autotune.py``), and ignores the rest: kernels are
    chosen by the device of the tensors.
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
    rp_mode: str = "hash"           # "hash" | "tree" (the paper's RP tree)
    perplexity: float = 50.0        # u in Eqn (1)
    perplexity_iters: int = 64      # bisection steps for sigma_i
    # --- distributed pipeline (core/knn_sharded.py, launch/mesh.py) ---
    distributed: bool = False       # every stage on the data mesh
    data_shards: int = 0            # ranks in the data mesh (0 = all)
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
    steps_per_dispatch: int = 100   # SGD steps a dispatch (CUDA graph)
    sync_every: int = 1             # H: local-SGD sync period
    init_scale: float = 1e-4        # initial layout ~ N(0, init_scale)
    neg_power: float = 0.75         # P_n(j) ∝ d_j^0.75
    # --- out-of-sample transform / insert ---
    transform_steps: int = 48
    transform_rho0: float = 0.0
    # --- robustness (crash recovery + numerical health) ---
    checkpoint: Optional[CheckpointConfig] = None   # None: no persistence
    health: Optional[HealthConfig] = None           # None: no per-chunk sync
    # --- implementation routing ---
    routing: RoutingConfig = dataclasses.field(default_factory=RoutingConfig)
    dtype: Any = torch.float32
    seed: int = 0

