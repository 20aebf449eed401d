"""The SGD edge step of the layout (paper §3.2) and its dispatch unit.

``sgd_edge_step`` samples a batch of edges and negatives from the alias
samplers, sets the t/T learning rate and applies the batch through
``apply_edge_batch``, which routes it as the JAX package does:

* the fused route — one edge-step kernel gathers, computes the forces and
  scatters (``kernels/largevis_step.py``) — for ``layout_step`` "auto" or
  "fused" with the hand-derived ``prob_fn="inv_quadratic"``;
* the split route otherwise: the update stream of the batch, then the
  ordered scatter (``ops.scatter_add_ordered``).  For ``inv_quadratic``
  the indexed force kernel reads y at the batch's rows and writes the
  stream in one launch (``ops.largevis_grads_stream``); any other
  ``prob_fn`` gathers with torch indexing, takes autograd's forces
  (``core/objective.py``) and builds the stream
  (``ref.edge_update_stream``).

Both routes add the updates in the canonical per-edge order, so for
``inv_quadratic`` they agree bitwise, on the CPU and on the card.

:class:`StepChunks` is the counterpart of the JAX package's jitted
``layout_chunk`` (a ``lax.scan`` of H steps a device dispatch): on the
card, H consecutive steps captured once into a CUDA graph and replayed;
on the CPU the same H steps run one after another.  The learning rate
is a device value (:func:`lr_table`), so a captured step reads it
instead of freezing a host float.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from repro_torch.core import objective
from repro_torch.kernels import ops, ref

LAYOUT_STEPS = ("auto", "fused", "split")


def dispatch_steps(requested: int, *, n_nodes: int, batch: int,
                   backend: str | None = None) -> int:
    """Steps per dispatch: ``requested`` (``cfg.steps_per_dispatch``)
    wins when set; 0 asks the tuner's ``layout_chunk`` cell (cache or
    committed table only, no sweep).  Chunking is results-neutral: a
    chunk replays the loop's steps bitwise.  Returns 0, and the callers
    run the per-step loop, when neither picks."""
    if requested:
        return int(requested)
    from repro_torch.runtime import autotune
    return int(autotune.get("layout_chunk", dict(n=n_nodes, b=batch),
                            autotune.legacy_default("layout_chunk"),
                            backend=backend)["steps"])


def chunk_schedule(steps: int, H: int) -> list:
    """(first step, length) of each dispatch: full chunks of H, then the
    remainder."""
    return [(t0, min(H, steps - t0)) for t0 in range(0, steps, H)]


def apply_edge_batch(y, i, j, negs, neg_mask, lr, *,
                     prob_fn: str = "inv_quadratic", a: float = 1.0,
                     gamma: float = 7.0, clip: float = 5.0,
                     layout_step: str = "auto", n_frozen: int = 0):
    """Apply one pre-sampled edge batch to the (N, s) embedding in place.

    ``lr`` is a float, a 0-d f32 tensor on y's device (what a captured
    step reads) or a (B,) per-edge tensor.  Duplicate rows
    accumulate in the canonical per-edge order ``[i_e, j_e,
    negs_e,0..M-1]``.  Rows below ``n_frozen`` never change (the
    frozen-corpus transform).  Returns ``y``.
    """
    if layout_step not in LAYOUT_STEPS:
        raise ValueError(f"layout_step={layout_step!r}: expected one of "
                         f"{LAYOUT_STEPS}")
    if layout_step != "split" and prob_fn == "inv_quadratic":
        return ops.largevis_edge_step(y, i, j, negs, neg_mask, lr,
                                      gamma=gamma, a=a, clip=clip,
                                      n_frozen=n_frozen)
    if prob_fn == "inv_quadratic":
        idx, upd = ops.largevis_grads_stream(y, i, j, negs, neg_mask, lr,
                                             n_frozen, gamma=gamma, a=a,
                                             clip=clip)
    else:
        i, j, negs = i.long(), j.long(), negs.long()
        gi, gj, gneg = objective.grads_autodiff(
            y[i], y[j], y[negs], neg_mask, prob_fn=prob_fn, a=a, gamma=gamma,
            clip=clip)
        idx, upd = ref.edge_update_stream(i, j, negs, gi, gj, gneg, lr,
                                          n_frozen)
    return ops.scatter_add_ordered(y, idx, upd)


def step_lr(rho0: float, t_frac: float) -> float:
    """rho_t = rho0 * max(1 - t/T, 1e-4), in f32 as the JAX step has it."""
    f32 = np.float32
    return float(f32(rho0) * max(f32(1.0) - f32(t_frac), f32(1e-4)))


def lr_table(rho0: float, steps: int, device) -> torch.Tensor:
    """(steps,) f32 on ``device``: entry t is ``step_lr(rho0, t / steps)``
    bitwise (t/steps in f64, rounded to f32, then the same f32
    operations)."""
    f32 = np.float32
    t_frac = (np.arange(steps, dtype=np.float64) / steps).astype(f32)
    lr = f32(rho0) * np.maximum(f32(1.0) - t_frac, f32(1e-4))
    return torch.from_numpy(lr).to(device)


def sgd_edge_step(y, generator, t_frac: float | None = None, *,
                  edge_sampler, neg_sampler, n_negatives: int,
                  prob_fn: str = "inv_quadratic", a: float = 1.0,
                  gamma: float = 7.0, clip: float = 5.0, rho0: float = 1.0,
                  batch: int = 4096, layout_step: str = "auto", lr=None):
    """One SGD step over a freshly sampled edge batch; t_frac = t/T sets
    the lr ``step_lr(rho0, t_frac)``, or ``lr`` (a 0-d f32 tensor on y's
    device, an entry of :func:`lr_table`) gives it.  The batch is drawn
    before it is routed, so every route sees the same batch from the same
    generator."""
    i, j = edge_sampler.sample(generator, batch)
    negs = neg_sampler.sample(generator, (batch, n_negatives))
    # a negative that is the source or the target of its edge is masked
    neg_mask = ((negs != i[:, None]) & (negs != j[:, None])).float()
    if lr is None:
        lr = step_lr(rho0, t_frac)
    return apply_edge_batch(y, i, j, negs, neg_mask, lr, prob_fn=prob_fn,
                            a=a, gamma=gamma, clip=clip,
                            layout_step=layout_step)


class StepChunks:
    """Consecutive steps ``step(y, generator, lr=lr)`` of one trajectory,
    H a dispatch, each updating the static ``y`` in place.

    :meth:`run` takes the lrs of the next chunk (a slice of an
    :func:`lr_table`) and the trajectory's generator.  On the CPU it runs
    the steps one after another.  On the card the first chunk runs
    eagerly on a side stream: it is the warm-up of PyTorch's graph recipe
    (the launchers' scratch, the cooperative launch's occupancy query),
    and its steps are real ones.  Every later chunk replays the CUDA
    graph of its length, captured at its first use: the steps read the
    static ``y``, an lr buffer refreshed before each replay, and a
    generator of the unit's own, registered with the graph, whose Philox
    state is set from the trajectory's before each replay and handed
    back after it, so a replay draws what the eager steps would.  The
    kernels' launch counts grow by the capture's launches at each replay
    (``ops.capture_launches``).  A capture or a replay that fails raises.
    """

    def __init__(self, step, y: torch.Tensor, H: int):
        self.step, self.y, self.H = step, y, int(H)
        self._warm = False
        self._graphs: dict = {}          # chunk length -> (graph, launches)
        if y.device.type == "cuda":
            self._lr = torch.empty(self.H, dtype=torch.float32,
                                   device=y.device)
            self._gen = torch.Generator(device=y.device)

    def run_all(self, generator, lrs: torch.Tensor) -> int:
        """Run ``len(lrs)`` steps, H a dispatch (the remainder last);
        returns the dispatches."""
        schedule = chunk_schedule(lrs.shape[0], self.H)
        for t0, h in schedule:
            self.run(generator, lrs[t0:t0 + h])
        return len(schedule)

    def run(self, generator, lrs: torch.Tensor) -> None:
        """Run ``len(lrs)`` (at most H) steps with these lrs."""
        h = lrs.shape[0]
        if not 0 < h <= self.H:
            raise ValueError(f"a chunk of {h} steps in a unit of {self.H}")

        def steps(gen, lr):
            for k in range(h):
                self.step(self.y, gen, lr=lr[k])

        if self.y.device.type != "cuda":
            steps(generator, lrs)
            return
        if not self._warm:
            warm_up(lambda: steps(generator, lrs), self.y.device)
            self._warm = True
            return
        if h not in self._graphs:
            self._graphs[h] = capture(lambda: steps(self._gen, self._lr),
                                      self._gen)
        self._lr[:h].copy_(lrs)
        replay(*self._graphs[h], self._gen, generator)


def warm_up(fn, device) -> None:
    """Run ``fn()`` on a side stream, as PyTorch's graph recipe warms up
    before a capture: the launchers' scratch and the cooperative launch's
    occupancy query happen here, so a capture allocates only in its own
    pool."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn()
    main.wait_stream(side)


def capture(fn, generator: torch.Generator):
    """``fn()`` captured into a CUDA graph with ``generator`` registered,
    so the graph's draws advance that generator's Philox state.  Returns
    ``(graph, launches)``, the launches its wrappers counted in the
    capture (``ops.capture_launches``); :func:`replay` runs it."""
    graph = torch.cuda.CUDAGraph()
    register = getattr(graph, "register_generator_state", None)
    if register is None:
        raise RuntimeError(
            f"torch {torch.__version__}: CUDAGraph has no "
            "register_generator_state, so a captured step cannot draw from "
            "its generator")
    register(generator)

    def record():
        # thread-local: the checkpoint writer's thread copies snapshots to
        # the host on a stream of its own while a chunk may be captured; in
        # the default global mode that copy would invalidate the capture.
        # Python's collector stays off while capturing (torch.cuda.graph
        # collects just before it begins): a collection inside could free
        # an earlier unit's graph, whose destructor resets it, a call the
        # capturing thread may not make
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                fn()
        finally:
            if collecting:
                gc.enable()

    return graph, ops.capture_launches(record)


def replay(graph, launches: dict, own: torch.Generator,
           generator: torch.Generator) -> None:
    """Replay a graph from :func:`capture` (``own`` its registered
    generator) as a step drawing from ``generator``: ``own`` takes
    ``generator``'s Philox state before the replay and hands it back
    after, so the replay draws what the eager step would; the kernels'
    launch counts grow by the capture's."""
    own.set_state(generator.get_state())
    graph.replay()
    generator.set_state(own.get_state())
    ops.add_launches(launches)
