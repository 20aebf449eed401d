"""The train and serving steps — the JAX package's ``launch/steps.py``
(``pick_microbatches``, ``make_train_step``, ``make_prefill_step``,
``make_decode_step``, ``make_step``).

JAX builds one jitted step over a ``(data, model)`` mesh, its parameters,
moments and batch laid out by ``runtime/sharding.py``.  The port runs the
step eagerly on each rank of a ``DataMesh`` (SPMD, one process a rank),
or on the parameters' device alone when ``mesh`` is None.  On a mesh a
rank holds its blocks of the parameters, the gradients and both moments
by JAX's training rules (``sharding.train_specs``: FSDP over ``"data"``,
heads, ff and vocab over ``"model"``), and a step:

1. takes its data row's contiguous block of the batch's rows (JAX's
   batch sharding over ``"data"``; the ranks of a row take the same
   rows), so data row r's rows are what one device's microbatch r of D
   would be;
2. runs its microbatches in order through the sharded loss
   (``make_model(cfg, mesh=)["loss"]``: each period's leaves gathered
   over ``"data"`` just before it and dropped after, the blocks
   tensor-parallel over ``"model"``); each gather's backward
   reduce-scatters the leaves' gradients over ``"data"`` in rank order
   as the backward reaches them, and autograd adds them into the rank's
   f32 gradient blocks in microbatch order;
3. adds the data rows' losses in rank order and divides the losses and
   the gradients by the total microbatch count, a tensor;
4. runs AdamW on its blocks (``optim/adamw.py``; the gradient norm
   summed over both axes in a fixed order).

Nothing whole is gathered after the step.  So a step over D data rows
with one microbatch each gives the bits of one device's step over D
microbatches at ``model`` = 1 (the norm's order does not depend on the
mesh), and within f32 rounding at ``model`` > 1.  Whole leaves are
gathered only for a save or a record (``convert.train_state_to_numpy(
..., mesh=)``, ``sharding.gather_tree``).

The serving steps run on every rank of a ``(data, model)`` mesh, each on
its blocks: the weights by ``params_shardings(train=False)``, the batch
by ``batch_shardings`` (a decode cache by ``_cache_pspec``), the outputs
in the layouts of ``_out_tree_shardings``; ``sharding.block`` and
``sharding.assemble`` go between whole tensors and blocks, and
:func:`decode_cache` hands a prefill's cache to the decode step.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.launch.mesh import elapsed_ms
from repro_torch.models.attention import kv_tp_repeat
from repro_torch.models.factory import init_cache, make_model, param_shapes
from repro_torch.models.lm import check_mesh
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.runtime import sharding as sh

# the collectives a train step times (``train_step.sync_ms``)
SYNC_KINDS = ("data_gather", "grad_reduce_scatter", "grad_all_reduce",
              "model_sum", "model_exchange", "grad_norm")


def _data_size(mesh) -> int:
    """The data axis's ranks (a mesh without a model axis: its size)."""
    return mesh.size // getattr(mesh, "model", 1)


def pick_microbatches(shape_cfg, *, mesh=None,
                      tokens_budget: int = 8192) -> int:
    """The largest divisor of the per-rank batch (``global_batch`` over
    the mesh's data axis, the whole batch without a mesh) that brings a
    microbatch's tokens under budget (activation memory is one
    microbatch's; gradients accumulate in f32 across microbatches)."""
    dp_size = 1 if mesh is None else _data_size(mesh)
    per_dev_batch = max(1, shape_cfg.global_batch // dp_size)
    target = max(1, per_dev_batch * shape_cfg.seq_len // tokens_budget)
    n = 1
    for cand in range(1, per_dev_batch + 1):
        if per_dev_batch % cand == 0 and cand <= target:
            n = cand
    return n


def _split(batch: dict, n: int, i: int) -> dict:
    """Microbatch ``i`` of ``n``: rows [i B/n, (i+1) B/n) of every leaf,
    JAX's reshape to (n, B/n, ...)."""
    out = {}
    for name, t in batch.items():
        if t.shape[0] % n:
            raise ValueError(f"make_train_step: batch leaf {name!r} has "
                             f"{t.shape[0]} rows, not a multiple of {n} "
                             "microbatches")
        b = t.shape[0] // n
        out[name] = t[i * b:(i + 1) * b]
    return out


def rank_rows(batch: dict, mesh) -> dict:
    """The rank's data row's block of every batch leaf's rows, by the
    batch's partition specs over the DP axes; raises where a leaf's rows
    do not divide over the data axis (JAX would replicate such a batch on
    every device)."""
    rows = {t.shape[0] for t in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"make_train_step: batch leaves of {sorted(rows)} "
                         "rows")
    B = rows.pop()
    D = mesh.shape["data"]
    specs = sh.batch_shardings(batch, mesh.shape, global_batch=B)
    for name, spec in specs.items():
        if D > 1 and sh.data_dim(spec) != 0:
            raise ValueError(f"make_train_step: batch leaf {name!r} of {B} "
                             f"rows does not divide over the mesh's {D} "
                             "data ranks")
    return _split(batch, D, mesh.axis_index("data"))


def make_train_step(cfg, shape_cfg, *, mesh=None,
                    opt_cfg: AdamWConfig = None, microbatches: int = 0):
    """The step ``train_step(params, opt_state, batch) -> (params,
    opt_state, loss)``: the mean loss and gradients over ``microbatches``
    microbatches a rank (0: :func:`pick_microbatches`), added in
    microbatch order and divided by their count, then one AdamW step, as
    JAX's step.  It turns the parameters' gradients on, updates them and
    the moments in place (``adamw_update``) and returns a 0-d f32 loss.
    One body serves every mesh and none: without a mesh it takes every
    row and gathers nothing.

    With a ``mesh`` (a ``DataMesh``, any ``(data, model)`` shape the
    config's heads divide, ``lm.check_mesh``), ``batch`` is the global
    batch, which every rank holds; ``params`` and ``opt_state`` hold the
    rank's training blocks (``init_lm(..., train=True)`` or
    ``convert.lm_params_from_numpy(..., train=True)``; ``adamw_init``);
    the loss is the global mean, the same bits on every rank.
    ``train_step.sync_ms()`` gives the last step's collectives by kind
    (:data:`SYNC_KINDS`: the ``"data"`` gathers, the gradients'
    reduce-scatters and all-reduces over ``"data"``, the ``"model"``
    sums, the ``"model"`` exchanges and gathers of the recurrent blocks
    and the gradient norm's), timed by CUDA events on the card, so
    the step itself never waits for the card."""
    opt_cfg = opt_cfg or AdamWConfig()
    if mesh is not None:
        if not mesh.in_mesh:
            raise ValueError("make_train_step: this rank is outside the "
                             "mesh")
        check_mesh(cfg, mesh)
    loss_fn = make_model(cfg, mesh=mesh)["loss"]
    n_micro = microbatches or pick_microbatches(shape_cfg, mesh=mesh)
    D = 1 if mesh is None else mesh.shape["data"]
    clock = {}

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        plist = list(params.parameters())
        dev = plist[0].device
        if mesh is not None:
            mesh.clock = {}
        local = batch if mesh is None else rank_rows(batch, mesh)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for p in plist:
            p.grad = None
        for i in range(n_micro):
            loss_i = loss_fn(params, _split(local, n_micro, i))
            loss_i.backward()
            lsum = lsum + loss_i.detach()
        denom = torch.tensor(float(n_micro * D), dtype=torch.float32,
                             device=dev)
        specs = None
        if mesh is not None:
            with mesh.timed("grad_all_reduce"):
                lsum = mesh.all_reduce_sum(lsum, "data")
            table = sh.train_specs(cfg, mesh.shape)
            specs = [table[n][1] for n, _ in params.named_parameters()]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in plist]
        for p, g in zip(plist, grads):
            p.grad = None
            g.div_(denom)
        _, opt_state, _ = adamw_update(opt_cfg, params, grads, opt_state,
                                       mesh=mesh, specs=specs)
        del grads
        if mesh is not None:
            clock.clear()
            clock.update(mesh.clock)
            mesh.clock = None
        return params, opt_state, lsum / denom

    def sync_ms() -> dict:
        """ms of the last step's collectives by kind (0 where none ran),
        read when asked: CUDA events on the card; ``grad_all_reduce``
        includes the loss's sum."""
        return {k: sum(elapsed_ms(a, b) for a, b in clock.get(k, ()))
                for k in SYNC_KINDS}

    train_step.microbatches = n_micro
    train_step.sync_ms = sync_ms
    return train_step


# ---------------------------------------------------------------------------
# The sharded serving steps
# ---------------------------------------------------------------------------

def _out_tree_shardings(out, sizes, *, global_batch: int):
    """JAX's rule-based layouts of a (logits, cache) output tree (shapes,
    tensors or arrays as leaves): a scalar replicated; 2-D logits wider
    than 1,024 over ``(dp, "model")``; cache leaves by their names
    (``sharding._cache_pspec``); anything else over the DP axes along a
    row axis of the global batch."""
    dp = sh.dp_axes(sizes)
    batch_first = sh.covers_dp(sizes, global_batch)
    cache_ends = ("/k", "/v", "/ssm", "/conv", "/C", "/n", "/m", "/c", "/h")

    def one(s, shape):
        if len(shape) == 0:
            return ()
        if len(shape) == 2 and shape[-1] > 1024:          # logits (B, V)
            return sh._guard(sizes, shape,
                             [dp if batch_first else None, "model"])
        if s.endswith("encoder_out") or s.endswith("_scale") or \
                any(s.endswith(t) for t in cache_ends):
            return sh._cache_pspec(s, shape, sizes, batch_first)
        spec = [dp if batch_first and shape[0] == global_batch else None]
        return sh._guard(sizes, shape, spec + [None] * (len(shape) - 1))

    return sh._walk(out, one)


def _serve_batch(cfg, shape_cfg, *, kv_repeat: int = 1,
                 kv_quant: bool = False) -> dict:
    """The global batch's leaves of a prefill or decode cell on the meta
    device, JAX's ``input_specs``: tokens (B, S) or (B, 1) with the
    filled cache of ``seq_len`` and the positions (B,); the
    encoder-decoder's frames (B, F, d)."""
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    meta = torch.device("meta")
    if shape_cfg.kind == "prefill":
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                       device=meta)}
    else:
        batch = {"tokens": torch.empty((B, 1), dtype=torch.int32,
                                       device=meta),
                 "cache": init_cache(cfg, B, S, meta, kv_repeat=kv_repeat,
                                     kv_quant=kv_quant),
                 "position": torch.empty((B,), dtype=torch.int32,
                                         device=meta)}
    if cfg.is_encoder_decoder:
        batch["encoder_frames"] = torch.empty(
            (B, cfg.enc_positions, cfg.d_model), dtype=cfg.dtype,
            device=meta)
    return batch


def _serving_step(cfg, mesh, shape_cfg, kv_quant: bool):
    """The rank's prefill or decode step and its layouts."""
    sizes = mesh.shape
    kv_rep = kv_tp_repeat(cfg, sizes["model"])
    B = shape_cfg.global_batch
    batch_first = sh.covers_dp(sizes, B)
    model = make_model(cfg, kv_repeat=kv_rep, kv_quant=kv_quant, mesh=mesh)
    batch = _serve_batch(cfg, shape_cfg, kv_repeat=kv_rep,
                         kv_quant=kv_quant)
    p_layout = sh.params_shardings(param_shapes(cfg), cfg, sizes,
                                   train=False)
    b_layout = sh.batch_shardings(batch, sizes, global_batch=B)
    if shape_cfg.kind == "prefill":
        cache = init_cache(cfg, B, shape_cfg.seq_len, "meta",
                           kv_repeat=kv_rep)
    else:
        cache = batch["cache"]
    out_shapes = (torch.empty((B, cfg.vocab_size), device="meta"), cache)
    out_layout = _out_tree_shardings(out_shapes, sizes, global_batch=B)
    whole_logits = out_layout[0][-1] is None

    def finish(logits, cache):
        # logits in their layout: a vocab shard gathered where it is whole
        if whole_logits and logits.shape[-1] < cfg.vocab_size:
            logits = mesh.all_gather(logits, "model", dim=-1)
        return logits, cache

    if shape_cfg.kind == "prefill":
        def step(params, batch):
            frames = (batch["encoder_frames"],) if cfg.is_encoder_decoder \
                else ()
            return finish(*model["prefill"](params, batch["tokens"],
                                            *frames,
                                            seq_parallel=not batch_first))
    else:
        def step(params, batch):
            kw = {} if batch_first else {"sp_len": shape_cfg.seq_len}
            return finish(*model["decode"](params, batch["tokens"],
                                           batch["cache"], batch["position"],
                                           **kw))
    return step, batch, (p_layout, b_layout), out_layout


def make_prefill_step(cfg, mesh, shape_cfg):
    """JAX's ``make_prefill_step``: ``(prefill_step, batch, (param
    layout, batch layout), out layout)``.  ``prefill_step(params,
    batch)`` takes the rank's blocks (``batch``: ``tokens``, and the
    encoder-decoder's ``encoder_frames``) and returns the rank's blocks
    of ``(logits, cache)``; the cache holds the KV heads repeated by
    ``kv_tp_repeat(cfg, model)``, as JAX's.  ``batch`` holds the global
    batch's leaves on the meta device; the layouts are {name: spec} trees:
    the parameters' by the port's parameter names."""
    return _serving_step(cfg, mesh, shape_cfg, False)


def make_decode_step(cfg, mesh, shape_cfg, *, kv_quant: bool = False):
    """JAX's ``make_decode_step``, as :func:`make_prefill_step`: the batch
    is ``tokens`` (B, 1), the filled ``cache`` of ``seq_len`` slots
    (int8 under ``kv_quant``) and ``position`` (B,); a batch that does not
    cover ``"data"`` decodes sequence-parallel."""
    return _serving_step(cfg, mesh, shape_cfg, kv_quant)


def decode_cache(cfg, mesh, shape_cfg, cache, layout, *,
                 kv_quant: bool = False) -> dict:
    """A prefill's cache handed to the decode step of ``shape_cfg`` (its
    global batch, ``seq_len`` slots): the rank's blocks of
    ``init_cache(..., mesh=)`` holding the prefill's ``cache`` (the rank's
    blocks in ``layout``, the prefill's out layout of the cache), each
    position-indexed leaf grown with zero slots (a local layer's ring of W
    slots stays as it is).  A leaf whose sequence is whole on the rank in
    both layouts is copied in place; one whose blocks move as the slot
    count changes (the sequence-parallel layout, its sequence over
    ``"data"``) is gathered whole, grown and cut again: a collective,
    which every rank of the mesh calls."""
    B, T = shape_cfg.global_batch, shape_cfg.seq_len
    kw = {"kv_repeat": kv_tp_repeat(cfg, mesh.shape["model"]),
          "kv_quant": kv_quant}
    leaf = cache
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    out = init_cache(cfg, B, T, leaf.device, mesh=mesh, **kw)
    whole = init_cache(cfg, B, T, "meta", **kw)
    specs = sh.batch_shardings({"cache": whole}, mesh.shape,
                               global_batch=B)["cache"]

    def fill(dst, src, src_spec, spec, meta):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], src[k], src_spec[k], spec[k], meta[k])
            return
        if tuple(src_spec) == tuple(spec) and (src.shape == dst.shape or
                                               spec[2] is None):
            dst[:, :, :src.shape[2]].copy_(src)
            return
        grown = torch.zeros(meta.shape, dtype=src.dtype, device=src.device)
        part = sh.gather(mesh, src, src_spec)
        grown[:, :, :part.shape[2]] = part
        dst.copy_(sh.block(grown, spec, mesh))

    fill(out, cache, layout, specs, whole)
    return out


def make_step(cfg, mesh, shape_cfg):
    """The step of ``shape_cfg.kind``: the sharded trainer
    (tensor-parallel at ``model`` > 1 for all ten architectures; query
    heads and mLSTM/sLSTM heads that do not divide it, and a mamba inner
    width that does not, whole on every rank), the prefill or decode step
    otherwise."""
    if shape_cfg.kind == "train":
        return make_train_step(cfg, shape_cfg, mesh=mesh)
    if shape_cfg.kind == "prefill":
        return make_prefill_step(cfg, mesh, shape_cfg)
    return make_decode_step(cfg, mesh, shape_cfg)


# ---------------------------------------------------------------------------
# The LargeVis layout steps: the paper technique's own production cells
# ---------------------------------------------------------------------------
#
# Each builder returns JAX's 4-tuple in the port's form, ``(step,
# arg_specs, in_blocks, out_blocks)``: ``arg_specs`` the whole arguments
# as tensors on the meta device (JAX's ShapeDtypeStructs), ``in_blocks``
# and ``out_blocks`` each argument's and the result's per-rank block
# shape under JAX's shardings.  ``step`` runs on a rank of ``mesh`` (a
# ``DataMesh``, or the dry run's recording mesh) on the rank's blocks,
# updates ``y`` in place and returns it: on the card through the
# ``fused_edge_step`` kernel (the fused route), on the CPU its plain
# version.  ``seed`` (1,) and ``t_frac`` () are JAX's: the rank's stream
# and one lr for the call's steps; ``generator=`` (advanced in place) and
# ``lrs=`` (the call's per-step lrs) give them explicitly, as a fit's
# round has them.

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _dp_size(mesh) -> int:
    return mesh.shape["data"]


def _lrs(t_frac, steps: int, rho0: float, dev) -> torch.Tensor:
    """(steps,) f32: JAX's one lr of ``t_frac`` for every step."""
    from repro_torch.core.layout_engine import step_lr

    lr = step_lr(rho0, 0.0 if t_frac.device.type == "meta"
                 else float(t_frac))
    return torch.full((steps,), lr, dtype=torch.float32, device=dev)


def _round_builder(mesh, n_nodes: int, b_loc: int, n_negatives: int,
                   sync_every: int, fused_step: bool, rho0: float):
    """The body of the local-SGD builders: ``run(y, seed, t_frac,
    edge_sampler, neg_sampler, generator, lrs)``, one round of
    ``core/layout.py::local_sgd_round`` (H steps of ``sgd_edge_step`` on
    the rank's replica, one ``StepChunks`` dispatch, then the rank-order
    sum of the replicas' moves over ``"data"``).  The unit is kept across
    calls on the same tensors, so the card captures a round's graph once
    and replays it; the first call's first dispatch takes the fused
    route's demotion (``run_layout``'s contract)."""
    from repro_torch.core import layout, layout_engine

    units: dict = {}
    layout_step = "fused" if fused_step else "split"

    def run(y, seed, t_frac, es, ns, generator, lrs):
        dev = y.device
        if generator is None and dev.type != "meta":
            generator = layout._rank_generator(
                dev, int(seed.reshape(-1)[0]), mesh.axis_index("data"))
        if lrs is None:
            lrs = _lrs(t_frac, sync_every, rho0, dev)
        key = (y.data_ptr(), es.src.data_ptr(), ns.threshold.data_ptr())
        step = layout.round_step(es, ns, n_negatives=n_negatives,
                                 batch=b_loc, layout_step=layout_step)
        first = key not in units
        if first:
            units.clear()
            units[key] = (layout_engine.StepChunks(step, y, sync_every),
                          torch.empty_like(y))
        unit, y0 = units[key]
        split = (functools.partial(step, layout_step="split")
                 if first and fused_step and dev.type != "meta" else None)
        units[key] = (layout.local_sgd_round(unit, y0, mesh, generator,
                                             lrs, split_step=split), y0)
        return y

    return run


def make_largevis_step_local(mesh, *, n_nodes: int, n_edges: int,
                             batch: int, out_dim: int = 2,
                             n_negatives: int = 5, sync_every: int = 8,
                             fused_step: bool = True, rho0: float = 1.0):
    """Per-shard edge sampling and local SGD: one call is one round of
    ``run_layout_local_sgd`` (``core/layout.py::local_sgd_round``, shared
    with the fit), ``sync_every`` steps of ``batch / D`` edges on the
    rank's replica of y from its block of the edge tables, then ``y0 +
    sum_r (y_r - y0)`` over ``"data"`` (D ranks).

    The edge tables are cut over ``"data"`` in D contiguous blocks; each
    block must be an alias table of its own edges (its alias entries local
    indices), as a ``ShardedEdgeSampler``'s rows flattened are: a block of
    one flat table built over all edges would point outside itself (JAX's
    builder leaves those pointers dangling).  The negative tables are
    whole on every rank.  Wire format (JAX's): y (N, s) f32, seed (1,)
    i32, t_frac () f32, edge src/dst/thr/alias (E,), neg thr/alias (N,).
    A rank's stream is ``layout._rank_generator(seed, data rank)``."""
    from repro_torch.core.sampler import EdgeSampler, NodeSampler

    D = _dp_size(mesh)
    b_loc = max(1, batch // D)
    f32, i32 = torch.float32, torch.int32
    sizes = mesh.shape
    arg_specs = (_meta((n_nodes, out_dim), f32), _meta((1,), i32),
                 _meta((), f32), _meta((n_edges,), i32),
                 _meta((n_edges,), i32), _meta((n_edges,), f32),
                 _meta((n_edges,), i32), _meta((n_nodes,), f32),
                 _meta((n_nodes,), i32))
    table = sh.block_shape((n_edges,), sh._guard(sizes, (n_edges,),
                                                 [sh.dp_axes(sizes)]), sizes)
    in_blocks = tuple(tuple(a.shape) for a in arg_specs[:3]) + \
        (table,) * 4 + ((n_nodes,),) * 2
    run = _round_builder(mesh, n_nodes, b_loc, n_negatives, sync_every,
                         fused_step, rho0)

    def step(y, seed, t_frac, edge_src, edge_dst, edge_thr, edge_alias,
             neg_thr, neg_alias, *, generator=None, lrs=None):
        es = EdgeSampler(edge_src, edge_dst, edge_thr, edge_alias,
                         int(edge_src.shape[0]))
        ns = NodeSampler(neg_thr, neg_alias, n_nodes)
        return run(y, seed, t_frac, es, ns, generator, lrs)

    return step, arg_specs, in_blocks, (n_nodes, out_dim)


def make_largevis_step_sharded(mesh, *, n_nodes: int, n_edges: int,
                               batch: int, out_dim: int = 2,
                               n_negatives: int = 5, sync_every: int = 8,
                               fused_step: bool = True, rho0: float = 1.0):
    """Local SGD over the per-shard tables ``sampler.
    build_samplers_sharded`` gives: the stacked (D, E_loc) edge tables,
    whose alias entries are local indices, cut over ``"data"`` by rows
    (a rank's block (1, E_loc) is a table of its own edges, the reference
    implementation's per-thread sampling range), and the negatives drawn
    globally through the two-level ``ShardedNodeSampler`` (its stacked
    (D, n_loc) tables and (D,) shard tables whole on every rank), P_n(j)
    ∝ deg(j)^0.75 over all nodes.  One call is one round, as
    :func:`make_largevis_step_local`'s.  Raises as JAX's builder does:
    ``n_edges`` not a multiple of D, or fewer nodes than ranks."""
    from repro_torch.core.sampler import EdgeSampler, ShardedNodeSampler

    D = _dp_size(mesh)
    if n_edges % D:
        raise ValueError(f"n_edges={n_edges} not a multiple of the DP "
                         f"size {D} (pad rows first)")
    if n_nodes < D:
        raise ValueError(f"n_nodes={n_nodes} < DP size {D}: rows cannot "
                         "cover the mesh one block per device")
    e_loc = n_edges // D
    n_loc = -(-n_nodes // D)
    b_loc = max(1, batch // D)
    f32, i32 = torch.float32, torch.int32
    sizes = mesh.shape
    arg_specs = (_meta((n_nodes, out_dim), f32), _meta((1,), i32),
                 _meta((), f32), _meta((D, e_loc), i32),
                 _meta((D, e_loc), i32), _meta((D, e_loc), f32),
                 _meta((D, e_loc), i32), _meta((D, n_loc), f32),
                 _meta((D, n_loc), i32), _meta((D,), f32), _meta((D,), i32))
    table = sh.block_shape((D, e_loc), sh._guard(
        sizes, (D, e_loc), [sh.dp_axes(sizes), None]), sizes)
    in_blocks = tuple(tuple(a.shape) for a in arg_specs[:3]) + \
        (table,) * 4 + tuple(tuple(a.shape) for a in arg_specs[7:])
    run = _round_builder(mesh, n_nodes, b_loc, n_negatives, sync_every,
                         fused_step, rho0)

    def step(y, seed, t_frac, edge_src, edge_dst, edge_thr, edge_alias,
             neg_thr, neg_alias, neg_sthr, neg_sali, *, generator=None,
             lrs=None):
        es = EdgeSampler(edge_src[0], edge_dst[0], edge_thr[0],
                         edge_alias[0], e_loc)
        ns = ShardedNodeSampler(neg_thr, neg_alias, neg_sthr, neg_sali, D,
                                n_nodes)
        return run(y, seed, t_frac, es, ns, generator, lrs)

    return step, arg_specs, in_blocks, (n_nodes, out_dim)


class _BlockTables:
    """Alias tables cut over ``"data"`` in equal contiguous blocks (this
    rank's ``blocks``), drawn from globally: every rank draws the same
    indices over the whole table, reads the entries in its block (zeros
    elsewhere), and a rank-order sum over ``"data"`` of the entries' bits
    (int32, each added to zeros: exact) hands every rank the whole draw,
    the cross-shard gathers XLA inserts for JAX's sharded tables.  At
    one data rank the blocks are the tables and the draws
    ``sampler.sample_alias``'s, op for op."""

    def __init__(self, mesh, n: int, threshold, alias, *payload):
        self.mesh, self.n = mesh, n
        self.threshold, self.alias, self.payload = threshold, alias, payload

    def _read(self, idx, tables) -> list:
        mesh = self.mesh
        if mesh.shape["data"] == 1:
            return [t[idx] for t in tables]
        n_loc = tables[0].shape[0]
        loc = idx.long() - mesh.axis_index("data") * n_loc
        mine = (loc >= 0) & (loc < n_loc)
        loc = loc.clamp(0, n_loc - 1)
        bits = torch.stack([torch.where(
            mine, t[loc].view(torch.int32), 0) for t in tables])
        bits = mesh.all_reduce_sum(bits, "data")
        return [b.view(t.dtype) for b, t in zip(bits.unbind(0), tables)]

    def _draw(self, generator, shape):
        dev = self.threshold.device
        idx = torch.randint(0, self.n, shape, generator=generator,
                            device=dev, dtype=torch.int32)
        u = torch.rand(shape, generator=generator, device=dev)
        thr, ali = self._read(idx, (self.threshold, self.alias))
        return torch.where(u < thr, idx, ali)

    def sample(self, generator, shape):
        """A node table's draws (``NodeSampler.sample``); an edge table's
        (``EdgeSampler.sample``, ``shape`` the batch): its endpoints."""
        e = self._draw(generator, shape if isinstance(shape, tuple)
                       else (shape,))
        if not self.payload:
            return e
        return tuple(self._read(e, self.payload))


def make_largevis_step(mesh, *, n_nodes: int, n_edges: int, batch: int,
                       out_dim: int = 2, n_negatives: int = 5,
                       rho0: float = 1.0):
    """One layout step over the whole batch: y whole on every rank, the
    edge and node tables cut over ``"data"`` (:class:`_BlockTables`), the
    same ``batch`` edges drawn on every rank from one stream (seeded by
    ``seed`` alone, JAX's ``key(seed)``), and one
    ``layout_engine.sgd_edge_step`` on the fused route, so every rank's y
    stays the same.  At one data rank it is the fit's step on the flat
    samplers.  The first call takes ``run_layout``'s demotion contract
    (``layout.fused_or_demoted``): a failing fused kernel moves the step
    to the split route for good, with one ``DegradedModeWarning``."""
    from repro_torch.core import layout, layout_engine

    f32, i32 = torch.float32, torch.int32
    sizes = mesh.shape
    dp = sh.dp_axes(sizes)
    arg_specs = (_meta((n_nodes, out_dim), f32), _meta((1,), i32),
                 _meta((), f32), _meta((n_edges,), i32),
                 _meta((n_edges,), i32), _meta((n_edges,), f32),
                 _meta((n_edges,), i32), _meta((n_nodes,), f32),
                 _meta((n_nodes,), i32))
    table = sh.block_shape((n_edges,), sh._guard(sizes, (n_edges,), [dp]),
                           sizes)
    node_t = sh.block_shape((n_nodes,), sh._guard(sizes, (n_nodes,), [dp]),
                            sizes)
    in_blocks = tuple(tuple(a.shape) for a in arg_specs[:3]) + \
        (table,) * 4 + (node_t,) * 2
    route = {"first": True, "layout_step": "fused"}

    def step(y, seed, t_frac, edge_src, edge_dst, edge_thr, edge_alias,
             neg_thr, neg_alias, *, generator=None, lr=None):
        dev = y.device
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(
                int(seed.reshape(-1)[0]))
        if lr is None:
            lr = _lrs(t_frac, 1, rho0, dev)[0]
        es = _BlockTables(mesh, n_edges, edge_thr, edge_alias, edge_src,
                          edge_dst)
        ns = _BlockTables(mesh, n_nodes, neg_thr, neg_alias)
        one = functools.partial(
            layout_engine.sgd_edge_step, y, generator, edge_sampler=es,
            neg_sampler=ns, n_negatives=n_negatives, batch=batch, lr=lr)
        if route.pop("first", False) and dev.type != "meta":
            if layout.fused_or_demoted(
                    y, generator, lambda: one(layout_step="fused"),
                    lambda: one(layout_step="split")):
                route["layout_step"] = "split"
            return y
        return one(layout_step=route["layout_step"])

    return step, arg_specs, in_blocks, (n_nodes, out_dim)


def make_largevis_transform_step(mesh, *, n_corpus: int, n_slots: int,
                                 k: int, out_dim: int = 2,
                                 n_negatives: int = 5, steps: int = 48,
                                 rho0: float = 1.0):
    """The projection server's lockstep step as a launch-harness cell:
    every slot draws one positive edge from its neighbor distribution and
    M negatives (``transform.sample_query_edges``) and takes one fused
    edge step at its own age's lr (``serve_projection.slot_lr_table``,
    the engine's table: the JAX builder's inline ``rho0 * max(1 - age /
    steps, 1e-4)`` is reciprocal-then-multiply under ``jax.jit``, ROADMAP
    Queue 3), the corpus rows frozen (``n_frozen``), through
    ``serve_projection._lockstep_apply``, the engine's own update: the
    active slots' ``ages`` advance in place.  Everything is whole on
    every rank.  Wire format (JAX's): y_full (N+S, s) f32, seed (1,),
    p (S, k) f32 (the engine's neighbor probabilities; JAX passes their
    logs to its categorical draw), nn_idx (S, k), ages (S,) i32, active
    (S,) i32, neg thr/alias (N,)."""
    from repro_torch.core.sampler import NodeSampler
    from repro_torch.core.transform import sample_query_edges
    from repro_torch.launch import serve_projection as sp

    f32, i32 = torch.float32, torch.int32
    arg_specs = (_meta((n_corpus + n_slots, out_dim), f32),
                 _meta((1,), i32), _meta((n_slots, k), f32),
                 _meta((n_slots, k), i32), _meta((n_slots,), i32),
                 _meta((n_slots,), i32), _meta((n_corpus,), f32),
                 _meta((n_corpus,), i32))
    tables: dict = {}

    def step(y_full, seed, p, nn_idx, ages, active, neg_thr, neg_alias, *,
             generator=None):
        dev = y_full.device
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(
                int(seed.reshape(-1)[0]))
        if dev not in tables:
            tables[dev] = (sp.slot_lr_table(rho0, steps, dev),
                           n_corpus + torch.arange(n_slots, dtype=i32,
                                                   device=dev))
        lrs, i = tables[dev]
        j, negs, neg_mask = sample_query_edges(
            generator, p, nn_idx, NodeSampler(neg_thr, neg_alias, n_corpus),
            n_negatives)
        return sp._lockstep_apply(y_full, i, j, negs, neg_mask, ages,
                                  active.bool(), lrs, n_frozen=n_corpus,
                                  layout_step="fused")

    in_blocks = tuple(tuple(a.shape) for a in arg_specs)
    return step, arg_specs, in_blocks, (n_corpus + n_slots, out_dim)
