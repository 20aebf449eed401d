"""One layer period of a production cell, the rank's share — the JAX
package's ``launch/body_lower.py``.

JAX lowers each cell's scan bodies alone under the cell's shardings,
because ``cost_analysis()`` counts a scan body once: a train cell's
layer period (forward and backward, ``grad(checkpoint(f))``) and its
one-microbatch loss and gradient, a prefill's period and a decode's
period step on the rank's cache slice; the encoder-decoder's one decoder
layer with the encoder output as an input.  The port has no trace to
correct (its counters see every trip of its eager loops: ``launch/
hlo_analysis.py``), but the same bodies run alone show what a rank of a
production cell does a period, on the meta device (``launch/dryrun.py::
run_body_cell``) and on the card at the cell's per-rank shapes: the
activations' peak, whether a kernel takes the shapes, and the period's
time.

:func:`lower_period_body` returns JAX's dict of bodies, keyed as JAX keys
them (``"period"``, and ``"micro"`` for a train cell), each a
:class:`Body`: the function, its whole arguments on the meta device
(JAX's argument specs), the rank's block shapes of them, JAX's meta
(``n_micro``, ``b_micro``: the global microbatch rows), and
``args(generator)``, the rank's arguments: shapes alone on the meta
device, or on the generator's device with values from it (the port's own
init, cut to the rank's blocks as ``lm.init_lm`` cuts them; normal
activations; a zero cache).  The bodies run the port's own period
(``lm._period``, ``lm.apply_block``, ``encdec._dec_layer``), its loss
(``factory.make_model``) and its steps' rules (``steps.
pick_microbatches``, the FSDP gathers of ``lm.gathered``, the serving
steps' sequence-parallel rule and KV repeat).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import encdec, lm
from repro_torch.models.attention import kv_tp_repeat
from repro_torch.models.factory import init_cache, make_model, param_specs
from repro_torch.runtime import sharding as sh


@dataclasses.dataclass
class Body:
    fn: Callable             # fn(*args) on the rank's arguments
    specs: tuple             # the whole arguments on the meta device
    blocks: tuple            # the rank's block shapes of them
    meta: dict               # JAX's: n_micro (and b_micro for train)
    args: Callable           # args(generator=None) -> the rank's args


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _shapes(tree):
    """The shapes of a tree's tensors (a module's parameters by name)."""
    if isinstance(tree, torch.nn.Module):
        return {n: tuple(p.shape) for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _rank_period(cfg, mesh, *, train: bool, generator=None):
    """The rank's blocks of the first period's layers (a ``ModuleList``;
    the encoder-decoder: its first decoder layer), cast for serving
    unless ``train``: on the meta device, or drawn from ``generator``
    (``lm.init_block``/``encdec.init_dec_layer``, each cut by
    ``sharding.blocks_of`` as it is drawn)."""
    if generator is None:
        from repro_torch.launch.dryrun import rank_params

        tree = rank_params(cfg, mesh.shape, train=train)
        if cfg.is_encoder_decoder:
            return tree["dec_layers"][0]
        return torch.nn.ModuleList(list(tree["blocks"])[:len(
            cfg.block_pattern)])

    def cut(t, prefix):
        t = sh.blocks_of(t, mesh, prefix, stacked=False, train=train)
        return t if train else lm.cast_tree(t, cfg)

    if cfg.is_encoder_decoder:
        return lm.as_module(cut(encdec.init_dec_layer(generator, cfg),
                                "dec_layers"))
    return lm.as_module([cut(lm.init_block(generator, cfg, p),
                             f"blocks/pos{p}")
                         for p in range(len(cfg.block_pattern))])


def _period_specs(cfg, *, train: bool):
    """The whole first period (decoder layer) on the meta device."""
    tree = param_specs(cfg, inference=not train)
    if cfg.is_encoder_decoder:
        return tree["dec_layers"][0]
    return torch.nn.ModuleList(list(tree["blocks"])[:len(cfg.block_pattern)])


def _act(generator, shape, dtype):
    """Activations (normal) from ``generator``, or shapes alone."""
    if generator is None:
        return _meta(shape, dtype)
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(dtype)


def _tokens(generator, shape, vocab: int):
    if generator is None:
        return _meta(shape, torch.int32)
    return torch.randint(0, vocab, shape, generator=generator,
                         device=generator.device, dtype=torch.int32)


def _x(cfg, sizes, rows: int, seq: int, batch_first: bool):
    """(whole shape, the rank's block shape) of the activations x of a
    global batch of ``rows``: over the DP axes when they divide it."""
    spec = sh._guard(sizes, (rows, seq, cfg.d_model),
                     [sh.dp_axes(sizes) if batch_first else None, None,
                      None])
    whole = (rows, seq, cfg.d_model)
    return whole, sh.block_shape(whole, spec, sizes)


def lower_period_body(cfg, mesh, shape_cfg) -> dict:
    """JAX's ``lower_period_body``: ``{"period": Body[, "micro": Body]}``
    of one rank of ``mesh`` (the dry run's recording mesh, or any
    ``DataMesh``) for ``shape_cfg`` (module docstring)."""
    from repro_torch.launch.steps import pick_microbatches

    kind = shape_cfg.kind
    train = kind == "train"
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    sizes = mesh.shape
    batch_first = sh.covers_dp(sizes, B)
    if cfg.is_encoder_decoder:
        return _encdec_bodies(cfg, mesh, shape_cfg, batch_first)
    pp_specs = _period_specs(cfg, train=train)
    pp_blocks = _shapes(_rank_period(cfg, mesh, train=train))

    if train:
        n_micro = pick_microbatches(shape_cfg, mesh=mesh)
        b_micro = B // n_micro
        x_whole, x_block = _x(cfg, sizes, b_micro, S, batch_first)
        table = sh.train_specs(cfg, sizes)

        def period(pp, x):
            pp.requires_grad_(True)
            x = x.detach().requires_grad_(True)
            blocks = lm.gathered(mesh, table, [(f"blocks.{j}", b)
                                               for j, b in enumerate(pp)])
            y, aux = checkpoint(lm._period, cfg, blocks, x, "auto", mesh,
                                use_reentrant=False)
            loss = y.float().sum() + aux
            return torch.autograd.grad(loss, [x] + list(pp.parameters()),
                                       allow_unused=True)

        def period_args(generator=None):
            return (_rank_period(cfg, mesh, train=True,
                                 generator=generator),
                    _act(generator, x_block, cfg.dtype))

        out = {"period": Body(period, (pp_specs, _meta(x_whole, cfg.dtype)),
                              (pp_blocks, x_block),
                              dict(n_micro=n_micro, b_micro=b_micro),
                              period_args)}
        loss_fn = make_model(cfg, mesh=mesh)["loss"]
        rows = x_block[0]

        def micro(params, batch):
            params.requires_grad_(True)
            loss = loss_fn(params, batch)
            return loss, torch.autograd.grad(loss, list(params.parameters()),
                                             allow_unused=True)

        def micro_args(generator=None):
            if generator is None:
                from repro_torch.launch.dryrun import rank_params

                params = rank_params(cfg, sizes, train=True)
            else:
                params = lm.init_lm(generator, cfg, mesh, train=True)
            return params, {"tokens": _tokens(generator, (rows, S),
                                              cfg.vocab_size),
                            "labels": _tokens(generator, (rows, S),
                                              cfg.vocab_size)}

        out["micro"] = Body(
            micro, (param_specs(cfg),
                    {"tokens": _meta((b_micro, S), torch.int32),
                     "labels": _meta((b_micro, S), torch.int32)}),
            (_shapes(micro_args()[0]), {"tokens": (rows, S),
                                        "labels": (rows, S)}),
            dict(), micro_args)
        return out

    kv_rep = kv_tp_repeat(cfg, sizes["model"])
    sp_len = None if batch_first else S

    if kind == "prefill":
        x_whole, x_block = _x(cfg, sizes, B, S, batch_first)

        @torch.no_grad()
        def period(pp, x):
            cache = {}
            for p, block in enumerate(pp):
                x, cache[f"pos{p}"], _ = lm.apply_block(
                    cfg, p, block, x, mode="prefill", kv_repeat=kv_rep,
                    mesh=mesh, sp_len=sp_len)
            return x, cache

        def args(generator=None):
            return (_rank_period(cfg, mesh, train=False,
                                 generator=generator),
                    _act(generator, x_block, cfg.dtype))

        return {"period": Body(period, (pp_specs, _meta(x_whole, cfg.dtype)),
                               (pp_blocks, x_block), dict(n_micro=1), args)}

    # decode: one period's step on the rank's slice of the cache
    whole = init_cache(cfg, B, S, "meta", kv_repeat=kv_rep)
    specs = sh.batch_shardings({"cache": whole}, sizes,
                               global_batch=B)["cache"]
    c_specs = {p: {k: _meta(t.shape[1:], t.dtype) for k, t in e.items()}
               for p, e in whole.items()}
    c_blocks = {p: {k: sh.block_shape(t.shape[1:], specs[p][k][1:], sizes)
                    for k, t in e.items()} for p, e in whole.items()}
    x_whole, x_block = _x(cfg, sizes, B, 1, batch_first)
    rows = x_block[0]

    @torch.no_grad()
    def period(pp, x, cache, position):
        for p, block in enumerate(pp):
            layer = cache[f"pos{p}"]
            x, new, _ = lm.apply_block(cfg, p, block, x, mode="decode",
                                       cache=layer, position=position,
                                       mesh=mesh, sp_len=sp_len)
            for name, t in new.items():
                if t is not layer[name]:
                    layer[name].copy_(t)
        return x, cache

    def args(generator=None):
        dev = "meta" if generator is None else generator.device
        cache = {p: {k: torch.zeros(c_blocks[p][k], dtype=t.dtype,
                                    device=dev)
                     for k, t in e.items()} for p, e in c_specs.items()}
        return (_rank_period(cfg, mesh, train=False, generator=generator),
                _act(generator, x_block, cfg.dtype), cache,
                torch.full((rows,), S - 1, dtype=torch.int32, device=dev))

    return {"period": Body(
        period, (pp_specs, _meta(x_whole, cfg.dtype), c_specs,
                 _meta((B,), torch.int32)),
        (pp_blocks, x_block, c_blocks, (rows,)), dict(n_micro=1), args)}


def _encdec_bodies(cfg, mesh, shape_cfg, batch_first: bool) -> dict:
    """JAX's ``_lower_encdec_bodies``: one decoder layer, the encoder
    output an input; a train cell its forward and backward (no
    recompute, as ``encdec_loss``), a prefill its prefill, a decode its
    step on the rank's slice of the self-attention cache."""
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    kind = shape_cfg.kind
    train = kind == "train"
    sizes = mesh.shape
    sp_len = None if batch_first else S
    sq = 1 if kind == "decode" else S
    x_whole, x_block = _x(cfg, sizes, B, sq, batch_first)
    e_whole, e_block = _x(cfg, sizes, B, cfg.enc_positions, batch_first)
    lp_specs = _period_specs(cfg, train=train)
    lp_blocks = _shapes(_rank_period(cfg, mesh, train=train))
    table = sh.train_specs(cfg, sizes) if train else None

    def layer(generator):
        return _rank_period(cfg, mesh, train=train, generator=generator)

    if kind == "decode":
        whole = init_cache(cfg, B, S, "meta")["self"]
        specs = sh.batch_shardings({"cache": {"self": whole}}, sizes,
                                   global_batch=B)["cache"]["self"]
        c_specs = {k: _meta(t.shape[1:], t.dtype) for k, t in whole.items()}
        c_blocks = {k: sh.block_shape(t.shape[1:], specs[k][1:], sizes)
                    for k, t in whole.items()}
        rows = x_block[0]

        @torch.no_grad()
        def body(lp, x, enc, cache, position):
            return encdec._dec_layer(cfg, lp, x, enc, mode="decode",
                                     cache=cache, position=position,
                                     mesh=mesh, sp_len=sp_len)

        def args(generator=None):
            dev = "meta" if generator is None else generator.device
            return (layer(generator), _act(generator, x_block, cfg.dtype),
                    _act(generator, e_block, cfg.dtype),
                    {k: torch.zeros(c_blocks[k], dtype=t.dtype, device=dev)
                     for k, t in c_specs.items()},
                    torch.full((rows,), S - 1, dtype=torch.int32,
                               device=dev))

        return {"period": Body(
            body, (lp_specs, _meta(x_whole, cfg.dtype),
                   _meta(e_whole, cfg.dtype), c_specs,
                   _meta((B,), torch.int32)),
            (lp_blocks, x_block, e_block, c_blocks, (rows,)),
            dict(n_micro=1), args)}

    def body(lp, x, enc):
        if not train:
            with torch.no_grad():
                return encdec._dec_layer(cfg, lp, x, enc, mode="prefill",
                                         mesh=mesh, sp_len=sp_len)
        lp.requires_grad_(True)
        x = x.detach().requires_grad_(True)
        got, = lm.gathered(mesh, table, [("dec_layers.0", lp)])
        y, _ = encdec._dec_layer(cfg, got, x, enc, mode="fwd", mesh=mesh)
        return torch.autograd.grad(y.float().sum(),
                                   [x] + list(lp.parameters()),
                                   allow_unused=True)

    def args(generator=None):
        return (layer(generator), _act(generator, x_block, cfg.dtype),
                _act(generator, e_block, cfg.dtype))

    return {"period": Body(
        body, (lp_specs, _meta(x_whole, cfg.dtype),
               _meta(e_whole, cfg.dtype)),
        (lp_blocks, x_block, e_block), dict(n_micro=1), args)}
