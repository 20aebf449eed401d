"""Shared pieces of the CPU tests that hold the port's LM architectures
against the JAX package (``tests/test_torch_{ssm,xlstm,encdec}.py``):
the reduced configs of both packages, the JAX package's weights carried
across, seeded inputs and the relative error they are held to."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import factory as jfactory
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy


def cfgs(name, total_routing=True, **kw):
    """The reduced config of ``name`` in both packages, with ``kw``
    replaced (a ``dtype`` given as a JAX dtype); MoE with total routing
    (``topk_experts = n_experts``) unless ``total_routing`` is False."""
    jcfg = jget_config(name + "-reduced")
    if total_routing and jcfg.n_experts:
        kw = dict(kw, topk_experts=jcfg.n_experts)
    tkw = dict(kw)
    if "dtype" in tkw:
        tkw["dtype"] = getattr(torch, jnp.dtype(tkw["dtype"]).name)
    return (dataclasses.replace(jcfg, **kw),
            dataclasses.replace(get_config(name + "-reduced"), **tkw))


def params(jcfg, tcfg, seed=0):
    """The JAX package's init (decoder or encoder-decoder, jitted: the
    eager vmapped init of the reduced jamba takes 9 s) and the port's copy
    of it on the CPU."""
    jp = jax.jit(jfactory.make_model(jcfg)["init"])(jax.random.key(seed))
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                    "cpu")


def jax_engine(jcfg, jp, **kw):
    """The JAX package's ``ServeEngine`` on the weights ``jp`` (its
    constructor would draw its own with the eager init)."""
    model = dict(jfactory.make_model(jcfg), init=lambda key: jp)
    with mock.patch("repro.launch.serve.make_model", lambda cfg: model):
        return JServeEngine(jcfg, **kw)


def tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def normal(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def rel(got, want):
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def jtree(tree):
    """A tree of torch tensors as JAX arrays (copies)."""
    if isinstance(tree, dict):
        return {k: jtree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy().copy())


def same_leaves(got, want, tol=1e-4, where=()):
    """Every leaf of the JAX tree ``want`` in ``got``: the same keys,
    shapes and values within ``tol`` (relative)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            same_leaves(got[k], want[k], tol, where + (k,))
        return
    assert tuple(got.shape) == want.shape, where
    assert rel(got, want) < tol, where


def grown(cache, S, T):
    """A copy of ``cache`` with its position-indexed K/V leaves of length S
    grown to T slots with zeros along their sequence axis, as the JAX
    package's tests pad them; recurrent states and ``encoder_out`` stay."""
    out = {}
    for name, leaf in cache.items():
        if isinstance(leaf, dict):
            out[name] = grown(leaf, S, T)
        elif name in ("k", "v") and leaf.shape[2] == S:
            out[name] = torch.nn.functional.pad(
                leaf, (0, 0) * (leaf.dim() - 3) + (0, T - S))
        else:
            out[name] = leaf.clone()
    return out
