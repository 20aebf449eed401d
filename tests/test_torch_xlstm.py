"""The port's mLSTM and sLSTM blocks and the xlstm decoder against the JAX
package, on the CPU.

``xlstm-125m``'s reduced form (f32, d 64, 4 heads: the mLSTM at inner 128
with dh 32, the sLSTM at dh 16; 4 layers alternating mLSTM and sLSTM,
tied embeddings) with the JAX package's own weights, carried across by
``convert.lm_params_from_numpy``; inputs from seeded numpy.

Tolerances (f32): a block within 1e-5 of the largest magnitude (the same
token-by-token recurrences; XLA and torch round exp and sum in their own
orders); logits and states within 1e-4; decode against prefill(S + 1)
within 2e-3, the JAX package's own bound (``tests/test_models.py``);
bf16 within 3e-2.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as par
from repro.launch.serve import Request as JRequest
from repro.models import lm as jlm
from repro.models import xlstm as jxlstm
from repro.models.factory import cache_specs
from repro_torch.convert import lm_params_to_numpy
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import xlstm as txlstm
from repro_torch.models.factory import (F32_MATRICES, cast_for_inference,
                                        init_cache)

NAME = "xlstm-125m"
KINDS = {"mlstm": (jxlstm.init_mlstm, jxlstm.mlstm_prefill,
                   jxlstm.mlstm_decode, txlstm.mlstm_prefill,
                   txlstm.mlstm_decode),
         "slstm": (jxlstm.init_slstm, jxlstm.slstm_prefill,
                   jxlstm.slstm_decode, txlstm.slstm_prefill,
                   txlstm.slstm_decode)}


def _block(kind, dtype=None, seed=3):
    """One block's core in both packages (the port's cast for inference
    under ``dtype``)."""
    kw = {} if dtype is None else {"dtype": dtype}
    jcfg, tcfg = par.cfgs(NAME, **kw)
    jp = KINDS[kind][0](jax.random.key(seed), jcfg)
    tp = tlm.as_module(jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                    jp))
    if dtype is not None:
        cast_for_inference(tp, tcfg)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = par.cfgs(NAME)
    jp, tp = par.params(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def test_log_sigmoid_matches_jax():
    """``layers.log_sigmoid`` against ``jax.nn.log_sigmoid`` across the
    f32 range, the saturated tails included."""
    x = np.concatenate([par.normal((1000,), scale=5.0),
                        np.array([-200, -90, -30, -1e-3, 0, 1e-3, 30, 90,
                                  200], np.float32)])
    got = tlayers.log_sigmoid(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_matches_jax(kind):
    """Output and every state leaf of a 40-token prefill."""
    jcfg, tcfg, jp, tp = _block(kind)
    x = par.normal((2, 40, tcfg.d_model), seed=1)
    jout, jcache = KINDS[kind][1](jp, jnp.asarray(x), jcfg)
    tout, tcache = KINDS[kind][3](tp, torch.from_numpy(x), tcfg)
    assert par.rel(tout, jout) < 1e-5
    par.same_leaves(tcache, jcache, tol=1e-5)
    assert all(t.dtype == torch.float32 for t in tcache.values())


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_matches_jax_and_prefill(kind):
    """decode(token S) on the port's prefill(S) states against JAX's
    decode on the same states, and against prefill(S + 1)."""
    jcfg, tcfg, jp, tp = _block(kind)
    S = 17
    x = par.normal((2, S + 1, tcfg.d_model), seed=2)
    _, cache = KINDS[kind][3](tp, torch.from_numpy(x[:, :S]), tcfg)
    jout, jnew = KINDS[kind][2](jp, jnp.asarray(x[:, S:]), jcfg,
                                par.jtree(cache))
    tout, tnew = KINDS[kind][4](tp, torch.from_numpy(x[:, S:]), tcfg, cache)
    assert par.rel(tout, jout) < 1e-5
    par.same_leaves(tnew, jnew, tol=1e-5)
    want, wcache = KINDS[kind][3](tp, torch.from_numpy(x), tcfg)
    assert par.rel(tout[:, 0], want[:, -1]) < 1e-5
    par.same_leaves(tnew, par.jtree(wcache), tol=1e-5)


def test_mlstm_k_is_f32_under_bf16():
    """Under bf16 the JAX package's k is f32 (a bf16 product over
    ``np.sqrt(dh)``, a float64 scalar that is not weakly typed), and so is
    the port's, the product's bf16 values over an f32 sqrt(dh)."""
    jcfg, tcfg, jp, tp = _block("mlstm", dtype=jnp.bfloat16)
    x = torch.from_numpy(par.normal((2, 9, tcfg.d_model), seed=4)).to(
        torch.bfloat16)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jq, jk, jv, jit, jft, _ = jxlstm._mlstm_qkvgates(jp, jx, jcfg)
    q, k, v, it, ft, _ = txlstm._mlstm_qkvgates(tp, x, tcfg)
    assert jk.dtype == jnp.float32 and jq.dtype == jnp.bfloat16
    assert k.dtype == torch.float32 and q.dtype == torch.bfloat16
    assert it.dtype == ft.dtype == torch.float32
    for got, want in ((q, jq), (k, jk), (v, jv), (it, jit), (ft, jft)):
        assert par.rel(got.float(), want.astype(jnp.float32)) < 3e-2
    # k is not rounded to bf16 after the division (8-bit mantissas would
    # move most entries)
    assert not torch.equal(k, k.to(torch.bfloat16).float())


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_bf16_block_keeps_f32_matrices(kind):
    """``cast_for_inference`` keeps the mLSTM's ``w_i``/``w_f`` and the
    sLSTM's ``w_x``/``r`` f32 (a bf16 copy would fail the f32 products
    loudly) and casts the rest; the bf16 block within 3e-2 of JAX's bf16
    block on its f32 master weights, its states f32."""
    jcfg, tcfg, jp, tp = _block(kind, dtype=jnp.bfloat16)
    for name, p in tp.named_parameters():
        want = torch.float32 if (p.dim() < 2 or name in F32_MATRICES) else \
            torch.bfloat16
        assert p.dtype == want, name
    x = torch.from_numpy(par.normal((2, 24, tcfg.d_model), seed=5)).to(
        torch.bfloat16)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jout, jcache = KINDS[kind][1](jp, jx, jcfg)
    tout, tcache = KINDS[kind][3](tp, x, tcfg)
    assert tout.dtype == torch.bfloat16
    assert par.rel(tout.float(), jout.astype(jnp.float32)) < 3e-2
    for name, t in tcache.items():
        assert t.dtype == torch.float32
        assert par.rel(t, jcache[name]) < 3e-2, name


def test_params_round_trip_bitwise(model):
    jcfg, tcfg, jp, tp = model
    back = lm_params_to_numpy(tp, tcfg)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_xlstm_prefill_matches_jax(model):
    """Last logits and every state leaf (no attention: ``attn_impl`` does
    not apply)."""
    jcfg, tcfg, jp, tp = model
    toks = par.tokens(2, 48, tcfg.vocab_size, seed=1)
    jlog, jcache = jlm.lm_prefill(jp, jcfg, jnp.asarray(toks))
    tlog, tcache = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks))
    assert par.rel(tlog, jlog) < 1e-4
    par.same_leaves(tcache, jcache)


def test_xlstm_decode_matches_jax_and_prefill(model):
    """Two decodes from prefill(S) against JAX's lm_decode on the same
    cache and against prefill(S + 1), prefill(S + 2): each layer's new
    states land in the cache, or the second decode drifts."""
    jcfg, tcfg, jp, tp = model
    B, S = 2, 23
    toks = par.tokens(B, S + 2, tcfg.vocab_size, seed=2)
    _, cache = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks[:, :S]))
    for i in (0, 1):
        pos = np.full((B,), S + i)
        step = toks[:, S + i:S + i + 1]
        jlog, jnew = jlm.lm_decode(jp, jcfg, jnp.asarray(step),
                                   par.jtree(cache), jnp.asarray(pos))
        tlog, cache = tlm.lm_decode(tp, tcfg, torch.from_numpy(step), cache,
                                    torch.from_numpy(pos))
        assert par.rel(tlog, jlog) < 1e-4, i
        par.same_leaves(cache, jnew)
        want, _ = tlm.lm_prefill(tp, tcfg, torch.from_numpy(
            toks[:, :S + i + 1]))
        assert par.rel(tlog, want) < 2e-3, i


def test_init_cache_is_the_prefill_layout():
    jcfg, tcfg = par.cfgs(NAME)
    want = cache_specs(jcfg, 3, 20)
    got = init_cache(tcfg, 3, 20, "cpu")
    assert sorted(got) == sorted(want)
    for p, entry in want.items():
        assert sorted(got[p]) == sorted(entry)
        for n, spec in entry.items():
            assert tuple(got[p][n].shape) == spec.shape, (p, n)
            assert str(got[p][n].dtype)[6:] == str(spec.dtype)


def test_serve_engine_matches_jax_greedy(model):
    """The port's engine gives the JAX engine's greedy tokens on the same
    weights: 2 slots, prompts of 30, 3 and 12 tokens, 6
    new tokens each; the third request takes a slot whose states the
    first left, spliced whole."""
    jcfg, tcfg, jp, tp = model
    jeng = par.jax_engine(jcfg, jp, slots=2, max_len=64)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (30, 3, 12)]
    jreqs = [JRequest(i, p, max_new=6) for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    eng = ServeEngine(tcfg, slots=2, max_len=64, device="cpu",
                      params=copy.deepcopy(tp))
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
