"""The port's mamba layer and the hybrid jamba decoder against the JAX
package, on the CPU.

``jamba-v0.1-52b``'s reduced form (f32, d 64, inner 128, state 8, conv 4,
16 layers: a period of 7 mamba layers and one attention layer, twice,
MoE at the odd positions with 4 experts) with the JAX package's own
weights, carried across by ``convert.lm_params_from_numpy``; inputs from
seeded numpy.  Whole models route to every expert (as
``tests/test_torch_lm_families.py`` states why).

Tolerances (f32): the scan and the layer within 1e-5 of the largest
magnitude (the port's doubling scan multiplies in another order than
``lax.associative_scan``); logits and cache leaves within 1e-4; decode
against prefill(S + 1) within 2e-3, the JAX package's own bound
(``tests/test_models.py``); bf16 within 3e-2.
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
from repro.models import ssm as jssm
from repro.models.factory import cache_specs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models.factory import (F32_MATRICES, cast_for_inference,
                                        init_cache)

NAME = "jamba-v0.1-52b"


@pytest.fixture(scope="module")
def layer():
    """One mamba layer's weights in both packages."""
    jcfg, tcfg = par.cfgs(NAME)
    jp = jssm.init_mamba(jax.random.key(3), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = par.cfgs(NAME)
    jp, tp = par.params(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def jdecode(model):
    """JAX's lm_decode on the model, compiled once per cache shape."""
    jcfg, _, jp, _ = model
    return jax.jit(lambda t, c, pos: jlm.lm_decode(jp, jcfg, t, c, pos))


@pytest.mark.parametrize("L", [1, 7, 256])
def test_chunk_scan_matches_associative_scan(L):
    """The doubling scan against ``lax.associative_scan`` from a nonzero
    h0, at one token, at an odd length and at a full chunk; decays in
    (0, 1] with exact zeros among them (``da`` underflows to 0 on long
    steps, so no product of logs)."""
    rng = np.random.default_rng(L)
    da = rng.uniform(0.0, 1.0, (2, L, 16, 8)).astype(np.float32)
    da[:, ::5, :3] = 0.0
    dbu = par.normal((2, L, 16, 8), seed=L + 1)
    h0 = par.normal((2, 16, 8), seed=L + 2)
    jh, jlast = jax.jit(jssm._chunk_scan)(jnp.asarray(da), jnp.asarray(dbu),
                                          jnp.asarray(h0))
    th, tlast = tssm._chunk_scan(*(torch.from_numpy(a)
                                   for a in (da, dbu, h0)))
    assert par.rel(th, jh) < 1e-5
    assert par.rel(tlast, jlast) < 1e-5


@pytest.mark.parametrize("S", [1, 2, 3, 100, 512])
def test_mamba_prefill_matches_jax(layer, S):
    """Output and final state; S = 512 crosses the chunk boundary at 256,
    the state carried.  The conv tail equals JAX's from S = 3 (K - 1) on;
    below it, the port's is zero rows then JAX's (fault 2 below)."""
    jcfg, tcfg, jp, tp = layer
    x = par.normal((2, S, tcfg.d_model), seed=S)
    jout, jcache = jssm.mamba_prefill(jp, jnp.asarray(x), jcfg)
    tout, tcache = tssm.mamba_prefill(tp, torch.from_numpy(x), tcfg)
    assert par.rel(tout, jout) < 1e-5
    assert par.rel(tcache["ssm"], jcache["ssm"]) < 1e-5
    K1 = tcfg.ssm_conv - 1
    assert tuple(tcache["conv"].shape) == (2, K1, 2 * tcfg.d_model)
    n = jcache["conv"].shape[1]
    np.testing.assert_array_equal(tcache["conv"][:, K1 - n:].numpy(),
                                  np.asarray(jcache["conv"]))
    assert not tcache["conv"][:, :max(K1 - S, 0)].any()


def test_mamba_fwd_matches_prefill_and_jax(layer):
    jcfg, tcfg, jp, tp = layer
    x = par.normal((2, 512, tcfg.d_model), seed=5)
    want = jssm.mamba_fwd(jp, jnp.asarray(x), jcfg)
    got = tssm.mamba_fwd(tp, torch.from_numpy(x), tcfg)
    assert par.rel(got, want) < 1e-5
    assert torch.equal(got, tssm.mamba_prefill(tp, torch.from_numpy(x),
                                               tcfg)[0])


def test_jax_keeps_a_short_conv_tail(layer):
    """Fault 2 of the JAX package (ROADMAP Queue 3): below K - 1 = 3
    tokens its prefill keeps one row of conv context, not three."""
    jcfg, tcfg, jp, tp = layer
    for S in (1, 2, 3):
        x = jnp.asarray(par.normal((2, S, tcfg.d_model), seed=S))
        _, cache = jssm.mamba_prefill(jp, x, jcfg)
        assert cache["conv"].shape[1] == (1 if S < 3 else 3)


@pytest.mark.parametrize("S", [1, 2, 31, 255])
def test_mamba_decode_matches_jax_and_prefill(layer, S):
    """decode(token S) on the port's prefill(S) cache against JAX's
    decode on the same cache, and against prefill(S + 1)'s last output:
    at S = 1 and 2 the zero-padded tail is the context prefill(S + 1)
    convolves over; S = 255 fills the first chunk."""
    jcfg, tcfg, jp, tp = layer
    x = par.normal((2, S + 1, tcfg.d_model), seed=10 + S)
    _, cache = tssm.mamba_prefill(tp, torch.from_numpy(x[:, :S]), tcfg)
    jout, jnew = jssm.mamba_decode(jp, jnp.asarray(x[:, S:]), jcfg,
                                   par.jtree(cache))
    tout, tnew = tssm.mamba_decode(tp, torch.from_numpy(x[:, S:]), tcfg,
                                   cache)
    assert par.rel(tout, jout) < 1e-5
    par.same_leaves(tnew, jnew, tol=1e-5)
    want, _ = tssm.mamba_prefill(tp, torch.from_numpy(x), tcfg)
    assert par.rel(tout[:, 0], want[:, -1]) < 1e-5


def test_chunk_contract_raises(layer, model):
    """Fault 3 kept as a contract: a prompt over 256 tokens that is not a
    multiple of 256 raises ValueError in the port (the layer, the model
    and the engine's submit) and TypeError in the JAX package's reshape;
    256 and 512 pass."""
    jcfg, tcfg, jp, tp = layer
    x = par.normal((1, 300, tcfg.d_model))
    with pytest.raises(ValueError, match="chunk contract"):
        tssm.mamba_prefill(tp, torch.from_numpy(x), tcfg)
    with pytest.raises(TypeError):
        jssm.mamba_prefill(jp, jnp.asarray(x), jcfg)
    _, mcfg, _, mp = model
    with pytest.raises(ValueError, match="chunk contract"):
        tlm.lm_prefill(mp, mcfg, torch.zeros((1, 300), dtype=torch.long))
    eng = ServeEngine(mcfg, slots=1, max_len=600, device="cpu", params=mp)
    with pytest.raises(ValueError, match="chunk contract"):
        eng.submit(Request(0, [1] * 300))
    for n in (256, 512):
        eng.submit(Request(n, [1] * n))


def test_params_round_trip_bitwise(model):
    jcfg, tcfg, jp, tp = model
    back = lm_params_to_numpy(tp, tcfg)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["full", "chunked"])
def test_jamba_prefill_matches_jax(model, impl):
    """Last logits and every cache leaf at S = 512 (two chunks)."""
    jcfg, tcfg, jp, tp = model
    toks = par.tokens(2, 512, tcfg.vocab_size, seed=1)
    jlog, jcache = jlm.lm_prefill(jp, jcfg, jnp.asarray(toks),
                                  attn_impl=impl)
    tlog, tcache = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks),
                                  attn_impl=impl)
    assert par.rel(tlog, jlog) < 1e-4
    par.same_leaves(tcache, jcache)


@pytest.mark.parametrize("S", [1, 2, 31])
def test_jamba_decode_matches_jax_and_prefill(model, jdecode, S):
    """prefill(S) + decode(token S) against JAX's lm_decode on the same
    cache and against prefill(S + 1); every layer's new state lands in
    the cache (a decode that dropped the recurrent states would drift
    from prefill(S + 1) at the next token: two decodes are checked)."""
    jcfg, tcfg, jp, tp = model
    B = 2
    toks = par.tokens(B, S + 2, tcfg.vocab_size, seed=2 + S)
    _, cache = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks[:, :S]))
    cache = par.grown(cache, S, 40)
    for i in (0, 1):
        pos = np.full((B,), S + i)
        step = toks[:, S + i:S + i + 1]
        jlog, jnew = jdecode(jnp.asarray(step), par.jtree(cache),
                             jnp.asarray(pos))
        tlog, cache = tlm.lm_decode(tp, tcfg, torch.from_numpy(step), cache,
                                    torch.from_numpy(pos))
        assert par.rel(tlog, jlog) < 1e-4, i
        par.same_leaves(cache, jnew)
        want, _ = tlm.lm_prefill(tp, tcfg, torch.from_numpy(
            toks[:, :S + i + 1]))
        assert par.rel(tlog, want) < 2e-3, i


def test_init_cache_is_the_prefill_layout():
    """init_cache allocates the tree JAX's cache_specs derives from
    prefill(max_len): ``ssm`` f32, ``conv`` (K - 1 rows) in the compute
    dtype, attention K/V."""
    jcfg, tcfg = par.cfgs(NAME)
    for B, max_len in ((3, 48), (1, 256)):
        want = cache_specs(jcfg, B, max_len)
        got = init_cache(tcfg, B, max_len, "cpu")
        assert sorted(got) == sorted(want)
        for p, entry in want.items():
            assert sorted(got[p]) == sorted(entry)
            for n, spec in entry.items():
                assert tuple(got[p][n].shape) == spec.shape, (p, n)
                assert str(got[p][n].dtype)[6:] == str(spec.dtype)


def test_serve_engine_matches_jax_greedy(model):
    """The port's engine gives the JAX engine's greedy tokens on the same
    weights: 2 slots, max_len 96, prompts of 40, 5 and 40
    tokens (at least K - 1: fault 2 is in the JAX engine's splice too),
    8 new tokens each; the third request takes a slot whose state the
    first left."""
    jcfg, tcfg, jp, tp = model
    jeng = par.jax_engine(jcfg, jp, slots=2, max_len=96)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (40, 5, 40)]
    jreqs = [JRequest(i, p, max_new=8) for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    eng = ServeEngine(tcfg, slots=2, max_len=96, device="cpu",
                      params=copy.deepcopy(tp))
    reqs = [Request(i, p, max_new=8) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_bf16_prefill_keeps_f32_matrices(model):
    """``cast_for_inference`` leaves mamba's ``a_log``, ``w_b``, ``w_c``,
    ``w_dt_down``, ``w_dt_up`` (and the tables and routers) f32 and casts
    the rest.  The cast model's first mamba layer in bf16 within 3e-2 of
    JAX's bf16 layer on its f32 master weights; the whole bf16 prefill
    keeps f32 logits and states.  (Whole-model bf16 logits are not held
    to JAX's: XLA keeps f32 inside fused bf16 elementwise chains, the
    port rounds each op, and at the reduced 16 layers the two packages'
    bf16 logits are each 2-3% from the f32 model's and 2-4% apart.)"""
    jcfg, tcfg = par.cfgs(NAME, dtype=jnp.bfloat16)
    jp = model[2]
    tp = cast_for_inference(lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu"), tcfg)
    mamba = tp["blocks"][0]["mamba"]
    for name, p in mamba.items():
        want = torch.float32 if (p.dim() < 2 or name in F32_MATRICES) else \
            torch.bfloat16
        assert p.dtype == want, name
    assert {"a_log", "w_b", "w_c", "w_dt_down", "w_dt_up"} <= set(
        F32_MATRICES)
    x = torch.from_numpy(par.normal((2, 64, tcfg.d_model), seed=1)).to(
        torch.bfloat16)
    jlayer = jax.tree.map(lambda a: a[0], jp["blocks"]["pos0"]["mamba"])
    jout, jcache = jssm.mamba_prefill(
        jlayer, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jcfg)
    tout, tcache = tssm.mamba_prefill(mamba, x, tcfg)
    assert tout.dtype == torch.bfloat16
    assert par.rel(tout.float(), jout.astype(jnp.float32)) < 3e-2
    assert par.rel(tcache["ssm"], jcache["ssm"]) < 3e-2
    toks = par.tokens(1, 64, tcfg.vocab_size, seed=1)
    tlog, tcache = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks))
    assert tlog.dtype == torch.float32 and bool(torch.isfinite(tlog).all())
    assert tcache["pos0"]["ssm"].dtype == torch.float32
    assert tcache["pos0"]["conv"].dtype == torch.bfloat16
