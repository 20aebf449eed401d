"""The port's GQA, sliding-window, local:global and MoE decoders against
the JAX package, on the CPU.

Each newly registered architecture in its reduced form (f32, d 64, 4
heads over 2 kv heads, head_dim 16, window 64, 4 experts top-2) with the
JAX package's own ``init_lm`` weights, carried across by
``convert.lm_params_from_numpy``; token ids from seeded numpy.  On CPU
tensors the chunked path runs the flash kernel's plain version.

Tolerances (f32), as ``tests/test_torch_lm.py`` states them: logits and
cache leaves within 1e-4 of the largest magnitude (the same formulas;
XLA and torch sum in their own orders); decode against prefill(S + 1)
within 2e-3, and an int8 cache's within 0.15, the JAX package's own
bounds (``tests/test_models.py``).  MoE models run with total routing
(``topk_experts = n_experts``) wherever whole models are compared, as the
JAX package's test does: at random init the router's margins are about
1e-5, and f32 summation order flips top-k membership.  ``moe_apply``
itself is held at top-2 with a router scaled until membership is stable.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels import ref
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.factory import cast_for_inference, init_cache

NEW = ("gemma3-12b", "llama3-8b", "phi3-medium-14b", "mixtral-8x7b",
       "dbrx-132b", "chameleon-34b")


def _cfgs(name, total_routing=True, **kw):
    jcfg = jget_config(name + "-reduced")
    if total_routing and jcfg.n_experts:
        kw = dict(kw, topk_experts=jcfg.n_experts)
    return (dataclasses.replace(jcfg, **kw),
            dataclasses.replace(get_config(name + "-reduced"), **kw))


def _params(jcfg, tcfg, seed=0):
    jp = jlm.init_lm(jax.random.key(seed), jcfg)
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                    "cpu")


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jtree(cache):
    return {p: {n: jnp.asarray(c.numpy().copy()) for n, c in e.items()}
            for p, e in cache.items()}


def _grown(cache, S):
    """Leaves (n_periods, B, S, ...) grown by one zero slot, as the JAX
    package's test pads them; ring buffers (W slots) stay."""
    return {p: {n: (torch.nn.functional.pad(c, (0, 0) * (c.dim() - 3)
                                            + (0, 1))
                    if c.shape[2] == S else c)
                for n, c in e.items()} for p, e in cache.items()}


def _same_leaves(tcache, jcache, tol=1e-4):
    assert sorted(tcache) == sorted(jcache)
    for p, entry in jcache.items():
        assert sorted(tcache[p]) == sorted(entry)
        for name, want in entry.items():
            got = tcache[p][name]
            assert tuple(got.shape) == want.shape, (p, name)
            assert _rel(got, want) < tol, (p, name)


@pytest.fixture(scope="module", params=NEW)
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jp, tp = _params(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def test_params_round_trip_bitwise(model):
    """The per-position block trees (``qnorm``/``knorm``, ``moe`` with its
    (E, in, out) experts) carry over and back bitwise."""
    jcfg, tcfg, jp, tp = model
    back = lm_params_to_numpy(tp, tcfg)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["full", "chunked"])
def test_prefill_matches_jax(model, impl):
    """Last logits and every cache leaf; S = 100 passes gemma3's and
    mixtral's window (64), so their local layers' caches are rings."""
    jcfg, tcfg, jp, tp = model
    toks = _tokens(2, 100, tcfg.vocab_size, seed=1)
    jlog, jcache = jlm.lm_prefill(jp, jcfg, jnp.asarray(toks),
                                  attn_impl=impl)
    tlog, tcache = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks),
                                  attn_impl=impl)
    assert _rel(tlog, jlog) < 1e-4
    _same_leaves(tcache, jcache)


def test_decode_matches_jax_and_prefill(model):
    """prefill(S) + decode(token S) against JAX's lm_decode on the same
    cache, and against prefill(S + 1)."""
    jcfg, tcfg, jp, tp = model
    B, S = 2, 31
    toks = _tokens(B, S + 1, tcfg.vocab_size, seed=2)
    want, _ = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks))
    _, cache = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks[:, :S]))
    cache = _grown(cache, S)
    jcache = _jtree(cache)
    position = np.full((B,), S)
    tlog, tcache = tlm.lm_decode(tp, tcfg, torch.from_numpy(toks[:, S:]),
                                 cache, torch.from_numpy(position))
    jlog, jnew = jlm.lm_decode(jp, jcfg, jnp.asarray(toks[:, S:]), jcache,
                               jnp.asarray(position))
    assert _rel(tlog, jlog) < 1e-4
    _same_leaves(tcache, jnew)
    assert _rel(tlog, want) < 2e-3


@pytest.mark.parametrize("name", ["gemma3-12b", "mixtral-8x7b"])
def test_ring_buffer_decodes_across_the_wrap(name):
    """S = 100 > W = 64: the local layers' caches hold the last 64
    positions rolled to slot = position mod 64 (JAX's leaves); 40 decode
    steps from position 100 cross the wrap at 128, each step's logits and
    leaves against JAX's lm_decode, the last against prefill(140)."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg, tcfg, seed=4)
    B, S, n = 2, 100, 40
    toks = _tokens(B, S + n, tcfg.vocab_size, seed=4)
    jlog, jcache = jlm.lm_prefill(jp, jcfg, jnp.asarray(toks[:, :S]))
    _, cache = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks[:, :S]))
    _same_leaves(cache, jcache)
    W = tcfg.sliding_window
    local = [f"pos{p}" for p, k in enumerate(tcfg.block_pattern)
             if k == "local"]
    for p in local:
        assert cache[p]["k"].shape[2] == W
    # globals grow to S + n; rings stay W
    cache = {p: {k: (torch.nn.functional.pad(c, (0, 0, 0, 0, 0, n))
                     if p not in local else c) for k, c in e.items()}
             for p, e in cache.items()}
    jcache = _jtree(cache)
    jdecode = jax.jit(lambda t, c, pos: jlm.lm_decode(jp, jcfg, t, c, pos))
    for i in range(n):
        pos = np.full((B,), S + i)
        tlog, cache = tlm.lm_decode(tp, tcfg,
                                    torch.from_numpy(toks[:, S + i:S + i + 1]),
                                    cache, torch.from_numpy(pos))
        jlog, jcache = jdecode(jnp.asarray(toks[:, S + i:S + i + 1]), jcache,
                               jnp.asarray(pos))
        assert _rel(tlog, jlog) < 1e-4, i
    _same_leaves(cache, jcache)
    want, _ = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks))
    assert _rel(tlog, want) < 2e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kv_bitwise(dtype):
    """int8 values and f32 scales bitwise JAX's on the same input (round
    half to even, the f32 division max|t| / 127), and dequantization."""
    rng = np.random.default_rng(7)
    t = rng.standard_normal((2, 9, 3, 16)).astype(np.float32) * 3
    t[0, 0, 0] = 0.0                         # the 1e-8 scale floor
    t[0, 1, 0, :2] = [127.0, 0.5]            # a tie at .5
    tt = torch.from_numpy(t).to(dtype)
    jt = jnp.asarray(tt.float().numpy(), jnp.dtype(str(dtype)[6:]))
    q, s = tattn.quantize_kv(tt)
    jq, js = jattn.quantize_kv(jt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tattn.dequantize_kv(q, s, torch.float32).numpy(),
        np.asarray(jattn.dequantize_kv(jq, js, jnp.float32)))


@pytest.mark.parametrize("name", ["gemma3-12b", "llama3-8b"])
@pytest.mark.parametrize("kv_repeat,kv_quant", [(1, True), (2, False),
                                                (2, True)])
def test_kv_repeat_and_quant(name, kv_repeat, kv_quant):
    """``make_model``'s cache storage: the prefill's leaves against JAX's
    (int8 values equal but for a rare rounding tie moved by the inputs'
    last bits), quantize_kv of the port's own K bitwise its cache, and
    decode against JAX's on the same cache and against prefill(S + 1):
    replicated caches within 2e-3, int8 ones within 0.15; the cache stays
    int8."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg, tcfg, seed=5)
    B, S = 2, 100 if name == "gemma3-12b" else 31
    toks = _tokens(B, S + 1, tcfg.vocab_size, seed=5)
    kw = dict(kv_repeat=kv_repeat, kv_quant=kv_quant)
    _, jcache = jlm.lm_prefill(jp, jcfg, jnp.asarray(toks[:, :S]), **kw)
    _, cache = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks[:, :S]), **kw)
    kvh = tcfg.n_kv_heads * kv_repeat
    for p, entry in jcache.items():
        for n, want in entry.items():
            got = cache[p][n]
            assert tuple(got.shape) == want.shape and got.shape[3] == kvh
            if got.dtype == torch.int8:
                diff = np.abs(got.numpy().astype(np.int32)
                              - np.asarray(want).astype(np.int32))
                assert diff.max() <= 1 and diff.mean() < 1e-3, (p, n)
            else:
                assert _rel(got, want) < 1e-4, (p, n)
    if kv_repeat > 1:               # head h's copies sit side by side
        k = cache["pos0"]["k"]
        assert torch.equal(k[..., 0::2, :], k[..., 1::2, :])
    cache = _grown(cache, S)
    want, _ = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks))
    position = np.full((B,), S)
    jlog, jnew = jlm.lm_decode(jp, jcfg, jnp.asarray(toks[:, S:]),
                               _jtree(cache), jnp.asarray(position))
    tlog, cache = tlm.lm_decode(tp, tcfg, torch.from_numpy(toks[:, S:]),
                                cache, torch.from_numpy(position))
    assert _rel(tlog, jlog) < 1e-4
    assert _rel(tlog, want) < (0.15 if kv_quant else 2e-3)
    if kv_quant:
        assert {c.dtype for e in cache.values() for c in e.values()} == \
            {torch.int8, torch.float32}
        assert all(e["k"].dtype == torch.int8 for e in cache.values())


def test_init_cache_is_the_prefill_layout():
    """init_cache allocates the tree JAX's cache_specs derives from
    prefill(max_len): T = W for a local position once max_len >= W."""
    from repro.models.factory import cache_specs
    jcfg, tcfg = _cfgs("gemma3-12b")
    for max_len, kw in ((48, {}), (100, {}),
                        (100, dict(kv_repeat=2, kv_quant=True))):
        want = cache_specs(jcfg, 3, max_len, **kw)
        got = init_cache(tcfg, 3, max_len, "cpu", **kw)
        assert sorted(got) == sorted(want)
        for p, entry in want.items():
            assert sorted(got[p]) == sorted(entry)
            for n, spec in entry.items():
                assert tuple(got[p][n].shape) == spec.shape, (max_len, p, n)
                assert str(got[p][n].dtype)[6:] == str(spec.dtype)


def _moe_inputs(T=64, seed=8):
    jcfg, tcfg = _cfgs("mixtral-8x7b", total_routing=False)
    jp = jmoe.init_moe(jax.random.key(seed), jcfg)
    # a router scaled up from its 0.02 init: top-2 membership with wide
    # margins, the same in both frameworks
    jp = dict(jp, router=jp["router"] * 100.0)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(seed).standard_normal(
        (2, T // 2, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


@pytest.mark.parametrize("factor", [1.25, 0.1])
def test_moe_apply_matches_jax(factor):
    """Top-2 ``moe_apply`` against ``_moe_apply_global``: the chosen
    experts equal, y and the aux loss within 1e-5; at capacity factor 0.1
    (8 slots an expert for 128 routed pairs) pairs are dropped in both."""
    jcfg, tcfg, jp, tp, x = _moe_inputs()
    jy, jaux = jmoe._moe_apply_global(jp, jnp.asarray(x), jcfg, factor)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg, factor)
    T = x.shape[0] * x.shape[1]
    _, _, top_e = tmoe.route(tp, torch.from_numpy(x).reshape(T, -1), tcfg)
    jprobs = jax.nn.softmax(jnp.asarray(x).reshape(T, -1) @ jp["router"])
    np.testing.assert_array_equal(
        top_e.numpy(), np.asarray(jax.lax.top_k(jprobs, 2)[1]))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    C = tmoe.capacity(T, tcfg.n_experts, 2, factor)
    assert C == jmoe.capacity(T, jcfg.n_experts, 2, factor)
    counts = np.bincount(top_e.numpy().ravel(), minlength=tcfg.n_experts)
    dropped = np.maximum(counts - C, 0).sum()
    assert (dropped > 0) == (factor < 1)
    if dropped:                     # a token with both pairs dropped is 0
        zero = (ty.reshape(T, -1).abs().amax(-1) == 0).numpy()
        assert zero.sum() == (np.asarray(jy).reshape(T, -1) == 0).all(
            -1).sum() > 0


def test_moe_ties_go_to_the_lower_expert():
    """Equal router probabilities: ``lax.top_k`` takes the lower expert
    first, and so does the port's stable sort."""
    jcfg, tcfg, jp, tp, x = _moe_inputs(T=16)
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    _, top_p, top_e = tmoe.route(tp, torch.from_numpy(x).reshape(16, -1),
                                 tcfg)
    assert top_e.tolist() == [[0, 1]] * 16
    assert torch.equal(top_p, torch.full((16, 2), 0.5))


def test_cast_keeps_router_and_tables_f32():
    jcfg, tcfg = _cfgs("mixtral-8x7b", total_routing=False,
                       dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    _, tp = _params(jcfg, tcfg, seed=9)
    cast_for_inference(tp, tcfg)
    block = tp["blocks"][0]
    assert block["moe"]["router"].dtype == torch.float32
    assert block["moe"]["w_gate"].dtype == torch.bfloat16
    assert block["attn"]["wq"].dtype == torch.bfloat16
    assert tp["embed"]["table"].dtype == torch.float32
    assert tp["lm_head"]["table"].dtype == torch.float32


@pytest.mark.parametrize("name", ["gemma3-12b", "mixtral-8x7b"])
def test_serve_engine_matches_jax_greedy(name):
    """The port's engine on the JAX engine's weights gives the JAX
    engine's greedy tokens: 2 slots, max_len 96 (the local layers' caches
    are 64-slot rings), prompts of 70, 5 and 70 tokens, 8 new tokens each
    (the long prompts decode across the wrap).  mixtral with total
    routing."""
    jcfg, tcfg = _cfgs(name)
    jeng = JServeEngine(jcfg, slots=2, max_len=96)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (70, 5, 70)]
    jreqs = [JRequest(i, p, max_new=8) for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                  tcfg, "cpu")
    eng = ServeEngine(tcfg, slots=2, max_len=96, device="cpu", params=params)
    reqs = [Request(i, p, max_new=8) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    for p, kind in enumerate(tcfg.block_pattern):
        T = eng.cache[f"pos{p}"]["k"].shape[2]
        assert T == (tcfg.sliding_window if kind == "local" else 96)


TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # as tests/test_torch_flash.py


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 128, 256])
def test_flash_plain_version_window_matches_jax(hd, dtype):
    """``ref.flash_attention_ref(window=W)`` at S = 256, W = 64 against the
    JAX package's ``mha_full`` and ``mha_chunked`` with the window, which
    compute its sliding-window layers (its Pallas kernel has none): on
    heads pre-broadcast, and through the port's ``mha_chunked`` with GQA
    (H = 4 over 2 kv heads); without the window the output differs."""
    B, S, H, KVH, W = 1, 256, 4, 2, 64
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
            for _ in range(2))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    pos = jnp.arange(S)
    jargs = tuple(jnp.asarray(a, jd) for a in (q, k, v)) + (pos, pos)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    broadcast = ref.flash_attention_ref(
        tq, tk.repeat_interleave(2, dim=2), tv.repeat_interleave(2, dim=2),
        window=W)
    for got in (broadcast, tattn.mha_chunked(tq, tk, tv, window=W)):
        for want in (jattn.mha_full(*jargs, window=W),
                     jattn.mha_chunked(*jargs, window=W, q_block=64,
                                       kv_block=32)):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       atol=TOL[dtype])
    unwindowed = tattn.mha_chunked(tq, tk, tv).float().numpy()
    assert np.abs(unwindowed - broadcast.float().numpy()).max() > 0.1
