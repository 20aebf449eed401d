"""The port's LM serving path against the JAX package, on the CPU.

``qwen1.5-0.5b``'s reduced form (f32, 2 layers, d=64, 4 heads over 2 kv
heads, head_dim 16, vocab 512) with the JAX package's own ``init_lm``
weights, carried across by ``convert.lm_params_from_numpy``.  On CPU
tensors the chunked attention path runs the flash kernel's plain version.

Tolerances (f32): layers within 1e-5 (the same formulas; XLA and torch
round sin/cos/pow and sum in their own orders); logits and caches within
1e-4 relative to the largest |logit| (two layers of such differences);
decode against prefill(S+1) within 2e-3, the JAX package's own bound
(``tests/test_models.py``).  bf16: 3e-2 of the largest |logit| (8-bit
mantissas, rounded at other places by XLA and torch).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import get_config as jget_config
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.factory import init_cache, make_model

NAME = "qwen1.5-0.5b"


def _cfgs(**kw):
    jcfg = dataclasses.replace(jget_config(NAME).reduced(), **kw)
    tkw = dict(kw)
    if "dtype" in tkw:
        tkw["dtype"] = getattr(torch, jnp.dtype(tkw["dtype"]).name)
    return jcfg, dataclasses.replace(get_config(NAME).reduced(), **tkw)


def _params(jcfg, tcfg, seed=0):
    jp = jlm.init_lm(jax.random.key(seed), jcfg)
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                    "cpu")


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_layers_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                        torch.from_numpy(x), 1e-6).numpy(),
        np.asarray(jlayers.rmsnorm({"scale": jnp.asarray(scale)},
                                   jnp.asarray(x), 1e-6)), atol=1e-5)
    pos = np.arange(7) + 4000
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           1e6).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      1e6)), atol=1e-5)
    h = rng.standard_normal((5, 64)).astype(np.float32)
    w = {n: rng.standard_normal(s).astype(np.float32) / 8 for n, s in
         (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    for kind in ("swiglu", "geglu", "gelu"):
        np.testing.assert_allclose(
            tlayers.mlp({n: torch.from_numpy(a) for n, a in w.items()},
                        torch.from_numpy(h), kind).numpy(),
            np.asarray(jlayers.mlp({n: jnp.asarray(a) for n, a in w.items()},
                                   jnp.asarray(h), kind)), atol=1e-5)


def test_params_round_trip_bitwise(model):
    jcfg, tcfg, jp, tp = model
    back = lm_params_to_numpy(tp, tcfg)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert len(tp["blocks"]) == tcfg.n_layers


@pytest.mark.parametrize("impl", ["full", "chunked"])
def test_prefill_matches_jax(model, impl):
    jcfg, tcfg, jp, tp = model
    toks = _tokens(2, 256, tcfg.vocab_size)
    jlog, jcache = jlm.lm_prefill(jp, jcfg, jnp.asarray(toks),
                                  attn_impl=impl)
    tlog, tcache = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks),
                                  attn_impl=impl)
    assert tuple(tlog.shape) == (2, tcfg.vocab_size)
    assert _rel(tlog, jlog) < 1e-4
    assert list(tcache) == ["pos0"]
    for name in ("k", "v"):
        want = np.asarray(jcache["pos0"][name])
        assert tcache["pos0"][name].shape == want.shape
        assert _rel(tcache["pos0"][name], want) < 1e-4


def test_prefill_auto_takes_the_flash_path_at_4096():
    """One layer at S=4096: ``attend``'s rule picks the chunked branch in
    both packages (a spy counts the port's flash calls)."""
    jcfg, tcfg = _cfgs(n_layers=1)
    jp, tp = _params(jcfg, tcfg, seed=3)
    toks = _tokens(1, 4096, tcfg.vocab_size, seed=3)
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "flash_attention", spy)
    try:
        tlog, _ = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks))
    finally:
        mp.undo()
    assert calls == [(1, 4096, tcfg.n_heads, tcfg.resolved_head_dim)]
    jlog, _ = jlm.lm_prefill(jp, jcfg, jnp.asarray(toks))
    assert _rel(tlog, jlog) < 1e-4


def _grown(cache, T):
    """A prefill cache tree (leaves (n_periods, B, S, KVH, hd)) copied
    into zeroed leaves of length T."""
    return {p: {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0,
                                               T - c.shape[2]))
                for n, c in entry.items()} for p, entry in cache.items()}


def test_decode_matches_jax_and_prefill(model):
    """lm_decode against JAX's on the same cache, and prefill(S) +
    decode(token S) against prefill(S+1)."""
    jcfg, tcfg, jp, tp = model
    B, S = 2, 31
    toks = _tokens(B, S + 1, tcfg.vocab_size, seed=2)
    ref_logits, _ = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks))
    _, cache = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks[:, :S]))
    cache = _grown(cache, S + 1)
    jcache = {p: {n: jnp.asarray(c.numpy().copy()) for n, c in e.items()}
              for p, e in cache.items()}
    position = np.full((B,), S)
    new = torch.from_numpy(toks[:, S:])
    tlog, tcache = tlm.lm_decode(tp, tcfg, new, cache,
                                 torch.from_numpy(position))
    jlog, jnew = jlm.lm_decode(jp, jcfg, jnp.asarray(toks[:, S:]), jcache,
                               jnp.asarray(position))
    assert _rel(tlog, jlog) < 1e-4
    assert _rel(tcache["pos0"]["k"], jnew["pos0"]["k"]) < 1e-4
    assert _rel(tlog, ref_logits) < 2e-3


def test_decode_past_the_cache_writes_nothing(model):
    """A retired slot decodes at a position past the cache: JAX's scatter
    drops that write, and so does the port."""
    _, tcfg, _, tp = model
    cache = init_cache(tcfg, 2, 8, "cpu")["pos0"]
    before = {n: c.clone() for n, c in cache.items()}
    logits, _ = tlm.lm_decode(tp, tcfg, torch.tensor([[3], [4]]),
                              {"pos0": cache}, torch.tensor([2, 8]))
    assert bool(torch.isfinite(logits).all())
    assert not torch.equal(cache["k"][:, 0, 2], before["k"][:, 0, 2])
    assert torch.equal(cache["k"][:, 1], before["k"][:, 1])
    assert torch.equal(cache["v"][:, 1], before["v"][:, 1])


def test_serve_engine_matches_jax_greedy():
    """The JAX package's engine workload (``tests/test_system.py``):
    qwen reduced, 2 slots, max_len 48, 5 requests of 5 tokens, max_new 4;
    the port's engine on the JAX engine's weights gives the same tokens."""
    jcfg, tcfg = _cfgs()
    jeng = JServeEngine(jcfg, slots=2, max_len=48)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, 5).tolist() for _ in range(5)]
    jreqs = [JRequest(i, p, max_new=4) for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                  tcfg, "cpu")
    eng = ServeEngine(tcfg, slots=2, max_len=48, device="cpu", params=params)
    reqs = [Request(i, p, max_new=4) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    steps = eng.run()
    assert steps > 0 and all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_serve_engine_sampling_seeded_and_checked():
    """Temperature sampling is a function of the seed; prompts that do not
    fit or hold out-of-vocabulary tokens are refused; the default device
    is the card."""
    cfg = get_config(NAME + "-reduced")
    outs = []
    for _ in range(2):
        eng = ServeEngine(cfg, slots=2, max_len=32, temperature=0.8, seed=4,
                          device="cpu")
        reqs = [Request(i, [1, 2, 3 + i], max_new=5) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(o) == 5 and all(0 <= t < cfg.vocab_size for t in o)
               for o in outs[0])
    with pytest.raises(ValueError, match="prompt"):
        eng.submit(Request(9, list(range(33))))
    with pytest.raises(ValueError, match="token"):
        eng.submit(Request(9, [cfg.vocab_size]))
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeEngine(cfg)
    finally:
        mp.undo()


def test_bf16_prefill_close_to_jax():
    jcfg, tcfg = _cfgs(dtype=jnp.bfloat16)
    jp, tp = _params(jcfg, tcfg, seed=1)
    toks = _tokens(1, 64, tcfg.vocab_size, seed=1)
    for impl in ("full", "chunked"):
        jlog, _ = jlm.lm_prefill(jp, jcfg, jnp.asarray(toks), attn_impl=impl)
        tlog, _ = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks),
                                 attn_impl=impl)
        assert tlog.dtype == torch.float32
        assert _rel(tlog, jlog) < 3e-2, impl


# the JAX package's architectures, in its registry's order
REGISTERED = ("qwen1.5-0.5b", "gemma3-12b", "llama3-8b", "phi3-medium-14b",
              "whisper-tiny", "mixtral-8x7b", "dbrx-132b", "jamba-v0.1-52b",
              "chameleon-34b", "xlstm-125m")


@pytest.mark.parametrize("name", REGISTERED)
def test_registry(name):
    """Every architecture of the JAX package is registered, in its order,
    with its fields (dtype as a torch dtype; the reduced forms f32), and
    its reduced form serves: ``make_model``, ``init_cache`` and one short
    request through ``ServeEngine`` on the CPU."""
    jcfg = jget_config(name)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    assert ARCH_NAMES == REGISTERED == JARCH_NAMES
    cfg = get_config(name)
    assert {f: getattr(cfg, f) for f in fields} == fields
    assert cfg.dtype == torch.bfloat16
    small = get_config(name + "-reduced")
    assert small.dtype == torch.float32
    tlm.check_supported(cfg)
    model = make_model(small)
    assert sorted(model) == ["decode", "init", "prefill"]
    assert init_cache(small, 2, 16, "cpu")
    eng = ServeEngine(small, slots=1, max_len=16, device="cpu")
    req = Request(0, [1, 2, 3], max_new=2)
    eng.submit(req)
    eng.run()
    assert req.done and len(req.out) == 2
