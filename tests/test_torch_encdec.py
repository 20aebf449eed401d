"""The port's encoder-decoder (whisper-tiny) against the JAX package, on
the CPU.

``whisper-tiny``'s reduced form (f32, d 64, 4 heads over 2 kv heads,
head_dim 16, 2 encoder and 2 decoder layers, 16 frames, learned
positions, layer norms, biased GELU MLPs) with the JAX package's own
weights, carried across by ``convert.lm_params_from_numpy``; frames and
tokens from seeded numpy.  The JAX engine cannot serve it (fault 1
below), so the port's engine is held to JAX's ``encdec_prefill`` and
``encdec_decode`` driven directly.

Tolerances (f32): a layer within 1e-5 of the largest magnitude; logits
and cache leaves within 1e-4; decode against prefill(S + 1) within 2e-3,
the JAX package's own bound (``tests/test_models.py``); bf16 within
3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as par
from repro.launch.serve import Request as JRequest
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.factory import cache_specs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models.factory import cast_for_inference, init_cache

NAME = "whisper-tiny"


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = par.cfgs(NAME)
    jp, _ = par.params(jcfg, tcfg)
    # the norms' scales and biases and the MLPs' biases moved off their
    # init (ones, zeros), so that each one is exercised
    rng = np.random.default_rng(7)

    def moved(path, a):
        if path[-1].key in ("scale", "bias", "b_up", "b_down"):
            return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    jp = jax.tree_util.tree_map_with_path(moved, jp)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _frames(jcfg, B=2, seed=3):
    return par.normal((B, jcfg.enc_positions, jcfg.d_model), seed=seed)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_layernorm_and_biased_mlp_match_jax(model):
    jcfg, tcfg, jp, tp = model
    x = par.normal((2, 9, tcfg.d_model), seed=1, scale=3.0)
    lp = _layer(jp["dec_layers"], 1)
    tl = tp["dec_layers"][1]
    assert par.rel(tlayers.layernorm(tl["ln1"], torch.from_numpy(x), 1e-5),
                   jlayers.layernorm(lp["ln1"], jnp.asarray(x), 1e-5)) < 1e-5
    assert par.rel(tlayers.mlp(tl["mlp"], torch.from_numpy(x), "gelu"),
                   jlayers.mlp(lp["mlp"], jnp.asarray(x), "gelu")) < 1e-5


def test_attention_fwd_and_cross_attention_match_jax(model):
    """The encoder's non-causal self-attention and the decoder's
    cross-attention (GQA: 4 query heads over 2 kv heads)."""
    jcfg, tcfg, jp, tp = model
    x = par.normal((2, 16, tcfg.d_model), seed=2)
    enc = par.normal((2, 16, tcfg.d_model), seed=3)
    want = jattn.attention_fwd(_layer(jp["enc_layers"], 0)["attn"],
                               jnp.asarray(x), jcfg, causal=False,
                               impl="full")
    got = tattn.attention_fwd(tp["enc_layers"][0]["attn"],
                              torch.from_numpy(x), tcfg, causal=False,
                              impl="full")
    assert par.rel(got, want) < 1e-5
    q = par.normal((2, 5, tcfg.d_model), seed=4)
    want = jencdec.cross_attention(_layer(jp["dec_layers"], 0)["xattn"],
                                   jnp.asarray(q), jnp.asarray(enc), jcfg)
    got = tencdec.cross_attention(tp["dec_layers"][0]["xattn"],
                                  torch.from_numpy(q), torch.from_numpy(enc),
                                  tcfg)
    assert par.rel(got, want) < 1e-5


def test_encode_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    frames = _frames(jcfg)
    want = jencdec.encode(jp, jcfg, jnp.asarray(frames))
    got = tencdec.encode(tp, tcfg, torch.from_numpy(frames))
    assert par.rel(got, want) < 1e-5


def test_params_round_trip_bitwise(model):
    """``enc_layers``/``dec_layers`` stacked over layers in JAX, lists in
    the port, and back."""
    jcfg, tcfg, jp, tp = model
    back = lm_params_to_numpy(tp, tcfg)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["full", "chunked"])
def test_prefill_matches_jax(model, impl):
    """Last logits and the cache tree (``self`` K/V stacked over the
    decoder layers, ``encoder_out``); the port's decoder self-attention
    through ``mha_full`` or the flash path's plain version."""
    jcfg, tcfg, jp, tp = model
    toks = par.tokens(2, 40, tcfg.vocab_size, seed=1)
    frames = _frames(jcfg)
    jlog, jcache = jencdec.encdec_prefill(jp, jcfg, jnp.asarray(toks),
                                          jnp.asarray(frames))
    tlog, tcache = tencdec.encdec_prefill(tp, tcfg, torch.from_numpy(toks),
                                          torch.from_numpy(frames),
                                          attn_impl=impl)
    assert par.rel(tlog, jlog) < 1e-4
    par.same_leaves(tcache, jcache)


def test_decode_matches_jax_and_prefill(model):
    """Two decodes from prefill(S) against JAX's encdec_decode on the same
    cache and against prefill(S + 1), prefill(S + 2)."""
    jcfg, tcfg, jp, tp = model
    B, S = 2, 21
    toks = par.tokens(B, S + 2, tcfg.vocab_size, seed=2)
    frames = torch.from_numpy(_frames(jcfg, seed=4))
    _, cache = tencdec.encdec_prefill(tp, tcfg, torch.from_numpy(toks[:, :S]),
                                      frames)
    cache = par.grown(cache, S, S + 2)
    for i in (0, 1):
        pos = np.full((B,), S + i)
        step = toks[:, S + i:S + i + 1]
        jlog, jnew = jencdec.encdec_decode(jp, jcfg, jnp.asarray(step),
                                           par.jtree(cache), jnp.asarray(pos))
        tlog, cache = tencdec.encdec_decode(tp, tcfg, torch.from_numpy(step),
                                            cache, torch.from_numpy(pos))
        assert par.rel(tlog, jlog) < 1e-4, i
        par.same_leaves(cache, jnew)
        want, _ = tencdec.encdec_prefill(
            tp, tcfg, torch.from_numpy(toks[:, :S + i + 1]), frames)
        assert par.rel(tlog, want) < 2e-3, i


def test_init_cache_is_the_prefill_layout():
    jcfg, tcfg = par.cfgs(NAME)
    want = cache_specs(jcfg, 3, 40)
    got = init_cache(tcfg, 3, 40, "cpu")
    assert sorted(got) == sorted(want)
    assert sorted(got["self"]) == sorted(want["self"])
    for n, spec in list(want["self"].items()) + [
            ("encoder_out", want["encoder_out"])]:
        t = got["self"][n] if n in got["self"] else got[n]
        assert tuple(t.shape) == spec.shape, n
        assert str(t.dtype)[6:] == str(spec.dtype)


def test_jax_engine_cannot_splice_the_encoder_output(model):
    """Fault 1 of the JAX package (ROADMAP Queue 3): its engine writes
    every cache leaf at ``[:, slot:slot+1]``, and ``encoder_out`` (B, F,
    d) has no period axis."""
    jcfg, _, jp, _ = model
    eng = par.jax_engine(jcfg, jp, slots=2, max_len=32)
    eng.submit(JRequest(0, [1, 2, 3], max_new=2))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        eng.run()


def _greedy_jax(jp, jcfg, decode, prompt, max_new, max_len):
    """One request through JAX's encdec_prefill and ``decode`` (its
    encdec_decode, jitted) at batch 1, zero frames as the engines feed
    them, greedy."""
    frames = jnp.zeros((1, jcfg.enc_positions, jcfg.d_model), jcfg.dtype)
    logits, cache = jencdec.encdec_prefill(
        jp, jcfg, jnp.asarray([prompt]), frames)
    pad = max_len - len(prompt)
    cache = {"self": {n: jnp.pad(c, ((0, 0), (0, 0), (0, pad), (0, 0),
                                     (0, 0)))
                      for n, c in cache["self"].items()},
             "encoder_out": cache["encoder_out"]}
    out = [int(jnp.argmax(logits[0]))]
    pos = len(prompt)
    while len(out) < max_new and pos < max_len - 1:
        logits, cache = decode(jnp.asarray([[out[-1]]]), cache,
                               jnp.asarray([pos]))
        out.append(int(jnp.argmax(logits[0])))
        pos += 1
    return out


def test_serve_engine_matches_jax_greedy(model):
    """The port's engine (2 slots, max_len 48, prompts of 20, 4 and 9
    tokens, 6 new tokens each; the third request takes a freed slot and
    its ``encoder_out`` row) gives the greedy tokens of JAX's prefill and
    decode driven directly, request by request."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (20, 4, 9)]
    eng = ServeEngine(tcfg, slots=2, max_len=48, device="cpu", params=tp)
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    decode = jax.jit(lambda t, c, p: jencdec.encdec_decode(jp, jcfg, t, c, p))
    assert [r.out for r in reqs] == [_greedy_jax(jp, jcfg, decode, p, 6, 48)
                                     for p in prompts]
    assert tuple(eng.cache["encoder_out"].shape) == (2, tcfg.enc_positions,
                                                     tcfg.d_model)


def test_bf16_prefill_close_to_jax(model):
    """Under bf16 the tables stay f32 (the learned positions and the
    layers' matrices cast); the prefill's logits within 3e-2 of JAX's
    bf16 prefill on its f32 master weights."""
    jcfg, tcfg = par.cfgs(NAME, dtype=jnp.bfloat16)
    jp = model[2]
    tp = cast_for_inference(lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu"), tcfg)
    assert tp["embed"]["table"].dtype == torch.float32
    assert tp["dec_pos"].dtype == torch.bfloat16
    assert tp["dec_layers"][0]["xattn"]["wq"].dtype == torch.bfloat16
    assert tp["dec_layers"][0]["mlp"]["b_up"].dtype == torch.float32
    toks = par.tokens(1, 24, tcfg.vocab_size, seed=1)
    frames = _frames(jcfg, B=1, seed=5)
    jlog, jcache = jencdec.encdec_prefill(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(frames).astype(jnp.bfloat16))
    tlog, tcache = tencdec.encdec_prefill(
        tp, tcfg, torch.from_numpy(toks),
        torch.from_numpy(frames).to(torch.bfloat16))
    assert tlog.dtype == torch.float32
    assert tcache["encoder_out"].dtype == torch.bfloat16
    assert par.rel(tlog, jlog) < 3e-2
