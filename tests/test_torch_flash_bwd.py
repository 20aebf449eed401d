"""The flash attention's training pair against the JAX package, on the CPU.

The forward's log-sum-exp (``ref.flash_attention_fwd_ref``) against
``_chunk_fwd``'s, and the backward's plain version
(``ref.flash_attention_bwd_ref``) and the autograd Function around the
flash path (``attention.FlashAttention``, which on CPU tensors runs the
plain versions) against ``jax.vjp`` of the JAX package's ``mha_chunked``,
whose custom VJP is the rule the CUDA backward kernel ports
(``_mha_bwd_rule``).  Small blocks (S 256, q blocks 64, kv blocks 128)
so that JAX's backward walks several block pairs; causal, a window of 64,
GQA (4 query heads over 2 kv heads), head dims 16 and 64; inputs from a
numpy seed.

Tolerances: f32, 1e-5 of each gradient's largest magnitude (the same
arithmetic summed in other orders); bf16, the port's gradient no farther
from the f32 gradient of the same (bf16) inputs than twice JAX's own bf16
gradient is (JAX rounds each block pair's partial products to bf16, the
port only its result).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn

S, Q_BLOCK, KV_BLOCK = 256, 64, 128
CASES = [(16, 0), (64, 0), (16, 64), (64, 64)]      # (hd, window)


def _inputs(hd, B=2, H=4, KVH=2, seed=0):
    rng = np.random.default_rng(seed + hd)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
    dout = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return q, k, v, dout


def _jax_vjp(q, k, v, dout, window, dtype=jnp.float32):
    pos = jnp.arange(S)

    def f(q, k, v):
        return jattn.mha_chunked(q, k, v, pos, pos, causal=True,
                                 window=window, q_block=Q_BLOCK,
                                 kv_block=KV_BLOCK)

    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(dout).astype(dtype))
    return np.asarray(out.astype(jnp.float32)), [
        np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_grads(q, k, v, dout, window, dtype=torch.float32):
    """The port's flash path under autograd: (out, [dq, dk, dv])."""
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_(True)
                  for a in (q, k, v))
    out = tattn.mha_chunked(qt, kt, vt, causal=True, window=window)
    grads = torch.autograd.grad(out, (qt, kt, vt),
                                torch.from_numpy(dout).to(dtype))
    return out.detach().float().numpy(), [g.float().numpy() for g in grads]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("hd,window", CASES)
def test_lse_matches_chunk_fwd(hd, window):
    """``flash_attention_fwd_ref``'s (out, lse) against ``_chunk_fwd``'s
    (lse (B, KVH, G, S) is the port's (B, H, S), head h = kvh G + g)."""
    q, k, v, _ = _inputs(hd)
    pos = jnp.arange(S)
    jout, jlse = jattn._chunk_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), pos, pos, True, window,
                                  Q_BLOCK, KV_BLOCK)
    G = q.shape[2] // k.shape[2]
    kt, vt = (torch.from_numpy(a).repeat_interleave(G, dim=2) for a in (k, v))
    out, lse = ref.flash_attention_fwd_ref(torch.from_numpy(q), kt, vt,
                                           causal=True, window=window)
    assert lse.shape == (q.shape[0], q.shape[2], S) and lse.dtype == \
        torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(
        lse.shape), rtol=1e-5, atol=1e-5)
    assert _rel(out.numpy(), np.asarray(jout)) < 1e-5
    # the forward's output is the serving path's, bit for bit
    assert torch.equal(out, ref.flash_attention_ref(
        torch.from_numpy(q), kt, vt, causal=True, window=window))


@pytest.mark.parametrize("hd,window", CASES)
def test_bwd_ref_matches_jax_vjp_f32(hd, window):
    """The plain backward on the broadcast heads, the G query heads' dk and
    dv summed into their kv head, against JAX's custom VJP."""
    q, k, v, dout = _inputs(hd)
    _, jgrads = _jax_vjp(q, k, v, dout, window)
    G = q.shape[2] // k.shape[2]
    qt, do = torch.from_numpy(q), torch.from_numpy(dout)
    kt, vt = (torch.from_numpy(a).repeat_interleave(G, dim=2) for a in (k, v))
    out, lse = ref.flash_attention_fwd_ref(qt, kt, vt, causal=True,
                                           window=window)
    dq, dk, dv = ref.flash_attention_bwd_ref(qt, kt, vt, out, do, lse,
                                             causal=True, window=window)
    B, _, KVH, hd_ = k.shape
    dk, dv = (t.reshape(B, S, KVH, G, hd_).sum(3) for t in (dk, dv))
    for got, want in zip((dq, dk, dv), jgrads):
        assert _rel(got.numpy(), want) < 1e-5
    # query blocks of the plain version change no value
    small = ref.flash_attention_bwd_ref(qt, kt, vt, out, do, lse,
                                        causal=True, window=window,
                                        max_elems=2 * 4 * 48 * S)
    for a, b in zip(small, ref.flash_attention_bwd_ref(
            qt, kt, vt, out, do, lse, causal=True, window=window)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("hd,window", CASES)
def test_autograd_function_matches_jax_vjp_f32(hd, window):
    """``mha_chunked`` under autograd (``FlashAttention`` with the GQA
    broadcast outside it) against JAX's VJP of its ``mha_chunked``."""
    q, k, v, dout = _inputs(hd)
    jout, jgrads = _jax_vjp(q, k, v, dout, window)
    out, grads = _torch_grads(q, k, v, dout, window)
    assert _rel(out, jout) < 1e-5
    for got, want in zip(grads, jgrads):
        assert got.shape == want.shape
        assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("hd,window", CASES)
def test_bf16_gradients_within_twice_jax_error(hd, window):
    """bf16 inputs: each gradient of the port (p and ds rounded to bf16
    where JAX rounds them) no farther from the f32 gradient of the same
    inputs than twice JAX's own bf16 gradient."""
    q, k, v, dout = (_bf16(a) for a in _inputs(hd))
    _, exact = _jax_vjp(q, k, v, dout, window)            # f32 of bf16 data
    _, jgrads = _jax_vjp(q, k, v, dout, window, jnp.bfloat16)
    _, grads = _torch_grads(q, k, v, dout, window, torch.bfloat16)
    for got, jax_bf16, want in zip(grads, jgrads, exact):
        assert _rel(got, want) <= 2 * _rel(jax_bf16, want), \
            (_rel(got, want), _rel(jax_bf16, want))


def test_masked_rows_and_keys_give_zero_not_nan():
    """A window of 1 (each row sees its own key only) and a row block whose
    first keys are all masked: every gradient finite, and dv of a key is
    exactly dout of its own row (p = 1 there, 0 elsewhere)."""
    q, k, v, dout = _inputs(16, B=1, H=2, KVH=2)
    qt, kt, vt, do = (torch.from_numpy(a) for a in (q, k, v, dout))
    out, lse = ref.flash_attention_fwd_ref(qt, kt, vt, causal=True, window=1)
    dq, dk, dv = ref.flash_attention_bwd_ref(qt, kt, vt, out, do, lse,
                                             causal=True, window=1)
    for t in (dq, dk, dv):
        assert bool(torch.isfinite(t).all())
    np.testing.assert_allclose(dv.numpy(), dout, rtol=1e-6, atol=1e-6)


def test_no_grad_forward_writes_no_lse(monkeypatch):
    """Without gradients (every serving call) the flash path is the plain
    forward alone; with them, the training forward that returns lse."""
    calls = []
    real_fwd, real = ops.flash_attention_fwd, ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention_fwd",
                        lambda *a, **kw: calls.append("fwd") or
                        real_fwd(*a, **kw))
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append("serve") or
                        real(*a, **kw))
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(16))
    with torch.no_grad():
        tattn.mha_chunked(q.requires_grad_(True), k, v, causal=True)
    tattn.mha_chunked(q, k, v, causal=True)
    tattn.mha_chunked(q.detach(), k, v, causal=True)
    assert calls == ["serve", "fwd", "serve"]


def test_cuda_launcher_refuses_cpu_tensors():
    q = torch.zeros((1, 8, 2, 16))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_bwd(q, q, q, q, q, lse)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, q, q, return_lse=True)
    assert tflash.flash_attention_bwd.launches == 0
    assert "flash_attention_bwd" in ops.launch_counts()
