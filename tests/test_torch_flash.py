"""The port's flash attention against the JAX package, on the CPU.

The same numpy inputs go through the JAX package's Pallas kernel in
interpret mode (``repro.kernels.flash_attention``), its plain version
``repro.kernels.ref.flash_attention_ref``, and the port's
``ops.flash_attention``, which on CPU tensors runs the plain version
``repro_torch.kernels.ref.flash_attention_ref``.  The CUDA kernel itself
is held to that plain version on the card by ``chip_smoke.py``.

The Pallas kernel masks top-left (``kpos <= qpos``); JAX's plain version
masks bottom-right (``tril(k=T-S)``).  The port follows the kernel, so at
S < T with the causal mask it agrees with the Pallas kernel and not with
JAX's plain version.

Tolerances: f32 2e-5 (the same f32 softmax, summed in another order);
bf16 3e-2 (outputs of magnitude up to ~4 rounded to 8 bits: a few bf16
ulps where the two f32 results straddle a rounding boundary).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(B, S, T, H, KVH, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, KVH, hd)).astype(np.float32),
            rng.standard_normal((B, T, KVH, hd)).astype(np.float32))


def _np(x):
    x = x.float().numpy() if torch.is_tensor(x) else x
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T", [(128, 128), (64, 128)])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_plain_version_matches_pallas_kernel(hd, S, T, causal, dtype):
    q, k, v = _qkv(1, S, T, 2, 2, hd, seed=hd + S + T)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    got = ops.flash_attention(*(torch.from_numpy(a).to(td)
                                for a in (q, k, v)), causal=causal)
    assert got.dtype == td and tuple(got.shape) == q.shape
    want = jflash(jq, jk, jv, causal=causal, q_block=64, kv_block=64,
                  interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])
    jplain = _np(jref.flash_attention_ref(jq, jk, jv, causal=causal))
    if S == T or not causal:
        np.testing.assert_allclose(_np(got), jplain, atol=TOL[dtype])
    else:
        # JAX's plain version aligns the mask bottom-right: row 0 sees
        # T - S + 1 keys there, one key in the Pallas kernel and the port
        assert np.abs(_np(got) - jplain).max() > 0.1


def test_gqa_heads_repeat_interleave():
    """Query head h reads kv head h // G: the port's mha_chunked agrees
    with JAX's mha_chunked and mha_full at H=4, KVH=2; broadcasting the
    kv heads with ``repeat`` (h % KVH) would not."""
    B, S, H, KVH, hd = 2, 256, 4, 2, 16
    q, k, v = _qkv(B, S, S, H, KVH, hd, seed=5)
    pos = np.arange(S)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    got = tattn.mha_chunked(tq, tk, tv).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(pos), jnp.asarray(pos))
    np.testing.assert_allclose(got, np.asarray(jattn.mha_chunked(*jargs)),
                               atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jattn.mha_full(*jargs)),
                               atol=2e-5)
    np.testing.assert_allclose(
        tattn.mha_full(tq, tk, tv, tpos, tpos).numpy(),
        np.asarray(jattn.mha_full(*jargs)), atol=2e-5)
    wrong = ops.flash_attention(tq, tk.repeat(1, 1, H // KVH, 1),
                                tv.repeat(1, 1, H // KVH, 1)).numpy()
    assert np.abs(wrong - got).max() > 0.1


def test_mha_chunked_contract():
    """What the flash path refuses, as the JAX package does or cannot."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 3000, 3000, 2, 2, 16, 0))
    with pytest.raises(ValueError, match="multiple"):
        tattn.mha_chunked(q, k, v)                 # JAX asserts the same
    q, k, v = q[:, :64], k[:, :64], v[:, :64]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.mha_chunked(q, k, v, window=16)
    with pytest.raises(ValueError, match="impl"):
        tattn.attend(q, k, v, impl="pallas")


def test_attend_auto_rule_matches_jax():
    """The chunked branch exactly where JAX takes it: Sq*Sk > 2^22 and
    Sq >= 2048 (a spy on ops.flash_attention sees the calls)."""
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "flash_attention", spy)
    try:
        for S in (2048, 4096):
            q = torch.zeros((1, S, 1, 16))
            tattn.attend(q, q, q)
    finally:
        mp.undo()
    assert calls == [4096]


def test_cuda_launcher_refuses_cpu_tensors():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, q, q)
    assert tflash.flash_attention.launches == 0
