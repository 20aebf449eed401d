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

The bf16 CUDA kernel's arithmetic is emulated here in plain torch
(``_kernel_emulation``: its tiles, f32 scores of bf16 q and k, the online
softmax in base 2, P split into bf16 ``hi + lo`` for two products with
the bf16 V, f32 accumulation) and held to the plain version under
``chip_smoke.py``'s per-element limit for the kernel: 2 bf16 ulps of
|plain| + 2e-5.  A single bf16 P breaks that limit, which is why the
kernel splits it.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref
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


# ---------------------------------------------------------------------------
# the bf16 kernel's arithmetic
# ---------------------------------------------------------------------------

BQ = 128                   # the kernel's query rows a block
BK = 128                   # its key rows a tile (static_assert(BK == BQ))
LOG2E = 1.4426950408889634


def _kernel_emulation(q, k, v, *, causal=True, split=True):
    """The bf16 kernel's arithmetic on CPU tensors: blocks of BQ query
    rows walk key tiles of BK rows; scores are f32 sums of the exact
    bf16 products; the online softmax works in base 2 on the raw scores
    (``exp2(s * c - m * c)``, c = log2(e) / sqrt(hd)) with masked scores
    -1e30; P.V is ``hi V + lo V`` with ``hi = bf16(P)``, ``lo = bf16(P -
    hi)`` (``split=False``: ``hi V`` alone) accumulated in f32; the output
    is ``acc / max(l, 1e-30)`` rounded once to bf16."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    c = LOG2E / math.sqrt(hd)
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # (B,H,.,hd)
    out = torch.empty((B, H, S, hd))
    for q0 in range(0, S, BQ):
        rows = torch.arange(q0, min(q0 + BQ, S))
        qt = qf[:, :, rows]
        m = torch.full((B, H, len(rows), 1), ref.FLASH_NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, len(rows), hd))
        kv_end = min(T, q0 + BQ) if causal else T
        for k0 in range(0, kv_end, BK):
            cols = torch.arange(k0, min(k0 + BK, T))
            s = qt @ kf[:, :, cols].transpose(-1, -2)
            if causal:
                s = s.masked_fill(cols[None, :] > rows[:, None],
                                  ref.FLASH_NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2((m - m_new) * c)
            p = torch.exp2(s * c - m_new * c)
            l = l * corr + p.sum(-1, keepdim=True)
            hi = p.bfloat16().float()
            pv = hi @ vf[:, :, cols]
            if split:
                pv = pv + (p - hi).bfloat16().float() @ vf[:, :, cols]
            acc = acc * corr + pv
            m = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30)
    return out.transpose(1, 2).bfloat16()


def _bf16_limit(plain):
    """chip_smoke.py's per-element limit: 2 bf16 ulps of |plain| + 2e-5."""
    a = plain.float().abs().clamp_min(2.0 ** -126)
    return 2e-5 + 2 * torch.exp2(torch.floor(torch.log2(a)) - 7)


def _ratio(got, plain):
    """The worst |got - plain| over its limit, element by element."""
    return float(((got.float() - plain.float()).abs()
                  / _bf16_limit(plain)).max())


def _bf16_qkv(S, T, hd, seed, H=2):
    return tuple(torch.from_numpy(a).bfloat16()
                 for a in _qkv(1, S, T, H, H, hd, seed))


SHAPES = [(256, 256, True), (300, 77, True), (1000, 1037, True),
          (130, 130, False)]
# one row or key either side of the 128-row tiles, and S < T
RAGGED = [(127, 127, True), (129, 129, True), (77, 300, True),
          (129, 255, False)]


@pytest.mark.parametrize("S,T,causal", SHAPES + RAGGED)
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_kernel_arithmetic_matches_plain_version(hd, S, T, causal):
    q, k, v = _bf16_qkv(S, T, hd, seed=hd + S + T)
    got = _kernel_emulation(q, k, v, causal=causal)
    plain = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _ratio(got, plain) <= 1.0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_kernel_arithmetic_matches_pallas_kernel(hd, causal):
    """S = T = 256, two of the Pallas kernel's 128-row blocks each way."""
    q, k, v = _bf16_qkv(256, 256, hd, seed=3 * hd)
    got = _kernel_emulation(q, k, v, causal=causal)
    want = jflash(*(jnp.asarray(_np(x), jnp.bfloat16) for x in (q, k, v)),
                  causal=causal, q_block=128, kv_block=128, interpret=True)
    want = torch.from_numpy(_np(want)).bfloat16()
    assert _ratio(got, want) <= 1.0


@pytest.mark.parametrize("S,T,causal", SHAPES)
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_single_bf16_p_breaks_the_limit(hd, S, T, causal):
    """Without ``lo`` P is rounded to 2^-9 relative, and the product leaves
    the limit, by more than 10x at these shapes, where outputs are
    small."""
    q, k, v = _bf16_qkv(S, T, hd, seed=hd + S + T)
    plain = ref.flash_attention_ref(q, k, v, causal=causal)
    assert _ratio(_kernel_emulation(q, k, v, causal=causal, split=False),
                  plain) > 10.0


def test_cuda_launcher_refuses_cpu_tensors():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, q, q)
    assert tflash.flash_attention.launches == 0
