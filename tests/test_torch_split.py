"""The port's split layout path against the JAX package, on the CPU.

The split route gathers the edge batch's coordinates, computes the forces
(the ``largevis_grads`` kernel for ``inv_quadratic``, autograd of the
loss for any other ``prob_fn``) and scatters the updates in the canonical
per-edge order.  On CPU tensors ``kernels/ops.py`` runs the kernels'
plain versions; the CUDA kernels are held to these on the card by
``chip_smoke.py``.

Tolerances:
* the forces and the split edge step are bitwise the *eager* JAX oracle
  (the port and the CUDA kernel round every operation on its own);
* against the interpreted Pallas body, atol 2e-6: jit contracts
  multiply-adds into FMAs and moves a force by up to 2 f32 ulps at
  |g| ~ 4;
* autograd forces against JAX's jitted ``grads_autodiff``: rtol 1e-5,
  atol 1e-5 (the two frameworks' log1p / logaddexp and their gradients
  round differently; the largest difference seen is 3.3e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout_engine as jengine
from repro.core import objective as jobj
from repro.data.synthetic import gaussian_mixture
from repro.kernels import largevis_grad as jgrad
from repro.kernels import ref as jref
import repro_torch
from repro_torch import LargeVisConfig, RoutingConfig
from repro_torch.core import layout_engine, objective
from repro_torch.kernels import largevis_grad, largevis_step, ops

GAMMA, A, CLIP = 7.0, 1.0, 5.0


def T(x):
    return torch.from_numpy(np.array(x))


def _coords(B, M=5, s=2, seed=0, scale=3.0):
    """Gathered edge coordinates with about a sixth of negatives masked."""
    rng = np.random.default_rng(seed)
    yi = (rng.standard_normal((B, s)) * scale).astype(np.float32)
    yj = (rng.standard_normal((B, s)) * scale).astype(np.float32)
    yneg = (rng.standard_normal((B, M, s)) * scale).astype(np.float32)
    mask = (rng.random((B, M)) > 0.17).astype(np.float32)
    return yi, yj, yneg, mask


def _batch(N=50, B=4096, M=5, s=2, seed=0):
    """An edge batch on N rows; the default is dense with duplicates."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((N, s)) * 3.0).astype(np.float32)
    i = rng.integers(0, N, B).astype(np.int32)
    j = rng.integers(0, N, B).astype(np.int32)
    negs = rng.integers(0, N, (B, M)).astype(np.int32)
    mask = ((negs != i[:, None]) & (negs != j[:, None])).astype(np.float32)
    return y, i, j, negs, mask


# ---------------------------------------------------------------------------
# largevis_grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,M,s", [(4096, 5, 2), (37, 5, 2), (300, 3, 3),
                                   (64, 1, 1), (5, 0, 2)])
def test_largevis_grads_bitwise_eager_oracle(B, M, s):
    yi, yj, yneg, mask = _coords(B, M, s, seed=B + M)
    want = jref.largevis_grads_ref(jnp.asarray(yi), jnp.asarray(yj),
                                   jnp.asarray(yneg), gamma=GAMMA, a=A,
                                   clip=CLIP, neg_mask=jnp.asarray(mask))
    got = ops.largevis_grads(T(yi), T(yj), T(yneg), T(mask), gamma=GAMMA,
                             a=A, clip=CLIP)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_chunked_kernel_pads_odd_batches():
    """At an odd B the JAX package pads to a whole tile and runs the
    Pallas body; the port needs no padding and agrees within the jit's
    FMA rounding."""
    yi, yj, yneg, mask = _coords(4095, seed=9)
    want = jgrad.largevis_grads_chunked(
        jnp.asarray(yi), jnp.asarray(yj), jnp.asarray(yneg),
        jnp.asarray(mask), gamma=GAMMA, a=A, clip=CLIP, interpret=True)
    got = ops.largevis_grads(T(yi), T(yj), T(yneg), T(mask), gamma=GAMMA,
                             a=A, clip=CLIP)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-6)


# ---------------------------------------------------------------------------
# autograd probability functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prob_fn", ["inv_quadratic", "exp_quadratic"])
def test_grads_autodiff_matches_jax(prob_fn):
    yi, yj, yneg, mask = _coords(4095, seed=11, scale=1.5)
    args = [jnp.asarray(v) for v in (yi, yj, yneg, mask)]
    want = jobj.grads_autodiff(*args, prob_fn=prob_fn, a=A, gamma=GAMMA,
                               clip=CLIP)
    got = objective.grads_autodiff(T(yi), T(yj), T(yneg), T(mask),
                                   prob_fn=prob_fn, a=A, gamma=GAMMA,
                                   clip=CLIP)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    loss = objective.edge_batch_loss(T(yi), T(yj), T(yneg), T(mask),
                                     prob_fn=prob_fn, a=A, gamma=GAMMA)
    np.testing.assert_allclose(
        float(loss), float(jobj.edge_batch_loss(*args, prob_fn=prob_fn,
                                                a=A, gamma=GAMMA)),
        rtol=1e-5)


def test_softplus_is_jax_softplus_at_large_arguments():
    """``F.softplus`` returns x itself above 20; ``jax.nn.softplus`` keeps
    log1p(e^x).  The port computes JAX's."""
    d2 = np.array([0.0, 1.0, 19.5, 20.5, 40.0, 90.0], np.float32)
    want = np.asarray(jobj.log_f(jnp.asarray(d2), "exp_quadratic", A))
    got = objective.log_f(T(d2), "exp_quadratic", A).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_unknown_prob_fn_raises_value_error():
    for fn in (objective.log_f, objective.log_1mf):
        with pytest.raises(ValueError):
            fn(torch.ones(3), "inv_exp", A)


# ---------------------------------------------------------------------------
# the split route of apply_edge_batch
# ---------------------------------------------------------------------------

def _split_both(y, i, j, negs, mask, lr, n_frozen=0,
                prob_fn="inv_quadratic"):
    """(port's split route, JAX's eager split route) on the same inputs."""
    want = jengine.apply_edge_batch(
        jnp.asarray(y), jnp.asarray(i), jnp.asarray(j), jnp.asarray(negs),
        jnp.asarray(mask), jnp.asarray(lr), prob_fn=prob_fn, a=A,
        gamma=GAMMA, clip=CLIP, fused_step=False, n_frozen=n_frozen)
    got = layout_engine.apply_edge_batch(
        T(y), T(i), T(j), T(negs), T(mask),
        T(lr) if np.ndim(lr) else float(lr), prob_fn=prob_fn, a=A,
        gamma=GAMMA, clip=CLIP, layout_step="split", n_frozen=n_frozen)
    return got.numpy(), np.asarray(want)


def test_split_step_bitwise_jax_split_scalar_lr():
    got, want = _split_both(*_batch(seed=1), 0.37)
    np.testing.assert_array_equal(got, want)


def test_split_step_bitwise_jax_split_per_edge_lr_frozen_rows():
    y, i, j, negs, mask = _batch(seed=2)
    lr = np.random.default_rng(2).uniform(0.1, 1.0, i.shape[0]).astype(
        np.float32)
    got, want = _split_both(y, i, j, negs, mask, lr, n_frozen=17)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:17], y[:17])
    assert not np.array_equal(got[17:], y[17:])


def test_split_step_autodiff_close_to_jax():
    got, want = _split_both(*_batch(N=300, B=512, seed=3), 0.5,
                            prob_fn="exp_quadratic")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_frozen", [0, 20])
def test_split_equals_fused_bitwise(n_frozen):
    """Same batch, both routes of the port: bitwise, as the JAX package
    promises of its two routes."""
    y, i, j, negs, mask = _batch(seed=4)
    kw = dict(a=A, gamma=GAMMA, clip=CLIP, n_frozen=n_frozen)
    fused = layout_engine.apply_edge_batch(
        T(y), T(i), T(j), T(negs), T(mask), 0.8, layout_step="fused", **kw)
    split = layout_engine.apply_edge_batch(
        T(y), T(i), T(j), T(negs), T(mask), 0.8, layout_step="split", **kw)
    assert torch.equal(fused, split)


def test_scatter_add_ordered_adds_in_stream_order():
    """Duplicates accumulate one after another in stream order (a numpy
    loop), not last-write-wins."""
    rng = np.random.default_rng(5)
    y = rng.standard_normal((7, 2)).astype(np.float32)
    idx = rng.integers(0, 7, 300).astype(np.int64)
    upd = rng.standard_normal((300, 2)).astype(np.float32)
    want = y.copy()
    for u in range(idx.shape[0]):
        want[idx[u]] = want[idx[u]] + upd[u]
    got = ops.scatter_add_ordered(T(y), T(idx), T(upd))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# fused and split fits
# ---------------------------------------------------------------------------

def test_fit_fused_and_split_bitwise():
    """The port's counterpart of the JAX package's fused-vs-split parity
    tests in ``tests/test_fused_step.py``: the 2000-point fixture
    fitted through each route, the layout cut to 100 samples per node."""
    x, _ = gaussian_mixture(jax.random.key(0), 2000, 32, 8)
    x = np.asarray(x)
    base = dict(n_neighbors=15, n_trees=4, n_explore_iters=1, window=32,
                perplexity=10.0, samples_per_node=100, batch_size=4096)
    ys = [repro_torch.largevis(
              x, cfg=LargeVisConfig(**base, routing=RoutingConfig(
                  layout_step=step)), device="cpu").y
          for step in ("fused", "split")]
    assert bool(torch.isfinite(ys[0]).all())
    assert torch.equal(ys[0], ys[1])


def test_cuda_launchers_refuse_cpu_tensors_split():
    """The split path's launchers never take a CPU tensor: only the plain
    versions run there."""
    yi, yj, yneg, mask = _coords(8)
    with pytest.raises(ValueError):
        largevis_grad.largevis_grads(T(yi), T(yj), T(yneg), T(mask))
    with pytest.raises(ValueError):
        largevis_grad.largevis_grads_chunked(T(yi), T(yj), T(yneg), T(mask))
    with pytest.raises(ValueError):
        largevis_step.scatter_add_ordered(torch.zeros(4, 2),
                                          torch.zeros(3, dtype=torch.long),
                                          torch.zeros(3, 2))
    assert largevis_grad.largevis_grads.launches == 0
    assert largevis_step.scatter_add_ordered.launches == 0
