"""The port's edge weights and alias samplers against the JAX package.

From the same KNN graph (JAX's exact graph of a Gaussian mixture, passed
over as numpy): calibration and symmetrization agree within rtol 1e-5 —
not bitwise, since XLA lowers the ``/ 2N`` as a multiplication by the
reciprocal and reduces the logsumexp in its own order; the alias pairing
is bitwise the JAX construction run in float64 on the CPU; and every
sampler encodes the intended marginals.  (The JAX package builds its
device tables under ``jax.experimental.enable_x64``, which JAX 0.9
removed; the pairing is run here under ``jax.enable_x64(True)``.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn as jknn
from repro.core import perplexity as jperp
from repro.core import sampler as jsamp
from repro.data.synthetic import gaussian_mixture
from repro_torch.core import perplexity as tperp
from repro_torch.core import sampler as tsamp


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def graph():
    x, _ = gaussian_mixture(jax.random.key(1), 600, 16, 5)
    idx, dist = jknn.brute_force_knn(x, 20)
    p = jperp.calibrate_p(dist, 10.0)
    w = jperp.symmetrize(idx, p, tile=256)
    return np.asarray(idx), np.asarray(dist), np.asarray(p), np.asarray(w)


def test_calibrate_p_allclose(graph):
    idx, dist, p, _ = graph
    got = tperp.calibrate_p(T(dist), 10.0).numpy()
    np.testing.assert_allclose(got, p, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-4)


def test_symmetrize_allclose(graph):
    idx, _, p, w = graph
    got = tperp.symmetrize(T(idx), T(p), tile=128).numpy()
    np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-10)


def test_perplexity_hits_target(graph):
    _, dist, p, _ = graph
    got = tperp.perplexity_of(tperp.calibrate_p(T(dist), 10.0))
    assert float((got - 10.0).abs().median()) < 0.5
    np.testing.assert_allclose(got.numpy(), np.asarray(jperp.perplexity_of(
        jnp.asarray(p))), rtol=1e-4)


def _probs():
    rng = np.random.default_rng(0)
    zipf = 1.0 / np.arange(1, 3001) ** 1.1
    sparse = rng.random(500) * (rng.random(500) < 0.3)
    return {"uniform-random": rng.random(2000), "zipf": zipf,
            "sparse-with-zeros": sparse, "one-hot": np.eye(1, 64)[0],
            "constant": np.ones(100), "single": np.ones(1)}


@pytest.mark.parametrize("name", list(_probs()))
def test_alias_pairing_bitwise_equal_to_jax_x64(name):
    probs = _probs()[name].astype(np.float32)
    with jax.enable_x64(True):
        thr, ali = jsamp._alias_jit(jnp.asarray(probs), hi_dtype=jnp.float64)
        thr, ali = np.asarray(thr), np.asarray(ali)
    got_thr, got_ali = tsamp._alias_pairing(T(probs))
    np.testing.assert_array_equal(got_thr.numpy(), thr)
    np.testing.assert_array_equal(got_ali.numpy(), ali)
    want = probs.astype(np.float64) / probs.sum()
    np.testing.assert_allclose(tsamp.alias_marginals(got_thr, got_ali),
                               want, atol=1e-6)


def test_host_vose_oracle_equal():
    probs = _probs()["uniform-random"][:300]
    want = jsamp.build_alias(probs)
    got = tsamp.build_alias(probs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_sampler_marginals_match(graph):
    """Edge tables draw w_e / sum(w); negative tables deg^0.75 / sum —
    and agree with the JAX package's tables built from the same graph."""
    idx, _, _, w = graph
    es = tsamp.build_edge_sampler(T(idx), T(w))
    ns = tsamp.build_negative_sampler(T(idx), T(w), power=0.75)
    ew = w.reshape(-1).astype(np.float64)
    np.testing.assert_allclose(tsamp.alias_marginals(es.threshold, es.alias),
                               ew / ew.sum(), rtol=1e-4, atol=1e-12)
    np.testing.assert_array_equal(es.src.numpy(),
                                  np.repeat(np.arange(600), 20))
    np.testing.assert_array_equal(es.dst.numpy(), idx.reshape(-1))
    deg = w.astype(np.float64).sum(1)
    np.add.at(deg, idx.reshape(-1), w.reshape(-1))
    want = np.maximum(deg, 1e-12) ** 0.75
    np.testing.assert_allclose(tsamp.alias_marginals(ns.threshold, ns.alias),
                               want / want.sum(), rtol=1e-4)
    # the JAX package's host (Vose) tables: its device tables need
    # jax.experimental.enable_x64, which JAX 0.9 removed
    jes = jsamp.build_edge_sampler(idx, w, impl="host")
    jns = jsamp.build_negative_sampler(idx, w, impl="host")
    np.testing.assert_allclose(
        tsamp.alias_marginals(es.threshold, es.alias),
        jsamp.alias_marginals(jes.threshold, jes.alias), rtol=1e-5,
        atol=1e-12)
    np.testing.assert_allclose(
        tsamp.alias_marginals(ns.threshold, ns.alias),
        jsamp.alias_marginals(jns.threshold, jns.alias), rtol=1e-5)


def test_sample_alias_draws_follow_marginals():
    """Draws from a torch.Generator follow the table (chi-square-free:
    each bucket within 5 standard errors of its expected count)."""
    probs = np.array([0.5, 0.25, 0.125, 0.125, 0.0], np.float32)
    thr, ali = tsamp._alias_pairing(T(probs))
    gen = torch.Generator().manual_seed(0)
    draws = tsamp.sample_alias(gen, thr, ali, (200_000,))
    assert draws.dtype == torch.int32
    counts = np.bincount(draws.numpy(), minlength=5) / 200_000
    se = np.sqrt(probs * (1 - probs) / 200_000)
    assert (np.abs(counts - probs) <= 5 * se + 1e-9).all(), counts
