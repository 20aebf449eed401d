"""The port's cost and memory counts (``launch/hlo_analysis.py``) against
the JAX package's ``compiled.cost_analysis()`` on the CPU.

* ``cost_stats``: the transcendentals of small functions (an exp and a
  log1p, 3,072 elements; a sigmoid; a tanh times a softplus, XLA's two a
  softplus element) and the flops of a plain dot equal XLA's for the same
  function on the same shapes, on the CPU and on the meta device; the
  flash kernels' own work (``ops.recording_work``) is added on the meta
  device, where no counter sees it, and not on the CPU, where the plain
  version's products are counted.
* ``collective_bytes``: a recording mesh's log under JAX's op names, the
  port's ``kind:axis`` beside them, every call summed.
* ``memory_stats``: JAX's five keys; the temporaries None on the meta
  device.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import make_production_mesh

A, B, C = (64, 16), (64, 32), (32, 16)
CASES = {
    "exp_log1p": ((A, B), lambda a, b: jnp.exp(a).sum() + jnp.log1p(b).sum(),
                  lambda a, b: torch.exp(a).sum() + torch.log1p(b).sum()),
    "sigmoid": ((A,), jax.nn.sigmoid, torch.sigmoid),
    "tanh_softplus": ((A,), lambda a: jnp.tanh(a) * jax.nn.softplus(a),
                      lambda a: torch.tanh(a) * torch.logaddexp(
                          a, torch.zeros_like(a))),
    "dot": ((B, C), lambda b, c: b @ c, lambda b, c: b @ c),
}


def _jax_cost(fn, shapes) -> dict:
    args = [jnp.ones(s, jnp.float32) for s in shapes]
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return {k: float(ca.get(k) or 0.0) for k in ("flops", "transcendentals")}


def _port_cost(fn, shapes, device) -> dict:
    args = [torch.ones(s, device=device) for s in shapes]
    with H.counting() as counter:
        fn(*args)
    return H.cost_stats(counter)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", list(CASES))
def test_cost_stats_match_xla(name, device):
    """The transcendentals equal XLA's for every case; a dot's flops
    equal XLA's (elementwise flops are not the counter's: it counts the
    products)."""
    shapes, jfn, tfn = CASES[name]
    want = _jax_cost(jfn, shapes)
    got = _port_cost(tfn, shapes, device)
    assert got["transcendentals"] == want["transcendentals"], (got, want)
    if name == "dot":
        assert got["flops"] == want["flops"] == 2.0 * 64 * 32 * 16
    assert got["bytes_accessed"] > 0


def test_flash_work_counted_where_no_counter_sees_it():
    """A flash forward on the meta device adds its own work, 4 hd
    operations a pair under the causal mask; on the CPU the plain
    version's products are the counter's and no kernel entry is made."""
    Bq, S, Hh, hd = 2, 256, 2, 16
    shape = (Bq, S, Hh, hd)
    for device in ("meta", "cpu"):
        q = torch.ones(shape, device=device)
        with H.counting() as counter:
            ops.flash_attention(q, q, q, causal=True)
        cost = H.cost_stats(counter)
        if device == "meta":
            assert cost["kernel_flops"] == 4.0 * Bq * Hh * hd * \
                (S * (S + 1) // 2)
            assert cost["counter_flops"] == 0
        else:
            assert cost["kernel_flops"] == 0 and not counter.kernels
            assert cost["counter_flops"] > 0


def test_collective_bytes_from_the_log():
    """Every logged call under its JAX op name and its kind:axis."""
    mesh = make_production_mesh()
    t = torch.empty((4, 8), device="meta")
    mesh.all_gather(t, "model", dim=1)
    mesh.all_gather(t, "model", dim=1)
    mesh.all_reduce_sum(t, "data")
    mesh.reduce_scatter_sum(torch.empty((16, 8), device="meta"), "data")
    mesh.exchange([(0, t), (1, t)], [(0, (4, 8)), (1, (4, 8))], "model")
    out = H.collective_bytes(mesh.log)
    assert out["all-gather"] == 2 * 128 and out["all-reduce"] == 128
    assert out["reduce-scatter"] == 16 * 8 * 4
    assert out["all-to-all"] == 256 and out["collective-permute"] == 0
    assert out["total"] == 256 + 128 + 512 + 256
    assert out["by_kind"]["all_gather:model"] == {"calls": 2, "bytes": 256}
    assert out["by_kind"]["exchange:model"] == {"calls": 1, "bytes": 256}


def test_memory_stats_keys():
    """JAX's five keys: arguments and outputs from their tensors, the
    temporaries None without a peak (the meta device), the peak less what
    was allocated before otherwise."""
    args = (torch.empty((10, 4), device="meta"),
            {"c": torch.empty((3,), dtype=torch.int8, device="meta")})
    out = [torch.empty((5,), dtype=torch.float64, device="meta")]
    got = H.memory_stats(args, out)
    assert got == {"argument_size_in_bytes": 163,
                   "output_size_in_bytes": 40, "temp_size_in_bytes": None,
                   "generated_code_size_in_bytes": 0,
                   "alias_size_in_bytes": 0}
    assert H.memory_stats(args, out, peak=1000, before=400)[
        "temp_size_in_bytes"] == 600
    assert H.tree_size(torch.nn.Linear(3, 2)) == {"elements": 8,
                                                  "bytes": 32}
