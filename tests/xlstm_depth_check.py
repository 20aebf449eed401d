"""xlstm trained at depth: a fault of the port, or the gated recurrence's
conditioning?  A CPU check, run by hand (it is not a test):

    PYTHONPATH=src:tests python tests/xlstm_depth_check.py [--seq 16]

Reduced xlstm-125m (d 64, 4 heads) at 2 and at 12 layers, JAX's weights
carried across, two f32 steps of batch 4, each measured as the largest
gap over the leaves of the moments (|a - b| over the leaf's largest |b|,
the bound the tensor-parallel tests hold at 1e-4):

1. the port at world 1 against JAX's ``make_train_step`` (its activation
   policy patched off, as the tests run it), first step;
2. the port on a (2, 2) mesh of four gloo processes against world 1,
   both steps;
3. the summation order alone: world 1 at one microbatch against two, and
   world 1 on weights moved by one f32 ulp against the unmoved run.

f64: the blocks compute in f32 whatever the weights' type (JAX's
``astype(jnp.float32)`` and the port's ``.float()`` in the recurrences),
so an f64 run is not possible without changing them; check 3 stands in
for it: a gap that another summation order, or a one-ulp change of the
weights, opens as wide as the mesh does is the conditioning, and one that
only the mesh opens is a fault.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import tempfile
from pathlib import Path

import numpy as np

B = 4
STEPS = 2
ARCH = "xlstm-125m"


def _rank(rank, tmp, payload):
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import lm_params_from_numpy, train_state_to_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import adamw_init
    from torch_dist_ranks import _flat

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=4,
        timeout=datetime.timedelta(seconds=600))
    try:
        out = {}
        for L, c in payload.items():
            cfg = c["cfg"]
            mesh = make_host_mesh(2, 2, device="cpu")
            p = lm_params_from_numpy(c["weights"], cfg, "cpu", mesh=mesh,
                                     train=True)
            st = adamw_init(p)
            step = make_train_step(cfg, ShapeConfig("c", "train", c["S"], B),
                                   mesh=mesh, microbatches=1)
            for i, toks in enumerate(c["batches"]):
                t = torch.from_numpy(toks)
                p, st, _ = step(p, st, {"tokens": t[:, :-1],
                                        "labels": t[:, 1:]})
                out.update(_flat(train_state_to_numpy(p, st, cfg, mesh=mesh),
                                 f"{L}/state{i}"))
        np.savez(Path(tmp) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _gap(got: dict, want: dict) -> float:
    """The largest leaf gap of two flat {path: array} trees."""
    worst = 0.0
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64)
        top = np.abs(w).max()
        if top > 0:
            worst = max(worst, float(np.abs(g - w).max() / top))
    return worst


def _moments(flat: dict, prefix: str) -> tuple[dict, dict]:
    out = []
    for name in ("m", "v"):
        head = f"{prefix}/opt/{name}"
        out.append({k[len(head):]: a for k, a in flat.items()
                    if k.startswith(head + "/")})
    return out[0], out[1]


def main() -> None:
    import jax
    import jax.numpy as jnp
    import torch
    import torch.multiprocessing as mp
    from unittest import mock

    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.optim import adamw as jadamw
    from repro.runtime import sharding as jsh
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import lm_params_from_numpy, train_state_to_numpy
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import adamw_init
    from torch_dist_ranks import _flat
    from torch_lm_parity import cfgs, params, tokens

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 12])
    args = ap.parse_args()
    S = args.seq
    torch.set_num_threads(4)

    def world1(tcfg, weights, batches, micro):
        p = lm_params_from_numpy(weights, tcfg, "cpu")
        st = adamw_init(p)
        step = make_train_step(tcfg, ShapeConfig("c", "train", S, B),
                               microbatches=micro)
        out = {}
        for i, toks in enumerate(batches):
            t = torch.from_numpy(toks)
            p, st, _ = step(p, st, {"tokens": t[:, :-1], "labels": t[:, 1:]})
            out.update(_flat(train_state_to_numpy(p, st, tcfg),
                             f"state{i}"))
        return out

    def jax_first(jcfg, weights, toks):
        jstep, *_ = jmake_train_step(jcfg, jmake_host_mesh(),
                                     JShapeConfig("c", "train", S, B),
                                     microbatches=2)
        jb = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
        jp = jax.tree.map(jnp.asarray, weights)
        with mock.patch.object(jsh, "activation_policy",
                               lambda *a, **kw: contextlib.nullcontext()):
            _, jopt, _ = jax.jit(jstep)(jp, jadamw.adamw_init(jp), jb)
        return (_flat(jax.tree.map(np.asarray, jopt["m"]), ""),
                _flat(jax.tree.map(np.asarray, jopt["v"]), ""))

    payload, refs = {}, {}
    for L in args.layers:
        jcfg, tcfg = cfgs(ARCH, n_layers=L)
        jp, _ = params(jcfg, tcfg, seed=3)
        weights = jax.tree.map(np.asarray, jp)
        batches = [tokens(B, S + 1, tcfg.vocab_size, seed=40 + i)
                   for i in range(STEPS)]
        payload[L] = {"cfg": tcfg, "weights": weights, "batches": batches,
                      "S": S}
        one = world1(tcfg, weights, batches, 2)
        micro1 = world1(tcfg, weights, batches, 1)
        moved = jax.tree.map(
            lambda a: np.nextafter(a, np.float32(np.inf)).astype(a.dtype)
            if a.dtype == np.float32 else a, weights)
        ulp = world1(tcfg, moved, batches, 2)
        jm, jv = jax_first(jcfg, weights, batches[0])
        m1, v1 = _moments(one, "state0")
        refs[L] = one
        print(f"{L} layers, seq {S}: world 1 vs JAX (step 1): m "
              f"{_gap(m1, jm):.3e}, v {_gap(v1, jv):.3e}", flush=True)
        for i in range(STEPS):
            a = _moments(one, f"state{i}")
            b = _moments(micro1, f"state{i}")
            c = _moments(ulp, f"state{i}")
            print(f"{L} layers, step {i + 1}: 1 vs 2 microbatches m "
                  f"{_gap(b[0], a[0]):.3e} v {_gap(b[1], a[1]):.3e}; one "
                  f"ulp on the weights m {_gap(c[0], a[0]):.3e} v "
                  f"{_gap(c[1], a[1]):.3e}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank, args=(tmp, payload), nprocs=4,
                                 join=False, start_method="spawn")
        while not ctx.join(timeout=5):
            pass
        ranks = [dict(np.load(Path(tmp) / f"rank{r}.npz")) for r in range(4)]
    for L in args.layers:
        for i in range(STEPS):
            want = _moments(refs[L], f"state{i}")
            got = _moments({k[len(f"{L}/"):]: v for k, v in ranks[0].items()
                            if k.startswith(f"{L}/")}, f"state{i}")
            print(f"{L} layers, step {i + 1}: (2, 2) vs world 1 m "
                  f"{_gap(got[0], want[0]):.3e} v {_gap(got[1], want[1]):.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
