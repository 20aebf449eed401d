"""The port's sharded graph stages against the JAX package, on the CPU.

World sizes 1-4 of gloo processes (``tests/torch_dist_ranks.py``: one
spawn a world size, every check's data from it) against the JAX
package's sharded stages on its one-device mesh, run here in-process
(JAX's graph stages are bitwise the same at every shard count,
``tests/test_elastic.py``).  N = 403 (no shard count divides it) and
256, d = 16, K = 10, 4 trees, one exploring round.  Held:

* the ring KNN, fed JAX's hyperplanes: ids equal JAX's
  ``build_knn_graph_sharded`` slot for slot (a point whose code differs
  from JAX's must sit within the f32 bound of its plane, and rows it
  touches are left out), distances within rtol 1e-6 + 1e-6 max|x|^2
  (row norms summed in another order, as ``test_torch_knn.py`` allows);
  exact mode (``n_trees=0``) bitwise the port's brute force; and at
  every world size bitwise the world of one;
* one exploring round from JAX's ring graph: ids equal JAX's
  ``sharded_explore_round``, distances within the same tolerance, the
  row-tiled round bitwise the untiled one;
* the weights: bitwise the port's single-device ``calibrate_p`` /
  ``symmetrize``, within rtol 1e-5 of JAX's sharded weights (its flat
  tolerance, ``test_torch_graph.py``);
* the sharded tables: at one shard the edge and shard tables bitwise
  JAX's shard_map table body (run under ``jax.enable_x64(True)``; the
  package's own ``build_samplers_sharded`` needs the removed
  ``jax.experimental.enable_x64``), for integer and real weights, and
  the node tables when fed JAX's node masses (XLA's f32 ``deg ** 0.75`` is not
  torch's, and for real weights JAX sums a node's in-degree from zero
  and adds the out-degree after, where the port adds onto the out-degree
  as the flat sampler does: the node marginals are held within 1e-6
  relative); bitwise the port's flat tables; at every world size the
  marginals reconstruct w_e / W and deg_j^0.75 / sum within 5e-7, and
  draws never reach padding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.configs.largevis_default import LargeVisConfig as JConfig
from repro.core import knn as jknn
from repro.core import knn_sharded as jks
from repro.core import neighbor_explore as jexp
from repro.core import perplexity as jperp
from repro.core import sampler as jsamp
from repro.data.synthetic import gaussian_mixture
from repro.launch.mesh import make_data_mesh as jmesh
from repro.runtime import sharding as jsh
from repro.runtime.compat import shard_map
from repro_torch.core import knn as tknn
from repro_torch.core import knn_sharded as tks
from repro_torch.core import perplexity as tperp
from repro_torch.core import sampler as tsamp

NS, D, K, TREES = (403, 256), 16, 10, 4
KEY = jax.random.key(5)


def T(a):
    return torch.from_numpy(np.array(a))


def _graph(n, k, seed):
    rng = np.random.default_rng(seed)
    idx = np.empty((n, k), np.int32)
    for i in range(n):                       # distinct neighbors, no self
        idx[i] = rng.choice([j for j in range(n) if j != i], k,
                            replace=False)
    return idx, rng.uniform(0.1, 4.0, (n, k)).astype(np.float32)


def _jax_ring(x, n_trees, iters):
    cfg = JConfig(n_neighbors=K, n_trees=n_trees, n_explore_iters=iters,
                  distributed=True)
    idx, dist = jks.build_knn_graph_sharded(jnp.asarray(x), KEY, cfg)
    return np.asarray(idx), np.asarray(dist)


def _jax_proj(n, n_trees):
    depth = jknn._auto_depth(n, 64)
    kp, _ = jax.random.split(KEY)
    return np.asarray(jax.random.normal(kp, (D, max(n_trees, 1) * depth),
                                        jnp.float32)), depth


def _jax_explore(x, idx, dist):
    from jax.sharding import PartitionSpec as P
    mesh = jmesh(0)
    n = x.shape[0]

    def body(x_loc, ids_loc, i_loc, d_loc):
        return jexp.sharded_explore_round(x_loc, ids_loc, i_loc, d_loc,
                                          axis="data", n_shards=1, n_real=n)
    fn = shard_map(body, mesh=mesh, in_specs=(P("data", None), P("data"),
                                              P("data", None),
                                              P("data", None)),
                   out_specs=(P("data", None), P("data", None)),
                   check_vma=False)
    ids = jnp.arange(n, dtype=jnp.int32)
    out = jax.jit(fn)(jnp.asarray(x), ids, jnp.asarray(idx),
                      jnp.asarray(dist))
    return np.asarray(out[0]), np.asarray(out[1])


def _jax_tables(idx, w, power=0.75):
    """JAX's sharded table body on its one-device mesh, in f64."""
    mesh = jmesh(0)
    n = idx.shape[0]
    with jax.enable_x64(True):
        fn = jsamp._make_sharded_builder_fn(mesh, "data", n, power,
                                            jnp.float64)
        out = fn(jnp.asarray(idx, jnp.int32), jnp.asarray(w, jnp.float32),
                 jnp.arange(n, dtype=jnp.int32))
        src, dst, ethr, eali, t_e, nthr, nali, t_n = out
        # the (P,) totals leave the mesh as plain arrays
        se = jsamp._alias_jit(jnp.asarray(np.asarray(t_e)),
                              hi_dtype=jnp.float64)
        sn = jsamp._alias_jit(jnp.asarray(np.asarray(t_n)),
                              hi_dtype=jnp.float64)
        return {k: np.asarray(v) for k, v in dict(
            src=src, dst=dst, ethr=ethr, eali=eali, nthr=nthr, nali=nali,
            se_thr=se[0], se_ali=se[1], sn_thr=sn[0], sn_ali=sn[1]).items()}


@pytest.fixture(scope="module")
def data():
    d = {"x": {}, "proj": {}, "graph": {}, "wgraph": {}, "tw": {},
         "jax": {}}
    for n in NS:
        x = np.asarray(gaussian_mixture(jax.random.key(4), n, D, 4)[0])
        d["x"][n] = x
        d["proj"][n] = {t: _jax_proj(n, t)[0] for t in (TREES, 0)}
        j = {m: _jax_ring(x, t, it) for m, t, it in (
            ("ring", TREES, 0), ("knn", TREES, 1), ("exact", 0, 0))}
        d["graph"][n] = j["ring"]
        j["explore"] = _jax_explore(x, *j["ring"])
        widx, wd2 = _graph(n, 7, seed=n)
        d["wgraph"][n] = (widx, wd2)
        j["ew"] = np.asarray(jperp.edge_weights_sharded(
            jnp.asarray(widx), jnp.asarray(wd2), 5.0))
        rng = np.random.default_rng(n + 1)
        d["tw"][n] = {
            "int": rng.integers(1, 16, widx.shape).astype(np.float32),
            "real": rng.uniform(0.1, 2.0, widx.shape).astype(np.float32)}
        j["tables"] = {kind: _jax_tables(widx, w)
                       for kind, w in d["tw"][n].items()}
        d["jax"][n] = j
    return d


_WORLDS: dict = {}


def world(P, data, tmp_path_factory):
    """The ranks' results of world size P (one spawn a world size)."""
    if P not in _WORLDS:
        pl = {k: data[k] for k in ("x", "proj", "graph", "wgraph", "tw")}
        pl.update(k=K, n_trees=TREES)
        out = ranks.run_world("graph_world", P,
                              tmp_path_factory.mktemp(f"g{P}"), pl)
        for r in out[1:]:                   # every rank holds the result
            for key, v in out[0].items():
                np.testing.assert_array_equal(r[key], v, err_msg=key)
        _WORLDS[P] = out[0]
    return _WORLDS[P]


WORLD_SIZES = [1, 2, 3, 4]


def _dist_tol(x):
    return dict(rtol=1e-6, atol=1e-6 * float((x ** 2).sum(1).max()))


@pytest.mark.parametrize("P", WORLD_SIZES)
def test_ring_knn_matches_jax_and_every_shard_count(P, data,
                                                    tmp_path_factory):
    got = world(P, data, tmp_path_factory)
    one = world(1, data, tmp_path_factory)
    for n in NS:
        x = data["x"][n]
        proj, depth = _jax_proj(n, TREES)
        codes = tks.slab_codes(T(x), T(proj), TREES, depth).numpy()
        want = np.asarray(jknn.hash_codes(jnp.asarray(x), None, TREES,
                                          depth, proj=jnp.asarray(proj)))
        pt, tr = np.nonzero(codes != want)
        flipped = set(pt.tolist())
        for p_i, t_i in zip(pt, tr):       # only rounding may flip a code
            bits = codes[p_i, t_i] ^ want[p_i, t_i]
            for lvl in range(depth):
                if bits >> lvl & 1:
                    h = proj[:, t_i * depth + lvl].astype(np.float64)
                    xp = x[p_i].astype(np.float64)
                    margin = abs(xp @ h)
                    bound = 2 * D * 2.0 ** -23 * float(np.abs(xp * h).sum())
                    assert margin <= bound, (n, p_i, t_i, margin, bound)
        for mode in ("ring", "knn"):
            ji, jd = data["jax"][n][mode]
            ti, td = got[f"{mode}_idx_{n}"], got[f"{mode}_dist_{n}"]
            touched = np.isin(ji, list(flipped)).any(1) | np.isin(
                ti, list(flipped)).any(1)
            touched[list(flipped)] = True
            ok = ~touched
            assert ok.mean() >= 0.9, (n, mode, int((~ok).sum()))
            np.testing.assert_array_equal(ti[ok], ji[ok], err_msg=mode)
            np.testing.assert_allclose(td[ok], jd[ok], **_dist_tol(x))
            np.testing.assert_array_equal(ti, one[f"{mode}_idx_{n}"])
            np.testing.assert_array_equal(td, one[f"{mode}_dist_{n}"])


@pytest.mark.parametrize("P", WORLD_SIZES)
def test_exact_ring_is_brute_force(P, data, tmp_path_factory):
    got = world(P, data, tmp_path_factory)
    for n in NS:
        x = data["x"][n]
        bi, bd = tknn.brute_force_knn(T(x), K)
        np.testing.assert_array_equal(got[f"exact_idx_{n}"], bi.numpy())
        np.testing.assert_array_equal(got[f"exact_dist_{n}"], bd.numpy())
        ji, jd = data["jax"][n]["exact"]
        np.testing.assert_array_equal(got[f"exact_idx_{n}"], ji)
        np.testing.assert_allclose(got[f"exact_dist_{n}"], jd,
                                   **_dist_tol(x))


@pytest.mark.parametrize("P", WORLD_SIZES)
def test_explore_round_matches_jax_tiled_or_not(P, data, tmp_path_factory):
    got = world(P, data, tmp_path_factory)
    for n in NS:
        x = data["x"][n]
        wi, wd = got[f"explore_whole_idx_{n}"], got[f"explore_whole_dist_{n}"]
        np.testing.assert_array_equal(got[f"explore_tiled_idx_{n}"], wi)
        np.testing.assert_array_equal(got[f"explore_tiled_dist_{n}"], wd)
        ji, jd = data["jax"][n]["explore"]
        np.testing.assert_array_equal(wi, ji)
        np.testing.assert_allclose(wd, jd, **_dist_tol(x))


@pytest.mark.parametrize("P", WORLD_SIZES)
def test_sharded_weights_bitwise_single_device(P, data, tmp_path_factory):
    got = world(P, data, tmp_path_factory)
    for n in NS:
        idx, d2 = (T(a) for a in data["wgraph"][n])
        p = tperp.calibrate_p(d2, 5.0)
        np.testing.assert_array_equal(got[f"p_{n}"], p.numpy())
        w = tperp.symmetrize(idx, p)
        np.testing.assert_array_equal(got[f"w_{n}"], w.numpy())
        np.testing.assert_array_equal(got[f"ew_{n}"], w.numpy())
        np.testing.assert_allclose(got[f"ew_{n}"], data["jax"][n]["ew"],
                                   rtol=1e-5, atol=1e-10)


@pytest.mark.parametrize("P", WORLD_SIZES)
def test_sharded_tables(P, data, tmp_path_factory):
    got = world(P, data, tmp_path_factory)
    for n in NS:
        widx = data["wgraph"][n][0]
        n_loc = jsh.rows_per_shard(n, P)
        for kind, w in data["tw"][n].items():
            es = {f: got[f"es_{f}_{kind}_{n}"] for f in (
                "src", "dst", "threshold", "alias", "shard_threshold",
                "shard_alias")}
            ns = {f: got[f"ns_{f}_{kind}_{n}"] for f in (
                "threshold", "alias", "shard_threshold", "shard_alias")}
            assert es["threshold"].shape == (P, n_loc * widx.shape[1])
            assert ns["threshold"].shape == (P, n_loc)
            if P == 1:
                ef = tsamp.build_edge_sampler(T(widx), T(w))
                nf = tsamp.build_negative_sampler(T(widx), T(w))
                for a, b in ((es["src"][0], ef.src), (es["dst"][0], ef.dst),
                             (es["threshold"][0], ef.threshold),
                             (es["alias"][0], ef.alias),
                             (ns["threshold"][0], nf.threshold),
                             (ns["alias"][0], nf.alias)):
                    np.testing.assert_array_equal(a, b.numpy())
                jt = data["jax"][n]["tables"][kind]
                for a, b in ((es["src"], jt["src"]), (es["dst"], jt["dst"]),
                             (es["threshold"], jt["ethr"]),
                             (es["alias"], jt["eali"]),
                             (es["shard_threshold"], jt["se_thr"]),
                             (es["shard_alias"], jt["se_ali"]),
                             (ns["shard_alias"], jt["sn_ali"])):
                    np.testing.assert_array_equal(a, b)
                # the node masses: XLA's f32 pow is not torch's, so JAX's
                # masses go through the port's pairing to hold the tables
                deg = w.sum(1)
                if kind == "int":           # exact in either order
                    np.add.at(deg, widx.reshape(-1), w.reshape(-1))
                    mass = np.asarray(jnp.maximum(jnp.asarray(deg), 1e-12)
                                      ** 0.75)
                    thr, ali = tsamp._alias_pairing(T(mass))
                    np.testing.assert_array_equal(thr.numpy(), jt["nthr"][0])
                    np.testing.assert_array_equal(ali.numpy(), jt["nali"][0])
                np.testing.assert_allclose(
                    tsamp.alias_marginals(ns["threshold"][0],
                                          ns["alias"][0]),
                    jsamp.alias_marginals(jt["nthr"][0], jt["nali"][0]),
                    rtol=1e-6, atol=1e-12)
            # the marginals reconstruct w_e / W and deg^0.75 / sum
            wf = w.astype(np.float64).reshape(-1)
            np.testing.assert_allclose(got[f"marg_{kind}_{n}"], wf / wf.sum(),
                                       atol=5e-7, rtol=0)
            deg = w.astype(np.float64).sum(1)
            np.add.at(deg, widx.reshape(-1), w.reshape(-1))
            mass = np.maximum(deg, 1e-12) ** 0.75
            sp = tsamp.alias_marginals(ns["shard_threshold"],
                                       ns["shard_alias"])
            node = np.concatenate([sp[s] * tsamp.alias_marginals(
                ns["threshold"][s], ns["alias"][s]) for s in range(P)])
            np.testing.assert_allclose(node[:n], mass / mass.sum(),
                                       atol=5e-7, rtol=0)
            assert (node[n:] == 0).all()            # padding: zero mass
            src, dst = got[f"draw_e_{kind}_{n}"]
            assert ((src >= 0) & (src < n)).all()
            assert ((dst >= 0) & (dst < n)).all()
            draws = got[f"draw_n_{kind}_{n}"]
            assert ((draws >= 0) & (draws < n)).all()


@pytest.mark.parametrize("P", WORLD_SIZES)
def test_all_reduce_sum_adds_in_rank_order(P, data, tmp_path_factory):
    """``DataMesh.all_reduce_sum`` (the local-SGD sync: an all-to-all of
    P blocks, each summed by its owner, then an all-gather) is every
    rank's tensor added in rank order, bitwise, on every rank; 806
    entries leave a short last block at P = 3 and 4."""
    got = world(P, data, tmp_path_factory)
    want = None
    for r in range(P):
        move = torch.randn((ranks.ALL_REDUCE_ROWS, 2),
                           generator=torch.Generator().manual_seed(100 + r))
        want = move if want is None else want + move
    np.testing.assert_array_equal(got["all_reduce_sum"], want.numpy())

