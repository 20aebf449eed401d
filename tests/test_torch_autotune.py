"""The port's tile tuner (``repro_torch.runtime.autotune``) and timing
(``repro_torch.runtime.timing``), on the CPU.

The contract of ``tests/test_autotune.py`` for the port: the versioned
cache round trip and its key whitelist, wholesale rejection of another
version, ``off`` returning the default verbatim, the user cache ahead of
the committed table, pow-2 bucketing, the registry, the sweep's paired
adopt rule with faked timings (beat the default by more than 3 % or
keep it), a miss in ``sweep`` mode sweeping, an unknown kernel as the
identity, the explore sample gate and ``routing.autotune`` setting the
mode.  Also: the port's file names differ from the JAX package's and
neither reads the other's entries, a CPU fit with tuned tiles is bitwise
a fit with the tuner off, and ``best_of_interleaved``/``timed``
alternate, warm up and wait as documented, checked with a fake clock.
"""
import json
import types

import jax
import numpy as np
import pytest
import torch

from repro.runtime import autotune as jtune
from repro.runtime import timing as jtiming
from repro.data.synthetic import gaussian_mixture
from repro_torch import LargeVisConfig, RoutingConfig, largevis
from repro_torch.core import knn, neighbor_explore as ne, perplexity
from repro_torch.core.largevis import _apply_autotune_mode
from repro_torch.core.layout import _collision_capped_batch
from repro_torch.runtime import autotune, timing

SHAPE = dict(n=8000, k=20)


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    """An isolated cache directory, no committed table, the mode and the
    memo restored after the test."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("AUTOTUNE", raising=False)
    monkeypatch.setattr(autotune, "_defaults_path",
                        lambda backend: tmp_path / "no_committed_table.json")
    autotune.set_mode(None)
    autotune._mem.clear()
    yield tmp_path
    autotune.set_mode(None)
    autotune._mem.clear()


def _entry(tile):
    return {"config": dict(tile=tile)}


def test_constants_match_the_jax_package():
    assert autotune.AUTOTUNE_VERSION == jtune.AUTOTUNE_VERSION
    assert autotune.ADOPT_MARGIN == jtune.ADOPT_MARGIN
    assert autotune.SHORTLIST_REPEATS == jtune.SHORTLIST_REPEATS
    assert timing.AUTOTUNE_REPEATS == jtiming.AUTOTUNE_REPEATS
    assert autotune.MODES == jtune.MODES


def test_cache_roundtrip_and_key_whitelist(tuner):
    """A written entry is served back through the default's keys only."""
    autotune.set_mode("cache")
    key = autotune.bucket_key("symmetrize", SHAPE, "cpu")
    autotune._write_entry("cpu", key, {"config": dict(tile=512, rogue=7)})
    autotune._mem.clear()
    assert autotune.get("symmetrize", SHAPE, dict(tile=4096),
                        backend="cpu") == dict(tile=512)
    doc = json.loads(autotune._cache_path("cpu").read_text())
    assert doc["version"] == autotune.AUTOTUNE_VERSION
    assert doc["torch"] == torch.__version__
    assert not list(tuner.glob("*.tmp"))             # atomic replace


@pytest.mark.parametrize("content", [
    {"version": autotune.AUTOTUNE_VERSION + 1, "entries": "KEY"},
    "{not json", {"entries": "KEY"}])
def test_other_version_or_corrupt_file_rejected(tuner, content):
    autotune.set_mode("cache")
    key = autotune.bucket_key("symmetrize", SHAPE, "cpu")
    path = autotune._cache_path("cpu")
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(content, dict):
        content = json.dumps({**content, "entries": {key: _entry(512)}})
    path.write_text(content)
    assert autotune._read_entries(path) == {}
    assert autotune.get("symmetrize", SHAPE, dict(tile=4096),
                        backend="cpu") == dict(tile=4096)


def test_off_returns_default_verbatim(tuner):
    key = autotune.bucket_key("symmetrize", SHAPE, "cpu")
    autotune._write_entry("cpu", key, _entry(13))
    autotune.set_mode("off")
    assert autotune.get("symmetrize", SHAPE, dict(tile=4096),
                        backend="cpu") == dict(tile=4096)
    autotune.set_mode("cache")                # a change clears the memo
    assert autotune.get("symmetrize", SHAPE, dict(tile=4096),
                        backend="cpu") == dict(tile=13)


def test_user_cache_wins_over_committed_table(tuner, monkeypatch):
    autotune.set_mode("cache")
    key = autotune.bucket_key("symmetrize", SHAPE, "cpu")
    table = tuner / "table.json"
    table.write_text(json.dumps({"version": autotune.AUTOTUNE_VERSION,
                                 "entries": {key: _entry(256)}}))
    monkeypatch.setattr(autotune, "_defaults_path", lambda backend: table)
    assert autotune.get("symmetrize", SHAPE, dict(tile=4096),
                        backend="cpu") == dict(tile=256)
    autotune._write_entry("cpu", key, _entry(512))
    autotune._mem.clear()
    assert autotune.get("symmetrize", SHAPE, dict(tile=4096),
                        backend="cpu") == dict(tile=512)


def test_backend_keys_a_separate_cache(tuner):
    autotune.set_mode("cache")
    key = autotune.bucket_key("symmetrize", SHAPE, "cuda")
    autotune._write_entry("cuda", key, _entry(2048))
    assert autotune.get("symmetrize", SHAPE, dict(tile=4096),
                        backend="cpu") == dict(tile=4096)
    assert autotune.get("symmetrize", SHAPE, dict(tile=4096),
                        backend="cuda") == dict(tile=2048)


def test_file_names_differ_from_the_jax_package(tuner):
    """Neither package reads the other's cache files or table."""
    for backend in ("cpu", "cuda", "tpu"):
        name = autotune._file_name(backend)
        assert name == f"autotune_torch_{backend}.json"
        assert name != jtune._cache_path(backend).name
        assert name != jtune._defaults_path().name
    jkey = jtune.bucket_key("symmetrize", SHAPE, backend="cpu")
    jtune._write_entry("cpu", jkey, _entry(64))
    autotune.set_mode("cache")
    assert autotune.bucket_key("symmetrize", SHAPE, "cpu") == jkey
    assert autotune.get("symmetrize", SHAPE, dict(tile=4096),
                        backend="cpu") == dict(tile=4096)
    autotune._write_entry("cpu", jkey, _entry(128))
    assert jtune._read_entries(jtune._cache_path("cpu"))[jkey] == _entry(64)


def test_committed_cuda_table_names_the_card():
    """The committed table records the card, its power limit and the
    torch version, and holds only the tuner's results-neutral cells."""
    path = autotune._defaults_path("cuda")
    doc = json.loads(path.read_text())
    assert doc["version"] == autotune.AUTOTUNE_VERSION
    assert "H100" in doc["device"] and doc["power_limit"].endswith("W")
    assert doc["torch"]
    assert doc["entries"]
    for key, entry in doc["entries"].items():
        backend, kernel, _ = key.split("/")
        assert backend == "cuda"
        assert kernel in ("symmetrize", "neighbor_explore", "layout_chunk")
        assert set(entry["config"]) <= set(autotune.legacy_default(kernel))


def test_shape_bucketing_pow2():
    assert autotune.bucket_shape(dict(n=1000, k=20)) == dict(n=1024, k=32)
    a = autotune.bucket_key("k", dict(n=1000), backend="cpu")
    b = autotune.bucket_key("k", dict(n=1024), backend="cpu")
    c = autotune.bucket_key("k", dict(n=1025), backend="cpu")
    assert a == b != c and a.startswith("cpu/k/")


@pytest.mark.parametrize("kernel,want", [
    ("symmetrize", dict(tile=4096)), ("neighbor_explore", dict(tile=1024)),
    ("layout_chunk", dict(steps=0)), ("topk_sqdist", {}),
    ("knn_window_fold", {}), ("largevis_edge_step", {}),
    ("largevis_grads", {})])
def test_legacy_default_registry(kernel, want):
    """The plain stages keep the JAX package's legacy tiles; the CUDA
    kernels' cells are empty (topk_sqdist's bn is dedup semantics)."""
    assert autotune.legacy_default(kernel) == want
    if want:
        assert want == jtune.legacy_default(kernel, backend="cpu")


def test_legacy_default_unknown_kernel():
    with pytest.raises(KeyError):
        autotune.legacy_default("no_such_kernel")


def test_empty_default_takes_nothing(tuner):
    """An entry for a kernel the CUDA code tiles itself passes no key."""
    autotune.set_mode("cache")
    key = autotune.bucket_key("topk_sqdist", SHAPE, "cpu")
    autotune._write_entry("cpu", key, {"config": dict(bn=512, bm=64)})
    assert autotune.get("topk_sqdist", SHAPE,
                        autotune.legacy_default("topk_sqdist"),
                        backend="cpu") == {}


def _fake_sweep(shape, dev):
    return [dict(tile=2), dict(tile=3)], lambda cfg: (lambda: cfg["tile"])


def _fake_timer(paired):
    """The shortlist ranks tile=3 fastest; the paired pass returns
    ``paired`` (default, winner)."""
    def fake(fns, repeats):
        if len(fns) == 2:
            return None, list(paired)
        return None, [1.0, 0.9, 0.5][:len(fns)]
    return fake


@pytest.mark.parametrize("paired,want", [((1.0, 0.5), 3), ((1.0, 0.99), 1),
                                         ((1.0, 0.97), 1), ((1.0, 0.969), 3)])
def test_sweep_adopts_only_past_the_margin(tuner, monkeypatch, paired, want):
    monkeypatch.setitem(autotune._SWEEPS, "fake_kernel", _fake_sweep)
    monkeypatch.setattr(timing, "best_of_interleaved", _fake_timer(paired))
    got = autotune.sweep("fake_kernel", dict(n=100), dict(tile=1),
                         backend="cpu")
    assert got == dict(tile=want)
    autotune._mem.clear()
    autotune.set_mode("cache")                   # persisted
    assert autotune.get("fake_kernel", dict(n=100), dict(tile=1),
                        backend="cpu") == dict(tile=want)
    entry = autotune._read_entries(autotune._cache_path("cpu"))[
        autotune.bucket_key("fake_kernel", dict(n=100), "cpu")]
    assert entry["shape"] == dict(n=128)


def test_sweep_mode_sweeps_on_miss(tuner, monkeypatch):
    monkeypatch.setitem(autotune._SWEEPS, "fake_kernel", _fake_sweep)
    monkeypatch.setattr(timing, "best_of_interleaved",
                        _fake_timer((1.0, 0.5)))
    autotune.set_mode("sweep")
    assert autotune.get("fake_kernel", dict(n=100), dict(tile=1),
                        backend="cpu") == dict(tile=3)
    autotune.set_mode("cache")
    autotune.set_mode("off")
    assert autotune.get("fake_kernel", dict(n=100), dict(tile=1),
                        backend="cpu") == dict(tile=1)


@pytest.mark.parametrize("kernel", ["no_such_kernel", "layout_chunk"])
def test_kernel_without_sweep_is_identity(tuner, kernel):
    assert autotune.sweep(kernel, dict(n=4), dict(steps=9),
                          backend="cpu") == dict(steps=9)
    assert not autotune._cache_path("cpu").exists()


@pytest.mark.parametrize("kernel,shape", [
    ("symmetrize", dict(n=600, k=8)),
    ("neighbor_explore", dict(n=300, k=8, d=8))])
def test_real_sweep_picks_a_candidate(tuner, kernel, shape):
    """The two sweeps run at a tiny shape on the CPU and choose the
    default or one of their candidates; the choice changes no result."""
    got = autotune.sweep(kernel, shape, backend="cpu")
    cands, _ = autotune._SWEEPS[kernel](autotune.bucket_shape(shape),
                                        torch.device("cpu"))
    assert got == autotune.legacy_default(kernel) or got in cands


def test_explore_sample_gate_never_asks_the_tuner(tuner, monkeypatch):
    """With sample > 0 each tile draws its own candidate columns, so the
    tile is part of the result: the call site must not ask (and must
    ask when sample == 0)."""
    x = torch.randn((200, 8), generator=torch.Generator().manual_seed(3))
    idx, dist = knn.brute_force_knn(x, 5)
    calls = []
    real = autotune.get

    def spy(kernel, shape, default, **kw):
        calls.append(kernel)
        return real(kernel, shape, default, **kw)

    monkeypatch.setattr(autotune, "get", spy)
    ne.neighbor_explore(x, idx, dist, iters=1, sample=16,
                        generator=torch.Generator().manual_seed(4))
    assert "neighbor_explore" not in calls
    ne.neighbor_explore(x, idx, dist, iters=1, sample=0)
    assert calls == ["neighbor_explore"]


@pytest.mark.parametrize("setting,want", [("off", "off"), ("cache", "cache"),
                                          ("sweep", "sweep"),
                                          ("auto", "cache")])
def test_routing_config_sets_the_mode(tuner, setting, want):
    _apply_autotune_mode(LargeVisConfig(routing=RoutingConfig(
        autotune=setting)))
    assert autotune.mode() == want


def test_env_sets_the_mode(tuner, monkeypatch):
    monkeypatch.setenv("AUTOTUNE", "off")
    assert autotune.mode() == "off"
    monkeypatch.setenv("AUTOTUNE", "nonsense")
    assert autotune.mode() == "cache"
    with pytest.raises(ValueError):
        autotune.set_mode("fast")


def test_tuned_fit_bitwise_equals_off(tuner):
    """Tuned symmetrize and explore tiles and a tuned layout chunk (with
    ``steps_per_dispatch=0`` the layout asks the tuner) change nothing:
    the CPU fit is bitwise the one with the tuner off, and the tuned
    one really ran other tiles and chunks."""
    x, _ = gaussian_mixture(jax.random.key(2), 700, 12, 4)
    x = np.asarray(x)
    base = dict(n_neighbors=10, n_trees=3, n_explore_iters=1, window=16,
                perplexity=5.0, samples_per_node=60, steps_per_dispatch=0)
    n, k, d = 700, 10, 12
    b = _collision_capped_batch(4096, n, 60 * n)        # the layout's batch
    for kernel, shape, cfg in (
            ("symmetrize", dict(n=n, k=k), dict(tile=96)),
            ("neighbor_explore", dict(n=n, k=k, d=d), dict(tile=64)),
            ("layout_chunk", dict(n=n, b=b), dict(steps=4))):
        autotune._write_entry("cpu", autotune.bucket_key(kernel, shape,
                                                         "cpu"),
                              {"config": cfg})
    off = largevis(x, cfg=LargeVisConfig(
        routing=RoutingConfig(autotune="off"), **base), device="cpu")
    tuned = largevis(x, cfg=LargeVisConfig(
        routing=RoutingConfig(autotune="cache"), **base), device="cpu")
    assert off.steps_per_dispatch == 1 and tuned.steps_per_dispatch == 4
    assert sorted(autotune._mem) == sorted(
        autotune.bucket_key(kn, sh, "cpu") for kn, sh in (
            ("symmetrize", dict(n=n, k=k)),
            ("neighbor_explore", dict(n=n, k=k, d=d)),
            ("layout_chunk", dict(n=n, b=b))))
    for name in ("knn_idx", "knn_dist", "weights", "y"):
        assert torch.equal(getattr(off, name), getattr(tuned, name)), name


@pytest.mark.parametrize("tile", [None, 7, 64, 5000])
def test_symmetrize_tile_changes_nothing(tile):
    gen = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 300, (300, 9), generator=gen, dtype=torch.int32)
    p = torch.rand((300, 9), generator=gen)
    assert torch.equal(perplexity.symmetrize(idx, p, tile=tile),
                       perplexity.symmetrize(idx, p, tile=4096))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class FakeClock:
    """perf_counter stand-in: each fn call advances it by its duration."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def test_best_of_interleaved_alternates_and_warms_up(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(timing, "time", clock)
    log = []

    def make(name, durations):
        it = iter(durations)

        def fn():
            log.append(name)
            clock.now += next(it)
            return torch.tensor([len(log)])
        return fn

    fns = [make("a", [9.0, 3.0, 2.0, 4.0]), make("b", [9.0, 1.0, 5.0, 0.5])]
    outs, best = timing.best_of_interleaved(fns, 3)
    assert log == ["a", "b", "a", "b", "a", "b", "a", "b"]
    assert best == [2.0, 0.5]                 # the warm-ups are not timed
    assert [int(o) for o in outs] == [7, 8]   # the last call's output


def test_timed_warmup_and_repeats(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(timing, "time", clock)
    calls = []

    def fn(a, *, b):
        calls.append((a, b))
        clock.now += [5.0, 5.0, 2.0, 1.5, 3.0][len(calls) - 1]
        return {"out": (torch.zeros(1), [a + b])}

    out, best = timing.timed(fn, 1, b=2, repeats=3, warmup=2)
    assert len(calls) == 5 and best == 1.5
    assert out["out"][1] == [3]
    _, first = timing.timed(lambda: clock.__setattr__("now", clock.now + 4),
                            repeats=1, warmup=0)
    assert first == 4


def test_block_until_ready_syncs_each_cuda_device(monkeypatch):
    """Every CUDA tensor's device in a nested output is synchronised,
    once; CPU tensors and other leaves need no wait."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    fake = types.SimpleNamespace(device=torch.device("cuda", 1))
    monkeypatch.setattr(torch, "is_tensor",
                        lambda t: t is fake or isinstance(t, torch.Tensor))
    out = {"a": [torch.zeros(2), (fake, 3)], "b": fake, "c": "x"}
    assert timing.block_until_ready(out) is out
    assert synced == [torch.device("cuda", 1)]
    synced.clear()
    timing.block_until_ready((torch.ones(3), [1.0]))
    assert synced == []


def test_straggler_report(monkeypatch, capsys):
    """A repeat far above the median is reported on stderr."""
    clock = FakeClock()
    monkeypatch.setattr(timing, "time", clock)
    durs = iter([1.0] * 12 + [50.0] + [1.0])

    def fn():
        clock.now += next(durs)

    timing.timed(fn, repeats=13, warmup=1)
    assert "straggler" in capsys.readouterr().err
