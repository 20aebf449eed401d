"""Tile tuner: a tuned config per (kernel, backend, shape bucket).

A call site asks for its config and passes its legacy value as the
default:

    tile = autotune.get("symmetrize", dict(n=N, k=K),
                        autotune.legacy_default("symmetrize"),
                        backend=x.device.type)["tile"]

``default`` is also the key whitelist: only its keys are taken from a
tuned entry, so an entry can never hand a call site an unknown keyword.

Modes (the ``AUTOTUNE`` variable, ``RoutingConfig.autotune`` or
:func:`set_mode`):

  ``off``    always ``default``: the legacy tiles, bitwise.
  ``cache``  (default) the user cache
             (``~/.cache/repro-autotune/autotune_torch_<backend>.json``,
             the directory overridable with ``REPRO_AUTOTUNE_CACHE``),
             then the committed table (``autotune_torch_<backend>.json``
             beside this module; the ``cuda`` one swept on an H100 by
             ``tools/autotune_table.py``), then ``default``.  Measures
             nothing.
  ``sweep``  as ``cache``, but a miss measures the kernel's candidate
             grid and writes the winner to the user cache.

The file names hold ``torch``: a tile measured for PyTorch's kernels says
nothing of XLA's, so neither package reads the other's cache or table.

A sweep times the candidates with
:func:`repro_torch.runtime.timing.best_of_interleaved`: an interleaved
best-of-3 pass shortlists the grid, then the shortlist's winner meets
the default in a paired, interleaved best-of-8 and is adopted only if it
beats it by more than :data:`ADOPT_MARGIN`; ties keep the default.

Results are never the tuner's to change.  Its knobs are only the ones
that move memory and speed:

* ``symmetrize``'s row tile (``core/perplexity.py``);
* ``neighbor_explore``'s row tile, un-sampled only: with ``sample > 0``
  each tile draws its own candidate columns, so the tile is part of the
  result and the call site never asks (``core/neighbor_explore.py``);
* ``layout_chunk``'s steps a dispatch (``core/layout_engine.py``), from
  the cache or the table only: it has no sweep, since measuring it needs
  a whole layout a candidate.

The JAX kernels' tile cells (``topk_sqdist`` bm/bn/lane/merge,
``knn_window_fold``, ``largevis_edge_step``, ``largevis_grads``) have an
empty default here: their CUDA counterparts choose their tiles inside
the kernel.  ``topk_sqdist``'s ``bn`` is more than a tile in the port:
duplicates are suppressed within a column tile of width ``bn``
(``kernels/knn_topk.py``, ``ref.dedup_tile``), so it is part of the
dedup semantics and the tuner must never touch it.

Cache files are versioned: a file whose ``version`` differs from
:data:`AUTOTUNE_VERSION` is ignored whole.  A tuned value is looked up
when the call runs and kept in a memo for the process; :func:`set_mode`
clears the memo when the mode changes.  Captured CUDA graphs are keyed
by their explicit chunk length, so they stay valid.
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile

import torch

AUTOTUNE_VERSION = 1
ADOPT_MARGIN = 0.97        # the winner must beat the default by > 3 %
SHORTLIST_REPEATS = 3      # the interleaved pass over the whole grid

_ENV = "AUTOTUNE"
_CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
MODES = ("off", "cache", "sweep")

# the mode is process-wide, as the JAX package's is
_mode_override: str | None = None
_mem: dict[str, dict] = {}       # bucket key -> tuned config (the memo)

# the legacy (``off``) config of every cell; empty where the CUDA kernel
# picks its own tiles (module docstring)
_LEGACY = {
    "topk_sqdist": {},
    "knn_window_fold": {},
    "largevis_edge_step": {},
    "largevis_grads": {},
    "symmetrize": {"tile": 4096},
    "neighbor_explore": {"tile": 1024},
    "layout_chunk": {"steps": 0},       # 0: the caller runs its loop
}


def mode() -> str:
    """The mode: the :func:`set_mode` override, else ``AUTOTUNE``."""
    if _mode_override is not None:
        return _mode_override
    m = os.environ.get(_ENV, "cache").strip().lower()
    return m if m in MODES else "cache"


def set_mode(m: str | None) -> None:
    """Pin the mode for this process (None: back to ``AUTOTUNE``); a
    change clears the memo."""
    global _mode_override
    if m is not None and m not in MODES:
        raise ValueError(f"autotune mode {m!r}; expected one of {MODES}")
    if m != _mode_override:
        _mem.clear()
    _mode_override = m


def default_backend() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def cache_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(
        _CACHE_ENV, "~/.cache/repro-autotune")).expanduser()


def _file_name(backend: str) -> str:
    return f"autotune_torch_{backend}.json"


def _cache_path(backend: str) -> pathlib.Path:
    return cache_dir() / _file_name(backend)


def _defaults_path(backend: str) -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / _file_name(backend)


def _read_entries(path: pathlib.Path) -> dict:
    """The entries of a versioned cache file ({} when it is missing,
    corrupt or of another version)."""
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict) or doc.get("version") != AUTOTUNE_VERSION:
        return {}
    entries = doc.get("entries")
    return entries if isinstance(entries, dict) else {}


def _write_entry(backend: str, key: str, entry: dict) -> None:
    """Merge one entry into the user cache file (atomic replace)."""
    path = _cache_path(backend)
    path.parent.mkdir(parents=True, exist_ok=True)
    entries = _read_entries(path)
    entries[key] = entry
    doc = {"version": AUTOTUNE_VERSION, "torch": torch.__version__,
           "entries": entries}
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _bucket(v: int) -> int:
    """Round up to the next power of two (a bucket shares a config)."""
    v = int(v)
    return 1 if v <= 1 else 1 << (v - 1).bit_length()


def bucket_key(kernel: str, shape: dict, backend: str | None = None) -> str:
    backend = backend or default_backend()
    dims = "_".join(f"{k}{_bucket(v)}" for k, v in sorted(shape.items()))
    return f"{backend}/{kernel}/{dims}"


def bucket_shape(shape: dict) -> dict:
    """The shape a sweep measures a bucket at."""
    return {k: _bucket(v) for k, v in shape.items()}


def get(kernel: str, shape: dict, default: dict, *,
        backend: str | None = None) -> dict:
    """The config of one call: ``default`` with the tuned entry's values
    for its keys (module docstring); ``shape`` holds the call's
    size-determining integers, ``backend`` the device type it runs on."""
    out = dict(default)
    m = mode()
    if m == "off":
        return out
    backend = backend or default_backend()
    key = bucket_key(kernel, shape, backend)
    cfg = _mem.get(key)
    if cfg is None:
        cfg = _read_entries(_cache_path(backend)).get(key)
        if cfg is None:
            cfg = _read_entries(_defaults_path(backend)).get(key)
        if cfg is not None:
            cfg = cfg.get("config", cfg)
    if cfg is None and m == "sweep":
        cfg = sweep(kernel, shape, default, backend=backend)
    if cfg:
        _mem[key] = cfg
        for k, v in cfg.items():
            if k in out:
                out[k] = v
    return out


def legacy_default(kernel: str) -> dict:
    """The ``off`` config of ``kernel`` (KeyError for an unknown one)."""
    return dict(_LEGACY[kernel])


def sweep(kernel: str, shape: dict, default: dict | None = None, *,
          backend: str | None = None) -> dict:
    """Measure the candidate grid of one (kernel, backend, bucket) cell,
    write the chosen config to the user cache and return it; a kernel
    without a sweep returns ``default`` (module docstring)."""
    backend = backend or default_backend()
    default = dict(default) if default else legacy_default(kernel)
    make_sweep = _SWEEPS.get(kernel)
    if make_sweep is None:
        return dict(default)
    key = bucket_key(kernel, shape, backend)
    candidates, make_thunk = make_sweep(bucket_shape(shape),
                                        torch.device(backend))
    cand_list = [dict(default)] + [c for c in candidates if c != default]
    # the candidates' thunks pass their tiles explicitly: no lookup (and
    # no sweep) happens inside a sweep
    from repro_torch.runtime import timing
    fns = [make_thunk({**default, **c}) for c in cand_list]
    _, best = timing.best_of_interleaved(fns, SHORTLIST_REPEATS)
    win = min(range(len(best)), key=best.__getitem__)
    chosen, us, us_default = dict(default), best[0] * 1e6, best[0] * 1e6
    if win != 0:
        _, (t_def, t_win) = timing.best_of_interleaved(
            [fns[0], fns[win]], timing.AUTOTUNE_REPEATS)
        us_default = t_def * 1e6
        if t_win < ADOPT_MARGIN * t_def:
            chosen, us = dict(cand_list[win]), t_win * 1e6
        else:
            us = us_default
    entry = {"config": chosen, "us": round(us, 1),
             "us_default": round(us_default, 1),
             "shape": bucket_shape(shape)}
    _write_entry(backend, key, entry)
    _mem[key] = chosen
    return chosen


def _sweep_symmetrize(shape, dev):
    from repro_torch.core import perplexity
    n, kk = shape.get("n", 16384), shape.get("k", 64)
    gen = torch.Generator(device=dev).manual_seed(3)
    idx = torch.randint(0, n, (n, kk), generator=gen, device=dev,
                        dtype=torch.int32)
    p = torch.rand((n, kk), generator=gen, device=dev)
    tiles = [t for t in (512, 1024, 2048, 4096, 8192) if t <= n] or [n]

    def make_thunk(cfg):
        return lambda: perplexity.symmetrize(idx, p, tile=cfg["tile"])

    return [dict(tile=t) for t in tiles], make_thunk


def _sweep_explore(shape, dev):
    # exploring over a brute-forced subgraph of the bucket's points, as
    # the JAX package sweeps it: real distances and real duplicates (a
    # random graph would sweep an unrepresentative gather); candidates
    # that the memory cap makes equal are timed once
    from repro_torch.core import knn, neighbor_explore as ne
    n, kk, d = shape.get("n", 8192), shape.get("k", 32), shape.get("d", 128)
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((min(n, 4096), d), generator=gen, device=dev)
    idx, dist = knn.brute_force_knn(x, min(kk, 32))
    nn, k = idx.shape
    tiles = sorted({ne.capped_tile(t, nn, k, d)
                    for t in (256, 512, 1024, 2048) if t <= nn} or {nn})

    def make_thunk(cfg):
        return lambda: ne.neighbor_explore(x, idx, dist, iters=1, sample=0,
                                           tile=cfg["tile"])

    return [dict(tile=t) for t in tiles], make_thunk


_SWEEPS = {
    "symmetrize": _sweep_symmetrize,
    "neighbor_explore": _sweep_explore,
}
