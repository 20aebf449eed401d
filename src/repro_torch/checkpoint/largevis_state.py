"""LargeVis checkpoint schemas over the generic checkpointer.

Two consumers, as in the JAX package:

* **Model persistence** — :func:`save_result` / :func:`load_result`
  write a fitted :class:`~repro_torch.core.largevis.LargeVisResult`
  (embedding, graph, sampler tables, cfg) as a versioned, CRC-verified,
  atomically committed checkpoint of schema ``largevis-result-v1``.
  ``LargeVis.save`` / ``LargeVis.load`` wrap these.  The file is the JAX
  package's: a model saved by either package loads in the other (the
  port's result has no PRNG key, so it writes no ``key_data`` and
  ignores one when it reads it).

* **Crash recovery** — :class:`StageCheckpointer` persists each pipeline
  stage boundary (``graph`` -> ``weights`` -> ``samplers`` -> ``layout``)
  under ``CheckpointConfig.directory``, one subdirectory per stage.
  Every stage records a **fingerprint** of (data sample, generator
  states, cfg); a directory written by another run is refused with a
  warning instead of silently mixing states.  Where the JAX package
  hashes its key, the port hashes the entry states of the stage's
  ``torch.Generator``s, so a stage directory written by one package is
  read by the other and refused by its fingerprint.

Config serialization keeps only JSON-able values: the routing,
checkpoint and health sub-configs nest as dicts, ``dtype`` is stored by
its numpy name, and fields one package does not know are dropped.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import queue
import threading
import time
import warnings
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs.largevis_default import (CheckpointConfig,
                                                  HealthConfig,
                                                  LargeVisConfig,
                                                  RoutingConfig)

RESULT_SCHEMA = "largevis-result-v1"


# ---------------------------------------------------------------------------
# Config (de)serialization
# ---------------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    """The numpy name of a torch dtype (``torch.float32`` -> float32)."""
    return str(dtype).removeprefix("torch.")


def cfg_to_dict(cfg: LargeVisConfig) -> dict:
    """JSON-able dict of a LargeVisConfig."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = _dtype_name(cfg.dtype)
    return d


def cfg_from_dict(d: dict) -> LargeVisConfig:
    """The config of :func:`cfg_to_dict` or of the JAX package's; fields
    the port does not have (the JAX package's flat routing aliases) are
    dropped."""
    d = dict(d)
    d["routing"] = RoutingConfig(**d.get("routing") or {})
    for key, cls in (("checkpoint", CheckpointConfig),
                     ("health", HealthConfig)):
        v = d.get(key)
        d[key] = cls(**v) if v else None
    d["dtype"] = getattr(torch, d.get("dtype", "float32"))
    known = {f.name for f in dataclasses.fields(LargeVisConfig)}
    return LargeVisConfig(**{k: v for k, v in d.items() if k in known})


# Config fields that describe WHERE a run executes, not WHAT it computes:
# excluded from ``run_fingerprint`` and recorded as the topology tag.
_TOPOLOGY_FIELDS = ("distributed", "data_shards")


def _data_crc(x, h: int = 0) -> int:
    """CRC32 of an array's shape, dtype and a strided sample of ~64 rows
    (cheap at any N; a device tensor is sampled on its device)."""
    xs = x[:: max(1, x.shape[0] // 64)]
    if torch.is_tensor(x):
        xs, dtype = xs.cpu().numpy(), _dtype_name(x.dtype)
    else:
        xs, dtype = np.asarray(xs), np.asarray(x).dtype
    h = zlib.crc32(f"{tuple(x.shape)}:{dtype}".encode(), h)
    return zlib.crc32(np.ascontiguousarray(xs).tobytes(), h)


def run_fingerprint(x, generators, cfg: LargeVisConfig) -> str:
    """Short identity of a (data, generators, cfg) run for resume
    validation.

    The cfg part excludes ``checkpoint`` (so cadence, keep and directory
    changes never invalidate a resume) and the topology fields.
    ``generators``: a ``torch.Generator`` or a list of them (their states
    are hashed as they are when this is called, i.e. at the stage's
    entry), or None.  The data part is a strided row sample of ``x``."""
    cfg_d = cfg_to_dict(cfg)
    cfg_d.pop("checkpoint", None)
    for f in _TOPOLOGY_FIELDS:
        cfg_d.pop(f, None)
    h = zlib.crc32(json.dumps(cfg_d, sort_keys=True).encode())
    if isinstance(generators, torch.Generator):
        generators = [generators]
    for g in generators or ():
        h = zlib.crc32(g.get_state().numpy().tobytes(), h)
    if x is not None:
        h = _data_crc(x, h)
    return f"{h:08x}"


def topology_tag(cfg: LargeVisConfig, n_rows: int, mesh=None) -> dict:
    """Which mesh wrote a stage checkpoint and how many real rows its
    arrays hold, stored under ``extra["topology"]``: ``data_shards`` is
    the mesh's real shard count (never the 0 = "all" of the config), one
    without ``cfg.distributed``.  A restore compares it with its own mesh:
    a mismatch is no error (the arrays are global), it only decides
    whether a layout resume announces a ``TopologyChangeWarning``."""
    distributed = bool(cfg.distributed)
    shards = int(mesh.size) if distributed and mesh is not None else 1
    return {"distributed": distributed, "data_shards": shards,
            "n_rows": int(n_rows)}


def _topology_compatible(meta: dict) -> None:
    """Reject (ValueError) a stage checkpoint whose topology tag is
    degenerate: more shards named than real rows to re-shard.  The
    fallback walk then skips to an older, compatible checkpoint."""
    tag = (meta.get("extra") or {}).get("topology")
    if tag is None:
        return
    shards, n_rows = int(tag.get("data_shards", 1)), int(tag.get("n_rows", 0))
    if n_rows and shards > n_rows:
        raise ValueError(
            f"topology tag names {shards} shards for {n_rows} rows — "
            f"cannot re-shard")


# ---------------------------------------------------------------------------
# Samplers <-> plain array dicts
# ---------------------------------------------------------------------------

def _samplers_to_tree(edge_s, neg_s):
    """(tree, static) for the EdgeSampler/NodeSampler pair (or None)."""
    if edge_s is None or neg_s is None:
        return None, None
    tree = {"edge": {"src": edge_s.src, "dst": edge_s.dst,
                     "threshold": edge_s.threshold, "alias": edge_s.alias},
            "neg": {"threshold": neg_s.threshold, "alias": neg_s.alias}}
    static = {"n_edges": int(edge_s.n_edges), "n_nodes": int(neg_s.n_nodes)}
    return tree, static


def _on(a, device) -> torch.Tensor:
    """A loaded array as a tensor on ``device`` (copied only if it is
    read-only)."""
    return torch.from_numpy(np.require(a, requirements="W")).to(device)


def _samplers_from_tree(tree, static, device):
    from repro_torch.core.sampler import EdgeSampler, NodeSampler
    e, g = tree["edge"], tree["neg"]
    edge_s = EdgeSampler(*(_on(e[k], device)
                           for k in ("src", "dst", "threshold", "alias")),
                         n_edges=int(static["n_edges"]))
    neg_s = NodeSampler(_on(g["threshold"], device), _on(g["alias"], device),
                        n_nodes=int(static["n_nodes"]))
    return edge_s, neg_s


# ---------------------------------------------------------------------------
# Fitted-model persistence (LargeVis.save / LargeVis.load)
# ---------------------------------------------------------------------------

def save_result(path, result) -> None:
    """Persist a fitted LargeVisResult at ``path`` (a directory)."""
    tree = {"y": result.y, "knn_idx": result.knn_idx,
            "knn_dist": result.knn_dist, "weights": result.weights}
    if result.x is not None:
        tree["x"] = result.x
    s_tree, s_static = _samplers_to_tree(result.edge_sampler,
                                         result.neg_sampler)
    if s_tree is not None:
        tree["samplers"] = s_tree
    extra = {"edge_samples": int(result.edge_samples),
             "timings": {k: float(v) for k, v in result.timings.items()},
             "sampler_static": s_static,
             "cfg": cfg_to_dict(result.cfg) if result.cfg else None}
    ck.save(path, 0, tree, keep=1, schema=RESULT_SCHEMA, extra_meta=extra)


def load_result(path, device):
    """Load a fitted model saved by :func:`save_result` (of either
    package) onto ``device``."""
    from repro_torch.core.largevis import LargeVisResult
    tree, _, meta = ck.restore(path, 0, expect_schema=RESULT_SCHEMA,
                               return_meta=True)
    extra = meta.get("extra", {})
    edge_s = neg_s = None
    if "samplers" in tree:
        edge_s, neg_s = _samplers_from_tree(tree["samplers"],
                                            extra["sampler_static"], device)
    cfg = cfg_from_dict(extra["cfg"]) if extra.get("cfg") else None
    return LargeVisResult(
        y=_on(tree["y"], device), knn_idx=_on(tree["knn_idx"], device),
        knn_dist=_on(tree["knn_dist"], device),
        weights=_on(tree["weights"], device),
        timings=extra.get("timings", {}),
        edge_samples=int(extra.get("edge_samples", 0)),
        x=_on(tree["x"], device) if "x" in tree else None,
        edge_sampler=edge_s, neg_sampler=neg_s, cfg=cfg)


# ---------------------------------------------------------------------------
# Pipeline stage checkpoints (crash recovery)
# ---------------------------------------------------------------------------

class StageCheckpointer:
    """Atomic per-stage persistence under ``CheckpointConfig.directory``.

    One subdirectory per stage (``graph``/``weights``/``samplers`` at
    step 0; ``layout`` at its global step with keep-last-k rotation).
    ``load`` returns ``None`` — never raises — when the stage is absent,
    corrupt, or fingerprinted by a different run, so the pipeline falls
    back to recomputing the stage.  Trees are stored global, as host
    arrays, with the writing mesh as a topology tag (never part of the
    fingerprint), so a checkpoint written on P shards resumes on any
    P'."""

    def __init__(self, ckpt_cfg: CheckpointConfig, fingerprint: str):
        self.cfg = ckpt_cfg
        self.fingerprint = fingerprint

    def _dir(self, stage: str) -> pathlib.Path:
        return pathlib.Path(self.cfg.directory) / stage

    def save(self, stage: str, tree, *, step: int = 0, keep: int = 1,
             extra: Optional[dict] = None):
        ck.save(self._dir(stage), step, tree, keep=keep,
                schema=f"largevis-stage-{stage}",
                extra_meta={"fingerprint": self.fingerprint,
                            **(extra or {})})

    def load(self, stage: str):
        """(tree of numpy arrays, step, extra) of the newest valid
        checkpoint, else None."""
        if not self.cfg.resume:
            return None
        try:
            tree, step, meta = ck.restore(
                self._dir(stage), expect_schema=f"largevis-stage-{stage}",
                return_meta=True, validate=_topology_compatible)
        except FileNotFoundError:
            return None
        except (ck.CheckpointCorruptError, ValueError) as e:
            warnings.warn(
                f"checkpoint stage {stage!r} unusable ({e}); recomputing",
                RuntimeWarning, stacklevel=2)
            return None
        extra = meta.get("extra", {})
        if extra.get("fingerprint") != self.fingerprint:
            warnings.warn(
                f"checkpoint stage {stage!r} was written by a different "
                f"run (fingerprint mismatch); recomputing",
                RuntimeWarning, stacklevel=2)
            return None
        return tree, step, extra

    def restore(self, stage: str, device=None, *, mesh=None):
        """:meth:`load`, with every leaf a tensor on ``device`` (or on the
        ``mesh``'s device): ``(tree, step, extra)`` or None.

        The elastic path: the stored arrays are global, and every rank of
        a data mesh holds the global arrays and takes its own row block
        where a stage needs it (``runtime/sharding.py``), so placing
        them on the rank's device is the whole re-shard, for any shard
        count that wrote them."""
        if mesh is not None:
            device = mesh.device
        loaded = self.load(stage)
        if loaded is None:
            return None
        tree, step, extra = loaded
        return _map(tree, lambda a: _on(a, device)), step, extra


class AsyncStageWriter:
    """Off-thread stage-checkpoint writer for unmonitored chunked runs.

    :meth:`submit` snapshots the tree's tensors on the current stream
    (``clone``) and, on the card, records a ``torch.cuda.Event`` after
    the copies; the dispatch loop then keeps enqueueing chunks.  This
    thread waits on that event — never on the whole device — copies the
    snapshot to the host on a stream of its own, and runs the atomic save
    off the dispatch thread.  Saves commit in submission order (one
    thread, FIFO queue) and :meth:`close` drains the queue before
    returning, so the final stage boundary is durable when the layout
    returns.  The bounded queue back-pressures the submitter if the disk
    falls behind, keeping at most ``depth`` snapshots alive.  A save
    failure is re-raised on the next ``submit``/``close``: a run may not
    silently claim durability.

    An optional :class:`~repro_torch.runtime.fault_tolerance.Watchdog` is
    fed the wall time between successive snapshot completions — with the
    device's queue full, the compute time of a save interval — so
    stragglers are flagged without blocking the dispatch loop (the first
    interval is skipped).
    """

    def __init__(self, ckpt: StageCheckpointer, watchdog=None,
                 depth: int = 2):
        self._ckpt = ckpt
        self._watchdog = watchdog
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[Exception] = None
        self._t_last: Optional[float] = None
        self._thread = threading.Thread(
            target=self._run, name="stage-ckpt-writer", daemon=True)
        self._thread.start()

    def submit(self, stage: str, tree, *, step: int = 0, keep: int = 1,
               extra: Optional[dict] = None):
        if self._err is not None:
            raise self._err
        snap, dev = _snapshot(tree)
        event = None
        if dev is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        self._q.put((stage, snap, dev, event, step, keep, extra))

    def _run(self):
        streams: dict = {}
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is not None:
                continue                    # drain without deadlocking put()
            stage, snap, dev, event, step, keep, extra = item
            try:
                host = snap
                if event is not None:
                    event.synchronize()
                    if dev not in streams:
                        streams[dev] = torch.cuda.Stream(dev)
                    # not the dispatch stream: the copy must not queue
                    # behind the chunks enqueued since the snapshot
                    with torch.cuda.stream(streams[dev]):
                        host = _map(snap, ck.to_host)
                now = time.time()
                if self._watchdog is not None and self._t_last is not None:
                    self._watchdog.observe(step, now - self._t_last)
                self._t_last = now
                self._ckpt.save(stage, host, step=step, keep=keep,
                                extra=extra)
            except Exception as e:          # noqa: BLE001 — reraised on submit
                self._err = e

    def close(self):
        """Drain pending saves and join; raises any deferred write error."""
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise self._err


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _snapshot(tree):
    """(the tree with each tensor cloned, the CUDA device of its tensors
    or None)."""
    devices = set()

    def snap(leaf):
        if torch.is_tensor(leaf):
            if leaf.is_cuda:
                devices.add(leaf.device)
            return leaf.clone()
        return leaf

    out = _map(tree, snap)
    if len(devices) > 1:
        raise ValueError(f"a snapshot on one device, not {sorted(devices)}")
    return out, next(iter(devices), None)
