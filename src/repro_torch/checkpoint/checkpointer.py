"""Atomic, rotating, CRC-verified checkpoints (npz shards), in the JAX
package's on-disk format v2, so a directory written by either package
restores in the other.

Layout:  <dir>/step_<N>/
            meta.json              tree structure + shapes + step + version
            shard_<i>.npz          flattened leaves (host copies)
            _COMMITTED             written LAST -> crash-safe atomicity

Contract (``tests/test_torch_checkpoint.py``):
  * save is atomic: a checkpoint without ``_COMMITTED`` is ignored on
    restore, so a process killed mid-save never corrupts a run;
  * ``restore`` gives the saved leaves bit for bit, as numpy arrays (the
    caller puts them on its device), or cast to the leaves of ``like``
    (dtype, and device for a tensor) after its structure is checked;
  * corruption detection: every shard file's CRC32 is recorded in
    ``meta.json``; a committed but damaged checkpoint fails verification
    and ``restore()`` falls back to the newest older checkpoint that loads
    cleanly;
  * versioned schema: ``meta.json`` carries ``version`` (the on-disk
    format) and a free-form ``schema`` tag (what the tree is, e.g.
    ``largevis-result-v1``); readers reject formats newer than they
    understand and schema tags they did not expect.

The tree is a nested dict of arrays or tensors keyed by strings; its
structure is stored as JAX's ``PyTreeDef`` proto (``treedef``).
"""
from __future__ import annotations

import io
import json
import os
import pathlib
import shutil
import time
import warnings
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import treedef

# on-disk format version.  v1 has no "version"/"crc" fields and is still
# readable (CRC verification is skipped for it); v2 adds them.
FORMAT_VERSION = 2


class CheckpointCorruptError(RuntimeError):
    """A committed checkpoint failed verification (CRC/shape/parse)."""


class CheckpointIncompatibleError(RuntimeError):
    """A committed, uncorrupted checkpoint that this process cannot use.
    In the ``step=None`` fallback walk it is skipped like corruption."""


def to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (tensors copied off their device)."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _crc(path: pathlib.Path) -> int:
    crc = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(block, crc)
    return crc


def save(ckpt_dir, step: int, tree, *, keep: int = 3,
         shard_mb: int = 512, schema: str = "pytree",
         extra_meta: Optional[dict] = None) -> pathlib.Path:
    """Write one checkpoint; returns its path.

    ``schema`` tags what the tree is (validated by loaders that expect a
    specific layout); ``extra_meta`` is an arbitrary JSON-able dict stored
    in meta.json (returned by ``restore(..., return_meta=True)``)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    tmp = ckpt_dir / f"_tmp_step_{step}_{os.getpid()}"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves, proto = treedef.flatten(tree)
    host = [to_host(leaf) for leaf in leaves]
    meta = {"version": FORMAT_VERSION, "schema": schema,
            "step": step, "treedef": proto.hex(),
            "n_leaves": len(host), "time": time.time(),
            "shapes": [list(h.shape) for h in host],
            "dtypes": [str(h.dtype) for h in host]}
    if extra_meta:
        meta["extra"] = extra_meta

    def _write_shard(idx: int, leaves_dict: dict) -> tuple[str, int]:
        # build the npz in memory so the CRC comes from the exact bytes
        # about to hit disk (one write, no read-back pass)
        buf = io.BytesIO()
        np.savez(buf, **leaves_dict)
        data = buf.getbuffer()
        (tmp / f"shard_{idx}.npz").write_bytes(data)
        return f"shard_{idx}.npz", zlib.crc32(data)

    budget = shard_mb * (1 << 20)
    shard, size, shard_idx, index, shard_crc = {}, 0, 0, [], {}
    for i, h in enumerate(host):
        shard[f"leaf_{i}"] = h
        size += h.nbytes
        index.append(shard_idx)
        if size >= budget:
            name, crc = _write_shard(shard_idx, shard)
            shard_crc[name] = crc
            shard, size = {}, 0
            shard_idx += 1
    if shard:
        name, crc = _write_shard(shard_idx, shard)
        shard_crc[name] = crc
    meta["leaf_shard"] = index
    meta["shard_crc"] = shard_crc  # per-shard CRC32 (bit rot guard)
    (tmp / "meta.json").write_text(json.dumps(meta))
    (tmp / "_COMMITTED").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                       # atomic on same filesystem
    _rotate(ckpt_dir, keep)
    return final


def _rotate(ckpt_dir: pathlib.Path, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def all_steps(ckpt_dir) -> list:
    ckpt_dir = pathlib.Path(ckpt_dir)
    out = []
    if not ckpt_dir.exists():
        return out
    for p in ckpt_dir.iterdir():
        if p.name.startswith("step_") and (p / "_COMMITTED").exists():
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    """The newest committed step in ``ckpt_dir``, or None."""
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _like(like, got, where=()):
    """``got`` (numpy leaves) in the structure of ``like``: the same keys
    at every level, each leaf cast to the like leaf's dtype, and a tensor
    leaf's device (a numpy like leaf stays numpy)."""
    if isinstance(like, dict):
        if not isinstance(got, dict) or sorted(like) != sorted(got):
            at = "/".join(where) or "<root>"
            have = sorted(got) if isinstance(got, dict) else "a leaf"
            raise ValueError(f"restore(like=): the checkpoint has {have} "
                             f"at {at}, like has {sorted(like)}")
        return {k: _like(like[k], got[k], where + (k,)) for k in like}
    if isinstance(got, dict):
        raise ValueError(f"restore(like=): a dict at {'/'.join(where)} "
                         "where like has a leaf")
    if torch.is_tensor(like):
        return torch.from_numpy(np.array(got)).to(device=like.device,
                                                  dtype=like.dtype)
    return np.asarray(got).astype(np.asarray(like).dtype)


def _load_step(path: pathlib.Path, *, expect_schema: Optional[str] = None):
    """Load + verify one committed checkpoint directory.

    Raises :class:`CheckpointCorruptError` on any damage (unparseable
    meta, missing/truncated/bit-rotted shards, leaf mismatch) and
    ``ValueError`` on format/schema incompatibility."""
    try:
        meta = json.loads((path / "meta.json").read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable meta.json: {e}")
    version = int(meta.get("version", 1))
    if version > FORMAT_VERSION:
        raise ValueError(
            f"{path}: checkpoint format v{version} is newer than this "
            f"reader (v{FORMAT_VERSION}) — upgrade the code, not the data")
    if expect_schema is not None:
        schema = meta.get("schema", "pytree")
        if schema != expect_schema:
            raise ValueError(
                f"{path}: schema {schema!r} != expected {expect_schema!r}")
    for name, want_crc in meta.get("shard_crc", {}).items():
        p = path / name
        if not p.exists():
            raise CheckpointCorruptError(f"{path}: missing shard {name}")
        if _crc(p) != want_crc:
            raise CheckpointCorruptError(f"{path}: CRC mismatch in {name}")
    shards = {}
    leaves = []
    try:
        for i, sh_idx in enumerate(meta["leaf_shard"]):
            if sh_idx not in shards:
                shards[sh_idx] = np.load(path / f"shard_{sh_idx}.npz")
            leaves.append(shards[sh_idx][f"leaf_{i}"])
    except Exception as e:              # truncated npz, missing key, ...
        raise CheckpointCorruptError(f"{path}: unreadable shards: {e}")
    if len(leaves) != meta["n_leaves"]:
        raise CheckpointCorruptError(
            f"{path}: {len(leaves)} leaves != recorded {meta['n_leaves']}")
    # a tree the port cannot hold (not a dict of arrays) raises ValueError
    return treedef.unflatten(bytes.fromhex(meta["treedef"]), leaves), meta


def restore(ckpt_dir, step: Optional[int] = None, *, like=None,
            expect_schema: Optional[str] = None,
            return_meta: bool = False, validate=None):
    """Load a checkpoint; the leaves are numpy arrays, or with ``like`` (a
    tree of arrays or tensors of the same structure, which is checked)
    cast to each like leaf's dtype and, for a tensor, its device.

    ``step=None`` loads the NEWEST committed checkpoint that passes
    verification — a committed-but-corrupt directory (CRC mismatch,
    truncated shard) is skipped with a warning and the previous one is
    tried, so one damaged save never loses the run.  An explicit ``step``
    raises on damage instead of falling back.

    ``return_meta=True`` appends the meta dict to the return tuple.
    ``validate``: optional ``fn(meta) -> None`` applied to each
    candidate's metadata before it is accepted; raising
    ``ValueError``/:class:`CheckpointIncompatibleError` rejects the
    candidate — skipped (with a warning) in the fallback walk, raised
    for an explicit ``step``."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        candidates = sorted(all_steps(ckpt_dir), reverse=True)
        if not candidates:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    else:
        candidates = [step]
    tree = meta = None
    last_err: Optional[Exception] = None
    for s in candidates:
        path = ckpt_dir / f"step_{s}"
        if not (path / "_COMMITTED").exists():
            raise FileNotFoundError(f"uncommitted checkpoint {path}")
        try:
            tree, meta = _load_step(path, expect_schema=expect_schema)
            if validate is not None:
                try:
                    validate(meta)
                except (ValueError, CheckpointIncompatibleError) as e:
                    raise CheckpointIncompatibleError(f"{path}: {e}") from e
            break
        except (CheckpointCorruptError, CheckpointIncompatibleError) as e:
            if step is not None:
                raise
            kind = ("incompatible"
                    if isinstance(e, CheckpointIncompatibleError)
                    else "corrupt")
            warnings.warn(f"skipping {kind} checkpoint: {e}",
                          RuntimeWarning, stacklevel=2)
            last_err = e
            tree = meta = None
    if tree is None:
        raise CheckpointCorruptError(
            f"every committed checkpoint in {ckpt_dir} failed verification "
            f"(last error: {last_err})")
    if like is not None:
        tree = _like(like, tree)
    if return_meta:
        return tree, meta["step"], meta
    return tree, meta["step"]
