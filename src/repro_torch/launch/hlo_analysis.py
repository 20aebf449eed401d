"""The counts of the launch harness's cost records — the JAX package's
``launch/hlo_analysis.py``.

JAX reads them off the compiled HLO: ``cost_analysis()`` (flops, bytes
accessed, transcendentals), ``memory_analysis()`` (a device's argument,
output and temporary bytes) and the collectives parsed from the HLO text,
each multiplied by its ``while`` loop's trip count.  The port has no HLO,
so it counts what the same records hold from what it runs:

* :func:`collective_bytes`: from a ``launch/mesh.py::RecordingMesh`` log,
  the bytes a rank hands each collective, under JAX's op names
  (:data:`COLLECTIVE_OPS`, :data:`KIND_OPS`), with the port's
  ``kind:axis`` detail beside them.  The port's loops are eager Python
  loops that log every trip, so no trip count multiplies anything.
* :class:`Counter` and :func:`cost_stats`: in one ``TorchDispatchMode``,
  one Python call an aten op, the flops of torch's flop formulas (the
  matrix products, as ``FlopCounterMode`` applies them) plus the work the
  hand-written kernels record for themselves (``kernels/ops.py::
  recording_work``: the flash forward and backward, which no operation
  counter sees on the meta device or the card); the bytes accessed (each
  aten op's operands and results, views and allocations excepted) and
  the transcendentals (the elements of exp, log, log1p, tanh, sigmoid,
  rsqrt and the like, by XLA's list).  It works on the meta device and
  on the card.
* :func:`memory_stats`: JAX's five keys from the arguments' and outputs'
  tensors and, on the card, ``torch.cuda.max_memory_allocated`` over the
  run; the temporaries are unknown on the meta device (None, not 0).

JAX's HLO text parsers (``_shape_bytes``, ``_computation_blocks``,
``_trip_counts``) have no counterpart: there is no text to parse.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops
from repro_torch.models import costbook

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# the RecordingMesh's kinds under JAX's op names: the exchange of pieces
# is an all-to-all with sizes, a ring shift and a one-source broadcast
# are point-to-point sends (XLA's collective-permute)
KIND_OPS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
            "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
            "exchange": "all-to-all", "ring_shift": "collective-permute",
            "broadcast": "collective-permute"}


def collective_bytes(log) -> dict:
    """``{op: bytes, ..., "total": bytes, "by_kind": {kind:axis: {"calls",
    "bytes"}}}`` of a ``RecordingMesh`` log of ``(kind, axis, bytes)``.
    Every trip of a loop is in the log, so the sums need no trip-count
    multiplier (JAX's need XLA's ``known_trip_count``)."""
    out = {op: 0 for op in COLLECTIVE_OPS}
    by_kind: dict = {}
    for kind, axis, n in log:
        out[KIND_OPS[kind]] += int(n)
        rec = by_kind.setdefault(f"{kind}:{axis}", {"calls": 0, "bytes": 0})
        rec["calls"] += 1
        rec["bytes"] += int(n)
    out["total"] = sum(out[op] for op in COLLECTIVE_OPS)
    out["by_kind"] = by_kind
    return out


# transcendentals an element, XLA's HloCostAnalysis list (exp, expm1,
# log, log1p, logistic, rsqrt, sqrt, tanh, power, the trigonometric ops,
# erf), by aten op; a fused op counts each transcendental it applies
# (softplus is log1p(exp)), a backward the ones it recomputes
_TRANSCENDENTAL = {
    "exp": 1, "exp2": 1, "expm1": 1, "log": 1, "log2": 1, "log10": 1,
    "log1p": 1, "sigmoid": 1, "tanh": 1, "rsqrt": 1, "sqrt": 1, "pow": 1,
    "sin": 1, "cos": 1, "tan": 1, "erf": 1, "erfc": 1, "atan2": 1,
    "softplus": 2, "softplus_backward": 1, "silu": 1, "silu_backward": 1,
    "logaddexp": 2, "gelu": 1, "gelu_backward": 1, "_softmax": 1,
    "_log_softmax": 2,
    "_log_softmax_backward_data": 1, "logsumexp": 2,
}
# ops that move no data: allocations, views and metadata
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias", "set",
         "resize", "_local_scalar_dense"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _arg_bytes(xs) -> int:
    """The bytes of the tensors in a flat sequence of an op's arguments
    (a list of tensors among them counts)."""
    n = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            n += x.nbytes
        elif isinstance(x, (list, tuple)):
            n += _arg_bytes(x)
    return n


def _numel(xs) -> int:
    n = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            n += x.numel()
        elif isinstance(x, (list, tuple)):
            n += _numel(x)
    return n


_CIA = torch._C.DispatchKey.CompositeImplicitAutograd


class Counter(TorchDispatchMode):
    """Flops, bytes accessed and transcendentals of every aten op run
    under it (:mod:`the module docstring <repro_torch.launch.
    hlo_analysis>`); :func:`counting` adds the cost book and the kernels'
    own work.  The flops follow ``FlopCounterMode``'s rule: an op with a
    composite decomposition is decomposed and its parts counted, else its
    formula in ``flop_registry`` (by op packet) counts it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.book = None            # the cost book, under counting()
        self.kernels = []           # (label, flops, bytes) a kernel call
        # op -> (decomposes, flop formula, moves no data, transcendentals)
        self._kind: dict = {}

    def _of(self, func):
        packet = func._overloadpacket
        name = packet.__name__
        name = name.rstrip("_") or name
        decomposes = func is not torch.ops.prim.device.default and (
            _CIA in func.py_kernels or
            torch._C._dispatch_has_kernel_for_dispatch_key(func.name(),
                                                           _CIA))
        kind = (decomposes, flop_registry.get(packet),
                name in _FREE or bool(getattr(func, "is_view", False)),
                _TRANSCENDENTAL.get(name, 0))
        self._kind[func] = kind
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        decomposes, formula, free, per = self._kind.get(func) or \
            self._of(func)
        if decomposes:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not free:
            self.bytes_accessed += _arg_bytes(args) + \
                _arg_bytes(kwargs.values()) + _arg_bytes((out,))
            if per:
                self.transcendentals += per * _numel((out,))
        return out


@contextlib.contextmanager
def counting():
    """Count what runs in the block: yields a :class:`Counter` holding the
    cost book's entries (``book``) and the kernels' own work
    (``kernels``), to hand :func:`cost_stats` after it."""
    with costbook.recording() as book, ops.recording_work() as kernels, \
            Counter() as counter:
        counter.book, counter.kernels = book, kernels
        yield counter


def cost_stats(counter: Counter) -> dict:
    """JAX's ``cost_stats`` keys from a :func:`counting` block: ``flops``
    (the counter's plus the hand-written kernels' own, each also given
    alone), ``bytes_accessed`` (the ops' and the kernels') and
    ``transcendentals``."""
    kf = sum(f for _, f, _ in counter.kernels)
    kb = sum(b for _, _, b in counter.kernels)
    counted = float(counter.flops)
    return {"flops": counted + kf,
            "bytes_accessed": float(counter.bytes_accessed + kb),
            "transcendentals": float(counter.transcendentals),
            "counter_flops": counted, "kernel_flops": float(kf)}


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def tree_size(tree) -> dict:
    """{"elements", "bytes"} of a tree's tensors (dicts, lists, tuples and
    modules' parameters)."""
    ts = list(_leaves(tree))
    return {"elements": int(sum(t.numel() for t in ts)),
            "bytes": int(sum(_nbytes(t) for t in ts))}


def memory_stats(args, outputs, peak: int = None, before: int = None
                 ) -> dict:
    """JAX's ``memory_stats`` keys: the arguments' and outputs' bytes from
    their tensors; ``temp_size_in_bytes`` the card's
    ``max_memory_allocated`` over the run (``peak``) less what was
    allocated before it (``before``: the arguments), None on the meta
    device (``peak`` None); no generated code and no aliases (0)."""
    temp = None if peak is None else int(peak - before)
    return {"argument_size_in_bytes": tree_size(args)["bytes"],
            "output_size_in_bytes": tree_size(outputs)["bytes"],
            "temp_size_in_bytes": temp,
            "generated_code_size_in_bytes": 0,
            "alias_size_in_bytes": 0}
