"""Carry a fitted LargeVis state between the JAX package and the port.

The state is a dict of numpy arrays (LargeVis's counterpart of model
weights): ``y``, ``knn_idx``, ``knn_dist``, ``weights``, ``x``, the edge
sampler's ``edge_src``/``edge_dst``/``edge_threshold``/``edge_alias`` and
the node sampler's ``node_threshold``/``node_alias``.

:func:`result_to_numpy` reads those fields off any result object that has
them (the port's :class:`LargeVisResult`, or the JAX package's, whose
arrays ``numpy.asarray`` accepts), and :func:`result_from_numpy` builds the
port's result on a device.  A round trip is bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.largevis_default import LargeVisConfig
from repro_torch.core.largevis import LargeVisResult, resolve_device
from repro_torch.core.sampler import EdgeSampler, NodeSampler

_FIELDS = ("y", "knn_idx", "knn_dist", "weights", "x")
_EDGE = ("src", "dst", "threshold", "alias")
_NODE = ("threshold", "alias")


def _np(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def result_to_numpy(result) -> dict:
    """The fitted state of ``result`` as a dict of numpy arrays."""
    out = {f: _np(getattr(result, f)) for f in _FIELDS}
    out.update({f"edge_{f}": _np(getattr(result.edge_sampler, f))
                for f in _EDGE})
    out.update({f"node_{f}": _np(getattr(result.neg_sampler, f))
                for f in _NODE})
    return out


def result_from_numpy(arrays: dict, cfg: LargeVisConfig | None = None,
                      device="cuda") -> LargeVisResult:
    """The port's :class:`LargeVisResult` from a dict of numpy arrays."""
    dev = resolve_device(device)

    def t(name):
        return torch.from_numpy(np.array(arrays[name])).to(dev)

    n_nodes = int(arrays["y"].shape[0])
    edge = EdgeSampler(*(t(f"edge_{f}") for f in _EDGE),
                       n_edges=int(arrays["edge_src"].shape[0]))
    node = NodeSampler(*(t(f"node_{f}") for f in _NODE), n_nodes=n_nodes)
    return LargeVisResult(
        y=t("y"), knn_idx=t("knn_idx"), knn_dist=t("knn_dist"),
        weights=t("weights"), timings={}, edge_samples=0, x=t("x"),
        edge_sampler=edge, neg_sampler=node,
        cfg=cfg if cfg is not None else LargeVisConfig())
