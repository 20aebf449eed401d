"""Evaluation metrics: KNN-graph recall (the paper's graph accuracy) and
the KNN-classifier accuracy of the 2-D layout (its layout quality proxy).
Both rank candidates with the pairwise-distance kernel and a stable sort,
so ties go to the earliest index as in the JAX package."""
from __future__ import annotations

import torch

from repro_torch.core.largevis import as_tensor, seeded_generator
from repro_torch.kernels import ops


def knn_classifier_accuracy(y2d, labels, *, k: int = 5, n_test: int = 1000,
                            generator: torch.Generator | None = None) -> float:
    """Hold out n_test points; classify each by the majority label of its
    k nearest neighbors (in the layout) among the remaining points."""
    dev = y2d.device
    labels = as_tensor(labels, dev).long()
    n = y2d.shape[0]
    n_test = min(n_test, n // 4)
    perm = torch.randperm(n, device=dev,
                          generator=generator or seeded_generator(dev, 0))
    test, train = perm[:n_test], perm[n_test:]
    d = ops.pairwise_sqdist(y2d[test], y2d[train])
    ni = torch.sort(d, dim=1, stable=True).indices[:, :k]
    votes = labels[train][ni]                              # (n_test, k)
    n_classes = int(labels.max()) + 1
    counts = torch.nn.functional.one_hot(votes, n_classes).sum(1)
    pred = counts.argmax(1)
    return float((pred == labels[test]).float().mean())


def graph_recall(x, knn_idx, *, n_eval: int = 2000,
                 generator: torch.Generator | None = None) -> float:
    """Recall of the graph against exact KNN on a random node subset."""
    dev = x.device
    n, k = knn_idx.shape
    rows = torch.randperm(n, device=dev,
                          generator=generator or seeded_generator(dev, 1))
    rows = rows[:min(n_eval, n)]
    d = ops.pairwise_sqdist(x[rows], x)
    d[torch.arange(rows.shape[0], device=dev), rows] = 3.4e38
    true_idx = torch.sort(d, dim=1, stable=True).indices[:, :k]
    got = knn_idx[rows].long()
    return float((got[:, :, None] == true_idx[:, None, :]).any(-1)
                 .float().mean())
