"""The estimator API of the port: ``fit`` / ``fit_transform`` /
``transform`` / ``insert``.

    from repro_torch import LargeVis

    model = LargeVis(n_neighbors=50, samples_per_node=2000).fit(x)
    coords = model.embedding_                    # (N, 2) tensor
    y_new = model.transform(x_held_out)          # frozen-corpus projection
    y_new = model.insert(x_more)                 # grow the model online

:class:`LargeVis` wraps ``core.largevis.largevis`` without re-deriving
anything: ``LargeVis(cfg=c).fit(x).embedding_`` is bitwise
``largevis(x, cfg=c).y``.  ``transform`` never changes the fitted
carrier ``result_``; ``insert`` appends rows and rebuilds the graph,
weights and samplers, but never moves a fitted coordinate.  ``save`` and
``load`` write and read the JAX package's fitted-model format
(``largevis-result-v1``): a model saved by either package loads in the
other.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.largevis_default import LargeVisConfig
from repro_torch.core import perplexity as perp_lib
from repro_torch.core import sampler as sampler_lib
from repro_torch.core import transform as transform_lib
from repro_torch.core.largevis import (LargeVisResult, as_tensor, largevis,
                                       resolve_device, seeded_generator)

# the JAX package's domain separators for the streams of transform and
# insert; with cfg.seed they seed the default generators
_TRANSFORM_TAG = 0x7472_616E          # "tran"
_INSERT_TAG = 0x696E_7372             # "insr"


class NotFittedError(RuntimeError):
    """``embedding_``, ``transform`` or ``insert`` before ``fit``."""


def _check_input(x, name: str, *, expect_dim: int | None = None,
                 allow_empty: bool = False) -> torch.Tensor:
    """Validate a points matrix at the public-API boundary: rank 2, no
    empty input, the fitted feature width, finite rows."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x))
    if x.dim() != 2:
        raise ValueError(
            f"{name}: expected a 2-D (n_points, n_features) array, "
            f"got shape {tuple(x.shape)}")
    if x.shape[0] == 0 and not allow_empty:
        raise ValueError(f"{name}: empty input (0 points)")
    if x.shape[1] == 0:
        raise ValueError(f"{name}: 0 features")
    if expect_dim is not None and x.shape[1] != expect_dim:
        raise ValueError(
            f"{name}: {x.shape[1]} features, but the fitted corpus has "
            f"{expect_dim}")
    if x.shape[0] and x.is_floating_point():
        finite = torch.isfinite(x).all(dim=1).cpu()
        if not bool(finite.all()):
            bad = torch.nonzero(~finite).flatten()
            raise ValueError(
                f"{name}: {bad.numel()} row(s) contain NaN/Inf "
                f"(first offenders: {bad[:5].tolist()}); clean or drop "
                f"them before calling")
    return x


class LargeVis:
    """LargeVis visualization estimator (Tang et al., WWW 2016).

    Parameters are the fields of :class:`LargeVisConfig`; pass a full
    ``cfg=`` and/or single fields as keyword overrides.  ``device``
    defaults to "cuda"; pass "cpu" for the plain versions of the kernels.
    """

    def __init__(self, cfg: LargeVisConfig | None = None, *,
                 device="cuda", **overrides):
        if cfg is None:
            cfg = LargeVisConfig(**overrides)
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.cfg = cfg
        self.device = device
        self.result_: LargeVisResult | None = None

    def fit(self, x, *, callback=None) -> "LargeVis":
        """Run the two-stage pipeline on ``x`` (N, d); returns ``self``.
        ``callback(t, steps, y)`` (visual progress) runs the layout's
        per-step loop and is called every ``steps // 20`` steps."""
        x = _check_input(x, "fit(x)")
        self.result_ = largevis(x, cfg=self.cfg, device=self.device,
                                callback=callback)
        return self

    def fit_transform(self, x, *, callback=None) -> torch.Tensor:
        """``fit(x)`` and return the (N, out_dim) embedding."""
        return self.fit(x, callback=callback).embedding_

    @property
    def embedding_(self) -> torch.Tensor:
        return self._fitted().y

    def _fitted(self) -> LargeVisResult:
        if self.result_ is None:
            raise NotFittedError(
                "this LargeVis instance is not fitted yet; call fit() "
                "or fit_transform() first")
        return self.result_

    # -- persistence -----------------------------------------------------

    def save(self, path) -> None:
        """Persist the fitted model at ``path`` (a directory).

        Versioned, CRC-verified, atomically committed (schema
        ``largevis-result-v1`` over ``checkpoint/checkpointer.py``): a
        kill mid-save never clobbers a previous good save, and a
        bit-rotted file is detected at load.  Not a pickle: no code runs
        at load."""
        from repro_torch.checkpoint.largevis_state import save_result
        save_result(path, self._fitted())

    @classmethod
    def load(cls, path, *, device="cuda") -> "LargeVis":
        """Restore a model saved by :meth:`save` (or by the JAX package's
        ``LargeVis.save``) onto ``device``; the inverse round trip."""
        from repro_torch.checkpoint.largevis_state import load_result
        dev = resolve_device(device)
        result = load_result(path, dev)
        model = cls(cfg=result.cfg, device=dev)
        model.result_ = result
        return model

    def _generator(self, r: LargeVisResult, tag: int) -> torch.Generator:
        cfg = r.cfg or self.cfg
        return seeded_generator(r.y.device, cfg.seed * 2**32 + tag)

    # -- online operations ----------------------------------------------

    def transform(self, x_new, generator: torch.Generator | None = None):
        """Project queries into the FROZEN fitted layout -> (Q, out_dim).

        The fitted model is read-only here: corpus coordinates enter the
        projection's forces but keep their bits, and ``result_`` is not
        changed.  See ``core.transform.project``.  ``generator`` (on the
        model's device) draws the projection's edges; by default one
        seeded from ``cfg.seed``.
        """
        r = self._fitted()
        x_new = _check_input(x_new, "transform(x_new)",
                             expect_dim=int(r.x.shape[1]))
        x_new = as_tensor(x_new, r.x.device, r.x.dtype)
        if generator is None:
            generator = self._generator(r, _TRANSFORM_TAG)
        y_new, _ = transform_lib.project(
            x_new, x=r.x, y=r.y, generator=generator, cfg=r.cfg or self.cfg,
            neg_sampler=r.neg_sampler)
        return y_new

    def insert(self, x_new, generator: torch.Generator | None = None):
        """Grow the fitted model by ``x_new`` -> their (Q, out_dim) coords.

        No refit: the new points are projected with the corpus frozen,
        the KNN graph is updated by ``core.transform.knn_insert``, the
        edge weights are re-calibrated on it and both samplers rebuilt;
        then the new points are corpus members for later ``transform``
        and ``insert`` calls.  Existing rows of ``embedding_`` do not
        move.
        """
        r = self._fitted()
        cfg = r.cfg or self.cfg
        x_new = _check_input(x_new, "insert(x_new)",
                             expect_dim=int(r.x.shape[1]), allow_empty=True)
        if x_new.shape[0] == 0:
            return torch.zeros((0, r.y.shape[1]), dtype=r.y.dtype,
                               device=r.y.device)
        x_new = as_tensor(x_new, r.x.device, r.x.dtype)
        if generator is None:
            generator = self._generator(r, _INSERT_TAG)
        y_new, aux = transform_lib.project(
            x_new, x=r.x, y=r.y, generator=generator, cfg=cfg,
            neg_sampler=r.neg_sampler)
        qc_idx, qc_dist = aux["nn_idx"], aux["nn_dist"]
        if qc_idx.shape[1] != r.knn_idx.shape[1]:   # n_neighbors drifted
            qc_idx, qc_dist = None, None
        x_all, idx_all, dist_all = transform_lib.knn_insert(
            r.x, r.knn_idx, r.knn_dist, x_new, generator=generator, cfg=cfg,
            qc_idx=qc_idx, qc_dist=qc_dist)
        w_all = perp_lib.edge_weights(idx_all, dist_all, cfg.perplexity,
                                      iters=cfg.perplexity_iters)
        r.x = x_all
        r.y = torch.cat([r.y.float(), y_new])
        r.knn_idx, r.knn_dist, r.weights = idx_all, dist_all, w_all
        r.edge_sampler = sampler_lib.build_edge_sampler(idx_all, w_all)
        r.neg_sampler = sampler_lib.build_negative_sampler(
            idx_all, w_all, power=cfg.neg_power)
        return y_new
