"""The estimator API of the port: ``fit`` / ``fit_transform``.

    from repro_torch import LargeVis

    model = LargeVis(n_neighbors=50, samples_per_node=2000).fit(x)
    coords = model.embedding_                    # (N, 2) tensor

:class:`LargeVis` wraps ``core.largevis.largevis`` without re-deriving
anything: ``LargeVis(cfg=c).fit(x).embedding_`` is bitwise
``largevis(x, cfg=c).y``.  ``save``, ``load``, ``transform`` and
``insert`` are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.largevis_default import LargeVisConfig
from repro_torch.core.largevis import LargeVisResult, largevis


class NotFittedError(RuntimeError):
    """The model was used before ``fit``."""


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

    def fit(self, x) -> "LargeVis":
        """Run the two-stage pipeline on ``x`` (N, d); returns ``self``."""
        x = _check_input(x, "fit(x)")
        self.result_ = largevis(x, cfg=self.cfg, device=self.device)
        return self

    def fit_transform(self, x) -> torch.Tensor:
        """``fit(x)`` and return the (N, out_dim) embedding."""
        return self.fit(x).embedding_

    @property
    def embedding_(self) -> torch.Tensor:
        if self.result_ is None:
            raise NotFittedError(
                "this LargeVis instance is not fitted yet; call fit() "
                "or fit_transform() first")
        return self.result_.y
