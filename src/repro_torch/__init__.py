"""repro_torch: the PyTorch/CUDA port of the LargeVis reproduction.

The port runs the single-device fit, with the fused or the split layout
step, and the out-of-sample transform and insert on an NVIDIA H100
through hand-written CUDA kernels (``csrc/``), built with ``nvcc`` at
first use; on the CPU (``device="cpu"``) the same entry points run the
kernels' plain PyTorch versions.  It imports neither JAX nor the ``repro`` package.

* :class:`LargeVis` — the estimator (``fit`` / ``fit_transform`` /
  ``transform`` / ``insert``).
* :func:`largevis` / :class:`LargeVisResult` — the functional core.
* :class:`LargeVisConfig` / :class:`RoutingConfig` — hyper-parameters.
"""
from repro_torch.api import LargeVis, NotFittedError
from repro_torch.configs.largevis_default import LargeVisConfig, RoutingConfig
from repro_torch.core.largevis import LargeVisResult, largevis

__all__ = [
    "LargeVis",
    "LargeVisConfig",
    "LargeVisResult",
    "NotFittedError",
    "RoutingConfig",
    "largevis",
]
