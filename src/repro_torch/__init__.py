"""repro_torch: the PyTorch/CUDA port of the LargeVis reproduction.

The port runs the single-device fit (crash-safe with
``LargeVisConfig.checkpoint``, health-guarded with ``.health``; the hash
or the random-projection tree forest, ``.rp_mode``), with the fused or
the split layout step, ``save``/``load`` in the JAX package's
format, and the out-of-sample transform and insert on an NVIDIA H100
through hand-written CUDA kernels (``csrc/``), built with ``nvcc`` at
first use; on the CPU (``device="cpu"``) the same entry points run the
kernels' plain PyTorch versions.  It imports neither JAX nor the ``repro`` package.
The LM serving path (``qwen1.5-0.5b``) is ``launch.serve.ServeEngine``
over ``models/``; its long-prompt prefill runs the flash-attention kernel.

* :class:`LargeVis` — the estimator (``fit`` / ``fit_transform`` /
  ``transform`` / ``insert`` / ``save`` / ``load``).
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
