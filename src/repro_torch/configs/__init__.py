"""Configurations: LargeVis hyper-parameters and the LM architectures.

``get_config("qwen1.5-0.5b")`` returns an :class:`ArchConfig`; a name
ending in ``-reduced`` returns its ``reduced()`` smoke form.  The port
holds only the architectures it can run; the JAX package's others are
still to port (ROADMAP Queue 1).
"""
from __future__ import annotations

from repro_torch.configs import qwen15_05b
from repro_torch.configs.base import ArchConfig

_ARCHS = {"qwen1.5-0.5b": qwen15_05b.CONFIG}

ARCH_NAMES = tuple(_ARCHS)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP Queue 1); "
                       f"the port has {sorted(_ARCHS)}")
    return _ARCHS[name]
