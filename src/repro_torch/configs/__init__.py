"""Configurations: LargeVis hyper-parameters and the LM architectures.

``get_config("gemma3-12b")`` returns an :class:`ArchConfig`; a name
ending in ``-reduced`` returns its ``reduced()`` smoke form.  The port
holds every architecture of the JAX package, in its order: the dense,
GQA, sliding-window, local:global and MoE decoders, the hybrid
mamba + attention decoder (jamba-v0.1-52b), the mLSTM/sLSTM decoder
(xlstm-125m) and the encoder-decoder (whisper-tiny).
"""
from __future__ import annotations

from repro_torch.configs import (chameleon_34b, dbrx_132b, gemma3_12b,
                                 jamba_v01_52b, llama3_8b, mixtral_8x7b,
                                 phi3_medium_14b, qwen15_05b, whisper_tiny,
                                 xlstm_125m)
from repro_torch.configs.base import (ArchConfig, SHAPES,  # noqa: F401
                                      ShapeConfig, cell_applicable,
                                      input_specs, kv_cache_specs)

_ARCHS = {cfg.name: cfg for cfg in (
    qwen15_05b.CONFIG, gemma3_12b.CONFIG, llama3_8b.CONFIG,
    phi3_medium_14b.CONFIG, whisper_tiny.CONFIG, mixtral_8x7b.CONFIG,
    dbrx_132b.CONFIG, jamba_v01_52b.CONFIG, chameleon_34b.CONFIG,
    xlstm_125m.CONFIG)}

ARCH_NAMES = tuple(_ARCHS)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[name]


def all_configs() -> dict:
    """{name: config} of every architecture, in the JAX package's order."""
    return {name: get_config(name) for name in ARCH_NAMES}
