"""Configurations: LargeVis hyper-parameters and the LM architectures.

``get_config("gemma3-12b")`` returns an :class:`ArchConfig`; a name
ending in ``-reduced`` returns its ``reduced()`` smoke form.  The port
holds the architectures it can run: the dense, GQA, sliding-window,
local:global and MoE decoders.  The JAX package's mamba and xLSTM
models (jamba-v0.1-52b, xlstm-125m) and its encoder-decoder
(whisper-tiny) are still to port (ROADMAP Queue 1).
"""
from __future__ import annotations

from repro_torch.configs import (chameleon_34b, dbrx_132b, gemma3_12b,
                                 llama3_8b, mixtral_8x7b, phi3_medium_14b,
                                 qwen15_05b)
from repro_torch.configs.base import ArchConfig

_ARCHS = {cfg.name: cfg for cfg in (
    qwen15_05b.CONFIG, gemma3_12b.CONFIG, llama3_8b.CONFIG,
    phi3_medium_14b.CONFIG, mixtral_8x7b.CONFIG, dbrx_132b.CONFIG,
    chameleon_34b.CONFIG)}

ARCH_NAMES = tuple(_ARCHS)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP Queue 1); "
                       f"the port has {sorted(_ARCHS)}")
    return _ARCHS[name]
