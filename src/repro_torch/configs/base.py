"""Architecture configuration of the LM substrate.

``ArchConfig`` carries the JAX package's fields, names and defaults
(``repro/configs/base.py``), with ``dtype`` a torch dtype;
``ShapeConfig`` names a step's shape (the trainer's batch and sequence).
The shape cells, ``input_specs`` and ``cell_applicable`` belong to the
multi-pod dry-run, which the port does not have.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A single LM-family architecture.

    ``block_pattern`` is one *period* of the layer stack; the full stack is
    ``block_pattern * (n_layers // len(block_pattern))``.
    """

    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention ---
    attn_bias: bool = False          # qwen1.5: bias on QKV projections
    qk_norm: bool = False            # chameleon / gemma3
    rope_theta: float = 10_000.0
    max_position: int = 1 << 20
    sliding_window: int = 0          # 0 = full attention (mixtral: 4096)

    # --- mlp ---
    mlp_type: str = "swiglu"         # swiglu | geglu | gelu

    # --- moe ---
    n_experts: int = 0
    topk_experts: int = 0
    moe_every: int = 1

    # --- layer pattern (one period) ---
    block_pattern: tuple = ("attn",)

    # --- ssm (mamba / xlstm) ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_positions: int = 1500

    # --- frontend stubs ---
    frontend: str = "none"           # none | audio_stub | vq_stub

    # --- misc ---
    embed_scale: bool = False        # gemma: scale embeddings by sqrt(d)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    subquadratic: bool = False
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.block_pattern):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not "
                             f"divisible by period {len(self.block_pattern)}")
        return self.n_layers // len(self.block_pattern)

    def reduced(self) -> "ArchConfig":
        """Smoke-test config: same family/pattern, tiny dims, f32."""
        period = len(self.block_pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=period * min(2, self.n_periods),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(2, self.n_kv_heads)),
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=512,
            n_experts=min(4, self.n_experts),
            topk_experts=min(2, self.topk_experts) if self.topk_experts else 0,
            ssm_state=8,
            ssm_expand=2,
            n_enc_layers=min(2, self.n_enc_layers),
            enc_positions=16,
            max_position=4096,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window
            else 0,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
