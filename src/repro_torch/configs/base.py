"""Architecture and shape configuration of the LM substrate.

``ArchConfig`` carries the JAX package's fields, names and defaults
(``repro/configs/base.py``), with ``dtype`` a torch dtype, and its
analytic ``param_count`` and ``active_param_count``; ``ShapeConfig``
names a step's shape (batch and sequence).  :data:`SHAPES` are the four
assigned input shapes of the dry run (``launch/dryrun.py``), and
``cell_applicable``, ``input_specs`` and ``kv_cache_specs`` its cells'
rule and inputs, as tensors on the meta device (no memory), JAX's
ShapeDtypeStructs.
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

    def param_count(self) -> int:
        """JAX's analytic parameter count (embeddings and blocks), for
        the roofline: its formulas as they are, which differ from the
        parameter tree's sizes (rough xLSTM and mamba blocks)."""
        hd = self.resolved_head_dim
        d = self.d_model
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        if self.mlp_type in ("swiglu", "geglu"):
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        moe_mlp = mlp * self.n_experts + d * self.n_experts
        mamba_inner = d * self.ssm_expand
        mamba = (d * mamba_inner * 2            # in_proj (x, z)
                 + mamba_inner * self.ssm_conv  # conv
                 + mamba_inner * (self.ssm_state * 2 + 1)  # B,C,dt proj-ish
                 + mamba_inner * self.ssm_state            # A
                 + mamba_inner * d)             # out_proj
        xl = 4 * d * d                          # rough mlstm/slstm block
        total = 0
        for li in range(self.n_layers):
            kind = self.block_pattern[li % len(self.block_pattern)]
            use_moe = (self.n_experts > 0 and li % self.moe_every ==
                       (self.moe_every - 1) and kind != "mamba_dense")
            if kind in ("attn", "local", "global"):
                total += attn + (moe_mlp if use_moe else mlp)
            elif kind == "mamba":
                total += mamba + (moe_mlp if use_moe else mlp)
            elif kind in ("mlstm", "slstm"):
                total += xl
            total += 2 * d                      # norms
        total += self.vocab_size * d            # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d        # lm head
        if self.is_encoder_decoder:
            total += self.n_enc_layers * (attn + mlp + 2 * d)
            total += self.n_enc_layers * attn   # cross-attn in decoder
        return int(total)

    def active_param_count(self) -> int:
        """The parameters a token touches (MoE: its top-k experts only),
        JAX's count."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        if self.mlp_type in ("swiglu", "geglu"):
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        dense_total = self.param_count()
        n_moe_layers = sum(
            1 for li in range(self.n_layers)
            if li % self.moe_every == (self.moe_every - 1)
            and self.block_pattern[li % len(self.block_pattern)] != "none")
        inactive = n_moe_layers * mlp * (self.n_experts - self.topk_experts)
        return int(dense_total - inactive)

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


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def cell_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple:
    """(applicable, reason) for an (arch, shape) cell, JAX's rule:
    long_500k needs a sub-quadratic decode path (SSM, hybrid, windowed),
    and an encoder-decoder's decode stays within its ``max_position``."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "long_500k skipped: pure full-attention arch"
    if shape.kind == "decode" and arch.is_encoder_decoder and \
            shape.seq_len > arch.max_position:
        return False, (f"decode seq {shape.seq_len} exceeds enc-dec "
                       "max_position")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: ArchConfig, shape: ShapeConfig, kv_repeat: int = 1,
                kv_quant: bool = False) -> dict:
    """The dry run's inputs of one (arch, shape) cell, on the meta device:
    a training batch's tokens and labels (B, S); a prefill's tokens; a
    decode step's one new token a sequence (B, 1), the filled cache of
    ``seq_len`` slots and the positions (B,); an encoder-decoder's
    precomputed frames (B, enc_positions, d), the audio stub's output."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    specs: dict = {}
    if shape.kind == "train":
        specs["tokens"] = _meta((B, S), i32)
        specs["labels"] = _meta((B, S), i32)
    elif shape.kind == "prefill":
        specs["tokens"] = _meta((B, S), i32)
    else:
        specs["tokens"] = _meta((B, 1), i32)
        specs["cache"] = kv_cache_specs(arch, B, S, kv_repeat, kv_quant)
        specs["position"] = _meta((B,), i32)
    if arch.is_encoder_decoder:
        specs["encoder_frames"] = _meta((B, arch.enc_positions,
                                         arch.d_model), arch.dtype)
    return specs


def kv_cache_specs(arch: ArchConfig, batch: int, seq_len: int,
                   kv_repeat: int = 1, kv_quant: bool = False) -> dict:
    """A filled decode cache's tree on the meta device, from the model's
    own ``factory.cache_specs`` (``init_cache``, whose tree the prefill
    returns and the decode reads), so the dry run's cache cannot drift
    from the implementation."""
    from repro_torch.models.factory import cache_specs
    return cache_specs(arch, batch, seq_len, kv_repeat, kv_quant)
