"""jamba-v0.1-52b [arXiv:2403.19887] — hybrid Mamba+attention 1:7, MoE 16e top-2.

Period-8 super-block: attention at position 3, Mamba elsewhere; MoE replaces
the MLP on every other layer (odd layer indices).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    rope_theta=0.0,            # Jamba uses no positional encoding in attn
    mlp_type="swiglu",
    n_experts=16,
    topk_experts=2,
    moe_every=2,               # MoE on every 2nd layer
    block_pattern=(
        "mamba", "mamba", "mamba", "attn",
        "mamba", "mamba", "mamba", "mamba",
    ),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    subquadratic=True,
    notes="1:7 attn:mamba interleave; MoE every 2 layers; no RoPE",
)
