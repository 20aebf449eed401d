"""mixtral-8x7b [arXiv:2401.04088] — MoE 8 experts top-2, sliding-window attn."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    rope_theta=1_000_000.0,
    sliding_window=4096,
    mlp_type="swiglu",
    n_experts=8,
    topk_experts=2,
    moe_every=1,              # every layer is MoE
    block_pattern=("local",), # SWA on all layers
    subquadratic=True,        # SWA bounds decode attention cost
    notes="8e top-2 MoE every layer; SWA 4096",
)
