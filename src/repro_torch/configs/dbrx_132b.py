"""dbrx-132b [hf:databricks/dbrx-base] — fine-grained MoE 16 experts top-4."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10_752,
    vocab_size=100_352,
    rope_theta=500_000.0,
    mlp_type="swiglu",
    n_experts=16,
    topk_experts=4,
    moe_every=1,
    block_pattern=("attn",),
    subquadratic=False,
    notes="16e top-4 fine-grained MoE; full attention",
)
