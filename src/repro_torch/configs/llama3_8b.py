"""llama3-8b [arXiv:2407.21783] — dense GQA, 128k vocab."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=128_256,
    rope_theta=500_000.0,
    mlp_type="swiglu",
    block_pattern=("attn",),
    subquadratic=False,
    notes="GQA kv=8, SwiGLU, full attention",
)
