"""phi3-medium-14b [arXiv:2404.14219] — dense GQA, RoPE, SwiGLU."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17_920,
    vocab_size=100_352,
    rope_theta=10_000.0,
    mlp_type="swiglu",
    block_pattern=("attn",),
    subquadratic=False,
    notes="GQA kv=10, SwiGLU, full attention",
)
