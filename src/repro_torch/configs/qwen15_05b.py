"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B] — dense, QKV bias, tied embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,           # GQA kv=16 (== MHA)
    head_dim=64,
    d_ff=2816,
    vocab_size=151_936,
    attn_bias=True,          # QKV bias
    rope_theta=1_000_000.0,
    mlp_type="swiglu",
    block_pattern=("attn",),
    tie_embeddings=True,
    subquadratic=False,
    notes="QKV bias; tied embeddings; full attention",
)
