"""chameleon-34b [arXiv:2405.09818] — early-fusion VLM backbone; VQ stub.

Image tokens are VQ codes living in the shared 65536 vocab; the VQ tokenizer
frontend is a STUB (tokens arrive pre-quantized).  Backbone is a dense
transformer with QK-norm (chameleon's training-stability fix).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab_size=65_536,
    qk_norm=True,
    rope_theta=10_000.0,
    mlp_type="swiglu",
    block_pattern=("attn",),
    frontend="vq_stub",
    subquadratic=False,
    notes="early fusion, VQ image tokens share the vocab; QK-norm",
)
