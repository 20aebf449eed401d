"""xlstm-125m [arXiv:2405.04517] — alternating mLSTM/sLSTM blocks, no FFN.

d_ff=0: xLSTM blocks carry their own up/down projections (mLSTM runs at 2x
expansion, sLSTM at model width with a gated feed-through).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50_304,
    rope_theta=0.0,
    mlp_type="none",
    block_pattern=("mlstm", "slstm"),
    tie_embeddings=True,
    subquadratic=True,
    notes="recurrent (linear-time) blocks; associative-scan implementation",
)
