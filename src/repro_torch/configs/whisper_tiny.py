"""whisper-tiny [arXiv:2212.04356] — enc-dec audio; conv frontend is a STUB.

The spec assigns the transformer BACKBONE only: ``input_specs`` supplies
precomputed frame embeddings (the conv frontend output) as an input.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,               # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    rope_theta=0.0,           # learned absolute positions, no RoPE
    mlp_type="gelu",
    block_pattern=("attn",),
    is_encoder_decoder=True,
    max_position=32_768,      # learned positions sized for the decode cells
    n_enc_layers=4,
    enc_positions=1500,       # 30 s audio -> 1500 frames after conv stub
    frontend="audio_stub",
    norm_eps=1e-5,
    subquadratic=False,
    notes="enc-dec; audio conv frontend stubbed with precomputed frames",
)
