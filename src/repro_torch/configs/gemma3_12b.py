"""gemma3-12b [hf:google/gemma-3-*-pt family] — dense, 5:1 local:global."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15_360,
    vocab_size=262_144,
    qk_norm=True,
    rope_theta=1_000_000.0,   # global layers; locals use 10k (handled in rotary)
    sliding_window=1024,      # local layers
    mlp_type="geglu",
    # one period: 5 sliding-window locals then 1 global (5:1)
    block_pattern=("local", "local", "local", "local", "local", "global"),
    embed_scale=True,
    tie_embeddings=True,
    subquadratic=True,        # decode dominated by windowed local layers
    notes="5:1 local:global, 128k context, QK-norm, GeGLU, 262k vocab",
)
