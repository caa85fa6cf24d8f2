"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144
[hf:google/gemma-3-1b-pt; unverified].  head_dim = d_model//n_heads = 168
(assignment convention).  5 sliding-window layers (1024) per global
layer; only ~1/6 of layers hold full-length KV -> runs long_500k.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv=16,
    head_dim=168,
    d_ff=21504,
    vocab=262_144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    ffn_kind="geglu",
    scale_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    n_layers=8,
    d_model=96,
    n_heads=4,
    n_kv=2,
    head_dim=24,
    d_ff=192,
    vocab=512,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=16,
    ffn_kind="geglu",
    scale_embeddings=True,
    compute_dtype="float32",
)
