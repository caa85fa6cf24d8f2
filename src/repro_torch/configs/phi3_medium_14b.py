"""phi3-medium-14b [dense] — RoPE SwiGLU GQA.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352
[arXiv:2404.14219; unverified].  Pure full attention -> long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv=10,
    head_dim=128,
    d_ff=17920,
    vocab=100_352,
    ffn_kind="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="phi3-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=8,
    n_kv=2,
    head_dim=8,
    d_ff=160,
    vocab=512,
    ffn_kind="swiglu",
    tie_embeddings=False,
    compute_dtype="float32",
)
