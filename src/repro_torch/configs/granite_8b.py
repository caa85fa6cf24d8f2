"""granite-8b [dense] — llama-arch, code.

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152
[arXiv:2405.04324; hf].  Pure full attention -> long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=14336,
    vocab=49_152,
    ffn_kind="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    ffn_kind="swiglu",
    compute_dtype="float32",
)
