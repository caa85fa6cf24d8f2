"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern.

26L d_model=2560 10H (GQA kv=1 / MQA) d_ff=7680 vocab=256000
[arXiv:2402.19427; hf].  Pattern: (rec, rec, local-attn) repeated; local
window 2048; GeGLU MLP; head_dim 256; gemma-style embed scaling.
Bounded state (LRU + 2048-window KV) -> runs the long_500k cell.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,
    head_dim=256,
    d_ff=7680,
    vocab=256_000,
    layer_pattern=("rec", "rec", "local"),
    window=2048,
    lru_width=2560,
    conv1d_width=4,
    ffn_kind="geglu",
    scale_embeddings=True,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv=1,
    head_dim=16,
    d_ff=128,
    vocab=512,
    layer_pattern=("rec", "rec", "local"),
    window=16,
    lru_width=64,
    ffn_kind="geglu",
    scale_embeddings=True,
    compute_dtype="float32",
)
