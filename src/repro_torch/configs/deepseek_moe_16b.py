"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained.

28L d_model=2048 16H (GQA kv=16 / MHA) d_ff=1408 vocab=102400, MoE 64e
top-6 [arXiv:2401.06066; hf].  Layer 0 is a dense MLP (hidden 10944, the
published config); layers 1..27 are MoE with 2 shared experts.
Pure full attention -> long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    head_dim=128,
    d_ff=1408,          # assigned: per-expert hidden
    vocab=102_400,
    ffn_kind="swiglu",
    ffn_pattern=("moe",),
    first_k_dense=1,
    dense_d_ff=10944,
    n_experts=64,
    experts_per_token=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    rope_theta=10_000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    family="moe",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv=4,
    head_dim=16,
    d_ff=48,
    vocab=512,
    ffn_kind="swiglu",
    ffn_pattern=("moe",),
    first_k_dense=1,
    dense_d_ff=192,
    n_experts=8,
    experts_per_token=2,
    n_shared_experts=2,
    moe_d_ff=48,
    tie_embeddings=False,
    compute_dtype="float32",
)
