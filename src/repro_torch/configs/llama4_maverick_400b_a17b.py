"""llama4-maverick-400b-a17b [moe] — MoE top-1 + shared expert, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  Llama-4 interleaves
MoE every other layer (dense layers use d_ff 16384); each MoE layer has
128 routed experts (top-1, d_ff 8192) + 1 shared expert.  Totals ~400B
params / ~17B active.  Pure full attention -> long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    head_dim=128,
    d_ff=8192,          # assigned: per-expert hidden
    vocab=202_048,
    ffn_kind="swiglu",
    ffn_pattern=("mlp", "moe"),  # interleave_moe_layer_step = 2
    dense_d_ff=16384,
    n_experts=128,
    experts_per_token=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    rope_theta=500_000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="llama4-smoke",
    family="moe",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=96,
    vocab=512,
    ffn_kind="swiglu",
    ffn_pattern=("mlp", "moe"),
    dense_d_ff=192,
    n_experts=8,
    experts_per_token=1,
    n_shared_experts=1,
    moe_d_ff=96,
    tie_embeddings=False,
    compute_dtype="float32",
)
