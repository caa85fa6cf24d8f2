"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (frontend stub).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064
[arXiv:2409.12191; hf].  Per the assignment the vision tower is a STUB:
input_specs supplies precomputed patch/text embeddings plus the 3-stream
M-RoPE position ids (temporal/height/width).  Pure full attention ->
long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv=4,
    head_dim=128,
    d_ff=18944,
    vocab=152_064,
    ffn_kind="swiglu",
    rope_mode="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    embeds_input=True,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen2vl-smoke",
    family="vlm",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    ffn_kind="swiglu",
    rope_mode="mrope",
    mrope_sections=(4, 2, 2),
    qkv_bias=True,
    embeds_input=True,
    tie_embeddings=False,
    compute_dtype="float32",
)
