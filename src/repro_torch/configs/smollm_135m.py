"""smollm-135m [dense] — llama-arch small.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf].  Also the end-to-end training example
(examples/train_smollm.py).  Pure full attention -> long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv=3,
    head_dim=64,
    d_ff=1536,
    vocab=49_152,
    ffn_kind="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-smoke",
    family="dense",
    n_layers=6,
    d_model=96,
    n_heads=3,
    n_kv=1,
    head_dim=32,
    d_ff=256,
    vocab=512,
    ffn_kind="swiglu",
    compute_dtype="float32",
)
