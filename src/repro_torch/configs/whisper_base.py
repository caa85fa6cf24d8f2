"""whisper-base [audio] — encoder-decoder, conv frontend (stub).

6L d_model=512 8H (kv=8 / MHA) d_ff=2048 vocab=51865 [arXiv:2212.04356;
unverified].  Per the assignment the mel+conv frontend is a STUB:
input_specs supplies precomputed frame embeddings (B, 1500, 512).
LayerNorm, GELU, learned positions, attention biases (whisper idioms).
Decoder is pure full attention -> long_500k skipped (and the enc-dec
task caps source length at 1500 frames).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,            # decoder layers
    encoder_layers=6,
    encoder_seq=1500,
    d_model=512,
    n_heads=8,
    n_kv=8,
    head_dim=64,
    d_ff=2048,
    vocab=51_865,
    ffn_kind="gelu",
    use_layer_norm=True,
    qkv_bias=True,
    rope_mode="none",
    norm_eps=1e-5,
    embeds_input=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    n_layers=2,
    encoder_layers=2,
    encoder_seq=24,
    d_model=64,
    n_heads=4,
    n_kv=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    ffn_kind="gelu",
    use_layer_norm=True,
    qkv_bias=True,
    rope_mode="none",
    embeds_input=True,
    compute_dtype="float32",
)
