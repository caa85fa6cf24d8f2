"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

24L d_model=768 d_ff=0 vocab=50280, ssm_state=128 [arXiv:2405.21060;
unverified].  Each layer is a Mamba-2 block (no separate MLP):
d_inner = 2*768 = 1536, head_dim 64 -> 24 SSD heads, conv width 4.
O(1) recurrent state -> runs long_500k.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,  # SSD heads (d_inner / ssm_head_dim); attention-free
    n_kv=24,
    d_ff=0,
    vocab=50_280,
    layer_pattern=("ssd",),
    ffn_pattern=("none",),
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    rope_mode="none",
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=8,
    n_kv=8,
    d_ff=0,
    vocab=512,
    layer_pattern=("ssd",),
    ffn_pattern=("none",),
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=16,
    rope_mode="none",
    compute_dtype="float32",
)
