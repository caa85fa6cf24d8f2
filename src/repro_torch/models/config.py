"""ModelConfig — one declarative record per architecture.

A copy of ``repro/models/config.py`` (pure data), holding the port's
:class:`~repro_torch.core.quant.QuantConfig`."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.quant import QuantConfig

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # None -> d_model // n_heads

    # --- mixer pattern (cycled over layers) ---
    layer_pattern: Tuple[str, ...] = ("global",)  # global|local|rec|ssd
    window: int = 4096  # local attention window
    rope_theta: float = 10_000.0
    rope_mode: str = "standard"  # standard | mrope | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    logit_softcap: float | None = None
    attn_scale: float | None = None  # None -> 1/sqrt(head_dim)
    attn_score_dtype: str = "float32"  # "bfloat16": flash-style bf16
    # score blocks (f32 MXU accumulation, f32 softmax stats) — halves the
    # dominant HBM term of long-sequence attention
    attn_head_shard: bool = False  # shard attention math on the KV-head
    # dim (uneven counts padded by GSPMD) — §Perf hillclimb A

    # --- ffn ---
    ffn_kind: str = "swiglu"  # swiglu | geglu | gelu
    ffn_pattern: Tuple[str, ...] = ("mlp",)  # mlp | moe (cycled)
    first_k_dense: int = 0  # leading layers forced to dense mlp (deepseek)
    dense_d_ff: int = 0  # hidden width of dense layers inside MoE models

    # --- moe ---
    n_experts: int = 0
    experts_per_token: int = 1
    n_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden; d_ff is the dense-layer hidden
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dp_local: bool = False  # DP-local capacity dispatch: shard-local
    # scatters + one all-to-all instead of global-capacity scatters that
    # GSPMD resolves with whole-buffer all-reduces (§Perf hillclimb B)

    # --- ssm (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # --- rg-lru (recurrentgemma) ---
    lru_width: int = 0
    conv1d_width: int = 4

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # precomputed frame count (1500 for whisper)

    # --- modality stub ---
    embeds_input: bool = False  # input_specs supplies embeddings directly

    # --- misc ---
    tie_embeddings: bool = True
    scale_embeddings: bool = False  # gemma-family sqrt(d_model) embed scale
    norm_eps: float = 1e-6
    use_layer_norm: bool = False  # whisper uses LN, others RMS
    qkv_bias: bool = False

    # --- the paper's technique as a first-class switch ---
    l2r: QuantConfig | None = None
    l2r_levels: int | None = None

    # --- digit-serial attention (models/attention.py) ---
    attn_l2r: QuantConfig | None = None  # quantized QK^T through the L2R
    # score walk, on an incrementally plane-stacked KV cache; softmax/PV
    # stay float
    attn_levels: int | None = None  # MSDF truncation of the score stream
    attn_early_exit: bool = False  # margin-bounded progressive decode
    # attention: the per-row score walk stops once max+normalizer are
    # decided within attn_exit_tol
    attn_exit_tol: float = 1e-4

    # --- precision policy ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ----- derived -----
    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim

    def mixer_kinds(self) -> Tuple[str, ...]:
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def ffn_kinds(self) -> Tuple[str, ...]:
        p = self.ffn_pattern
        out = [p[i % len(p)] for i in range(self.n_layers)]
        for i in range(min(self.first_k_dense, self.n_layers)):
            out[i] = "mlp"
        return tuple(out)

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        return tuple(zip(self.mixer_kinds(), self.ffn_kinds()))

    def block_grouping(self) -> tuple[tuple[tuple[str, str], ...], int, tuple[tuple[str, str], ...], tuple[tuple[str, str], ...]]:
        """Group layers: (prefix, (unit, repeats), suffix).

        prefix = leading layers that break periodicity (first_k_dense);
        unit   = smallest repeating (mixer, ffn) block;
        suffix = trailing remainder layers (unrolled).
        """
        kinds = list(self.layer_kinds())
        prefix = tuple(kinds[: self.first_k_dense])
        body = kinds[self.first_k_dense:]
        if not body:
            return prefix, 0, (), ()
        # smallest repeating unit of the body
        unit_len = 1
        for cand in range(1, len(body) + 1):
            if all(body[i] == body[i % cand] for i in range(len(body))):
                unit_len = cand
                break
        repeats = len(body) // unit_len
        unit = tuple(body[:unit_len])
        suffix = tuple(body[unit_len * repeats:])
        return prefix, repeats, unit, suffix
