"""Architecture registry: --arch <id> -> config, shapes, cells.

The port of ``repro/configs/registry.py``: the 10 assigned architectures
x 4 shapes = 40 cells.  `long_500k` requires sub-quadratic attention: it
runs for the SSM/hybrid/mostly-local archs and is a documented skip for
the pure-full-attention ones.  :func:`input_specs` gives a cell's inputs
as tensors on the ``meta`` device (shapes and dtypes, no storage).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig

from . import (deepseek_moe_16b, gemma3_27b, granite_8b,
               llama4_maverick_400b_a17b, mamba2_130m, phi3_medium_14b,
               qwen2_vl_7b, recurrentgemma_2b, smollm_135m, whisper_base)

__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_config", "get_smoke",
           "cell_supported", "all_cells", "input_specs"]

_MODULES = {
    "recurrentgemma-2b": recurrentgemma_2b,
    "phi3-medium-14b": phi3_medium_14b,
    "smollm-135m": smollm_135m,
    "gemma3-27b": gemma3_27b,
    "granite-8b": granite_8b,
    "mamba2-130m": mamba2_130m,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "whisper-base": whisper_base,
    "qwen2-vl-7b": qwen2_vl_7b,
}

ARCHS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention over the 500k context:
_LONG_OK = {"recurrentgemma-2b", "mamba2-130m", "gemma3-27b"}
LONG_SKIP_REASON = (
    "pure full-attention decode over a 524288-token KV cache; assignment "
    "directs skip for non-SSM/hybrid/local archs (DESIGN.md §4)"
)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _MODULES[arch].SMOKE


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in _LONG_OK:
        return False, LONG_SKIP_REASON
    return True, ""


def all_cells():
    for a in ARCHS:
        for s in SHAPES:
            yield a, s, *cell_supported(a, s)


def input_specs(arch: str, shape: str | ShapeSpec,
                cfg: ModelConfig | None = None) -> dict:
    """Every model input of this cell as an empty tensor on the ``meta``
    device (its shape and dtype; nothing is allocated).  ``shape`` names
    a cell of :data:`SHAPES`, or is a :class:`ShapeSpec` of its own.

    train/prefill: the full token (or stub-embedding) batch, with the
    labels for train; decode: the current token (the cache or state
    enters separately).
    """
    cfg = cfg or get_config(arch)
    sp = shape if isinstance(shape, ShapeSpec) else SHAPES[shape]
    b, s = sp.global_batch, sp.seq_len

    def sd(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device="meta")

    i32, bf16 = torch.int32, torch.bfloat16
    if sp.kind == "decode":
        out = {"tokens": sd((b, 1), i32)}
        if cfg.rope_mode == "mrope":
            out["rope_positions"] = sd((3, b, 1), i32)
        return out
    if cfg.family == "encdec":
        out = {"frames": sd((b, cfg.encoder_seq, cfg.d_model), bf16),
               "tokens": sd((b, s), i32)}
    elif cfg.embeds_input:  # vlm stub: precomputed patch/text embeddings
        out = {"embeds": sd((b, s, cfg.d_model), bf16)}
        if cfg.rope_mode == "mrope":
            out["rope_positions"] = sd((3, b, s), i32)
    else:
        out = {"tokens": sd((b, s), i32)}
    if sp.kind == "train":
        out["labels"] = sd((b, s), i32)
    return out
