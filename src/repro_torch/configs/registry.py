"""Architecture registry: --arch <id> -> config, shapes, cells.

The port of ``repro/configs/registry.py``: the 10 assigned architectures
x 4 shapes = 40 cells.  `long_500k` requires sub-quadratic attention: it
runs for the SSM/hybrid/mostly-local archs and is a documented skip for
the pure-full-attention ones.  The reference's ``input_specs`` (the XLA
dry-run's abstract inputs) has no counterpart here.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

from . import (deepseek_moe_16b, gemma3_27b, granite_8b,
               llama4_maverick_400b_a17b, mamba2_130m, phi3_medium_14b,
               qwen2_vl_7b, recurrentgemma_2b, smollm_135m, whisper_base)

__all__ = ["ARCHS", "SHAPES", "get_config", "get_smoke", "cell_supported",
           "all_cells"]

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
