"""Per-vector quantization for the digit-serial attention scores.

The port of ``repro/core/l2r_attention.py:quantize_per_vector``, the part
the flash-attention kernels need.  Each query row and each key slot
carries its own scale, so the scales commute with the score contraction
and with any chunking of the key axis.  The score walks and the rest of
that module come with the LM backbone.
"""

from __future__ import annotations

import torch

from .quant import QuantConfig, _symmetric_quant

__all__ = ["quantize_per_vector"]


def quantize_per_vector(x: torch.Tensor, cfg: QuantConfig):
    """Symmetric quantization with one scale per trailing vector.

    x (..., K) -> (q (..., K) int, scale (..., 1) f32), through the one
    formula of :func:`~repro_torch.core.quant._symmetric_quant`, so the
    scales are bit-identical to the reference's.
    """
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    return _symmetric_quant(xf, amax, cfg)
