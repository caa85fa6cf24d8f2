"""Plain oracles for the L2R digit-plane GEMM kernel (exact integer
equality: the kernel computes in int32 end to end, so outputs must match
bit for bit).  The port of ``repro/kernels/l2r_gemm/ref.py``."""

from __future__ import annotations

import torch

from repro_torch.core.l2r_gemm import (_int_dot, l2r_matmul_int,
                                       l2r_matmul_int_stacked, wrap_int32)

__all__ = ["l2r_gemm_ref", "l2r_gemm_ref_stacked", "int_gemm_ref"]


def l2r_gemm_ref(aq: torch.Tensor, bq: torch.Tensor, n_bits: int = 8,
                 log2_radix: int = 2, levels: int | None = None
                 ) -> torch.Tensor:
    """MSDF digit-plane matmul, significance-ordered pair loop.
    aq: (M, K), bq: (K, N) signed ints -> int32 (M, N)."""
    return l2r_matmul_int(aq, bq, n_bits, log2_radix, levels)


def l2r_gemm_ref_stacked(aq: torch.Tensor, bq: torch.Tensor, n_bits: int = 8,
                         log2_radix: int = 2, levels: int | None = None
                         ) -> torch.Tensor:
    """Level-stacked schedule oracle (2D-1 fused matmuls); bit-identical
    to :func:`l2r_gemm_ref` for every (n_bits, log2_radix, levels)."""
    return l2r_matmul_int_stacked(aq, bq, n_bits, log2_radix, levels)


def int_gemm_ref(aq: torch.Tensor, bq: torch.Tensor) -> torch.Tensor:
    """Plain int32 matmul (ground truth for the full-precision case)."""
    return wrap_int32(_int_dot(aq, bq))
