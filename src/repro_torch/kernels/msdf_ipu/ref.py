"""Oracles for the PE-array kernel: the scalar CIPU golden model and the
integer SOP.  The port of ``repro/kernels/msdf_ipu/ref.py``."""

from __future__ import annotations

import torch

from repro_torch.core.ipu import simulate_cipu

__all__ = ["cipu_array_ref", "int_sop_ref"]


def cipu_array_ref(a: torch.Tensor, b: torch.Tensor,
                   n_bits: int = 8) -> torch.Tensor:
    return simulate_cipu(a, b, n_bits).final


def int_sop_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a.to(torch.int32) * b.to(torch.int32), dim=-1,
                     dtype=torch.int32)
