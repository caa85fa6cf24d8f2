"""The PE-array CIPU simulator's entry point.  The port of
``repro/kernels/msdf_ipu/ops.py``: dispatch follows the operands' device
(kernel B6 on the card, its plain version on the CPU); there is no
``use_pallas``/``interpret`` switch."""

from __future__ import annotations

import torch

from .kernel import cipu_array
from .ref import cipu_array_ref, int_sop_ref

__all__ = ["simulate_pe_array", "cipu_array_ref", "int_sop_ref"]


def simulate_pe_array(a: torch.Tensor, b: torch.Tensor,
                      n_bits: int = 8) -> torch.Tensor:
    """Simulate M independent CIPU PEs.  a, b: (M, k) unsigned."""
    return cipu_array(a, b, n_bits)
