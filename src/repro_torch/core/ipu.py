"""Cycle-accurate functional model of the L2R Composite Inner Product Unit.

The port of ``repro/core/ipu.py``: the register-level datapath of Fig. 1
of the paper, bit-true:

  * k parallel AND-plane partial products, summed by a **counter circuit**
    into one partial-product term PP_{i,j} = sum_k A_{k,i} * B_{k,j};
  * a **PPR register pair** in carry-save form, left-shifted each cycle;
  * a **residual register pair** in carry-save form, folded in only every
    n-th cycle, when the PPR is reset through its zero-mux;
  * a **6:2 compressor** built from a chain of 3:2 carry-save adders, so
    no carry propagates anywhere in the per-cycle loop.

Cycle c processes bit pair (i, j) with i = c // n + 1 (activation bit,
MSB first) and j = c % n + 1 (weight bit, MSB first): n^2 cycles per SOP.
After them ``res_s + res_c == sum_k A_k * B_k`` for unsigned n-bit
operands.

:func:`simulate_cipu` is plain torch on any device: a Python loop over
the n^2 cycles on int32 tensors.  Left shifts wrap as the reference's
int32 ``<<`` does (``torch.bitwise_left_shift`` on int32 drops the bits
shifted out).  The batched route through the PE-array kernel is
``repro_torch.kernels.msdf_ipu.simulate_pe_array``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["CIPUTrace", "simulate_cipu", "simulate_cipu_python",
           "stable_msb_count", "datapath_cycles", "sop_width"]

# XLA lowers log2(x) as log(x) * f32(1/ln 2); the port computes the same
# product so that the stable-bit counts equal the reference's (a plain
# torch.log2 differs at 9 values below 2^24, the first 8192)
_INV_LN2 = float(np.float32(1.0 / math.log(2.0)))


def _csa(a, b, c):
    """3:2 carry-save adder (bitwise; value-preserving: a+b+c == s+cy)."""
    s = a ^ b ^ c
    cy = torch.bitwise_left_shift((a & b) | (a & c) | (b & c), 1)
    return s, cy


def _compress_6_2(x0, x1, x2, x3, x4, x5):
    """6:2 compressor as a CSA tree; value-preserving, no carry propagate."""
    s0, c0 = _csa(x0, x1, x2)
    s1, c1 = _csa(x3, x4, x5)
    s2, c2 = _csa(s0, c0, s1)
    s3, c3 = _csa(s2, c1, c2)
    return s3, c3


class CIPUTrace(NamedTuple):
    """Per-SOP simulation result.

    final:       exact inner product (== sum_k A_k * B_k), int32 (...,).
    stable_bits: (..., n_cycles) int32 number of finalized
                 (online-emittable) MSBs after each cycle.
    """

    final: torch.Tensor
    stable_bits: torch.Tensor


def sop_width(n_bits: int, k: int) -> int:
    """Bits of the SOP of k products of n-bit operands; raises where the
    int32 simulation cannot hold it (the reference's guard)."""
    out_bits = 2 * n_bits + int(np.ceil(np.log2(max(k, 2))))
    if out_bits > 31:
        raise ValueError(
            f"SOP width {out_bits} exceeds int32 simulation range "
            f"(n_bits={n_bits}, k={k}); the hardware unit is n<=16, k<=72."
        )
    return out_bits


def _tail_after(n: int, k: int) -> np.ndarray:
    """Max contribution of all cycles strictly after cycle c (weight of
    (i, j) in the SOP is 2^(2n-i-j), count <= k), int32 as the reference
    casts it."""
    cycles = np.arange(n * n)
    i_idx = cycles // n + 1
    j_idx = cycles % n + 1
    w = (2.0 ** (2 * n - i_idx - j_idx)) * k
    tail = (np.cumsum(w[::-1])[::-1] - w).astype(np.int64)
    return tail.astype(np.int32)


def datapath_cycles(a: torch.Tensor, b: torch.Tensor, n_bits: int):
    """The unit's registers clocked cycle by cycle over int32 operands
    a, b (..., k): yields ``(i, j, wrap, ppr_s, ppr_c, res_s, res_c)``
    after each of the n^2 cycles.  After the last, res_s + res_c is the
    SOP."""
    n = n_bits
    zeros = torch.zeros(a.shape[:-1], dtype=torch.int32, device=a.device)
    ppr_s = ppr_c = res_s = res_c = zeros
    for c in range(n * n):
        i, j = c // n + 1, c % n + 1
        # counter circuit: sum of k single-bit partial products
        a_bits = (a >> (n - i)) & 1
        b_bits = (b >> (n - j)) & 1
        cnt = torch.sum(a_bits & b_bits, dim=-1, dtype=torch.int32)
        wrap = j == n  # last weight bit of this activation row
        # muxes: the residual enters the compressor only on wrap cycles,
        # when the PPR zero-mux resets the row accumulator
        res_in_s = torch.bitwise_left_shift(res_s, 1) if wrap else zeros
        res_in_c = torch.bitwise_left_shift(res_c, 1) if wrap else zeros
        s, cy = _compress_6_2(torch.bitwise_left_shift(ppr_s, 1),
                              torch.bitwise_left_shift(ppr_c, 1), cnt,
                              res_in_s, res_in_c, zeros)
        if wrap:
            ppr_s, ppr_c, res_s, res_c = zeros, zeros, s, cy
        else:
            ppr_s, ppr_c = s, cy
        yield i, j, wrap, ppr_s, ppr_c, res_s, res_c


def simulate_cipu(a: torch.Tensor, b: torch.Tensor,
                  n_bits: int = 8) -> CIPUTrace:
    """Simulate the CIPU for a batch of SOP windows.

    Args:
      a: (..., k) unsigned activations, values in [0, 2**n_bits).
      b: (..., k) unsigned weights, same range.
      n_bits: operand precision n.

    Returns CIPUTrace with final == sum over k of a*b (exact) and the
    per-cycle count of stable output MSBs.
    """
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    n = n_bits
    out_bits = sop_width(n, a.shape[-1])
    tail_after = _tail_after(n, a.shape[-1]).tolist()
    stable = []
    for c, (i, j, wrap, ppr_s, ppr_c, res_s, res_c) in enumerate(
            datapath_cycles(a, b, n)):
        # online-output bookkeeping (not part of the datapath): the value
        # if every future counter output were zero
        ppr_v = ppr_s + ppr_c
        res_v = res_s + res_c
        done_row_shift = n - i if wrap else n - i + 1
        v_hat = torch.bitwise_left_shift(res_v, done_row_shift)
        if not wrap:
            v_hat = v_hat + torch.bitwise_left_shift(ppr_v,
                                                     (n - j) + (n - i))
        stable.append(stable_msb_count(v_hat, v_hat + tail_after[c],
                                       out_bits))
    return CIPUTrace(final=res_s + res_c,
                     stable_bits=torch.stack(stable, dim=-1))


def stable_msb_count(lo: torch.Tensor, hi: torch.Tensor,
                     width: int) -> torch.Tensor:
    """Number of leading bits shared by all values in [lo, hi].

    The reference's formula: ``floor(log2(f32(lo ^ hi)))`` as its top
    set bit, with log2 computed as XLA computes it.  Like the reference
    it can miss the true top bit by one (ROADMAP Queue C)."""
    diff = lo ^ hi
    log2 = torch.log(torch.clamp(diff, min=1).to(torch.float32)) * _INV_LN2
    top = torch.where(diff > 0, torch.floor(log2), -1.0)
    return (width - 1 - top).to(torch.int32).clamp(0, width)


def simulate_cipu_python(a, b, n_bits: int = 8) -> int:
    """Plain-Python golden model (single SOP) for unit tests."""
    n = n_bits
    k = len(a)
    ppr_s = ppr_c = res_s = res_c = 0
    for c in range(n * n):
        i, j = c // n + 1, c % n + 1
        cnt = sum(((a[kk] >> (n - i)) & 1) & ((b[kk] >> (n - j)) & 1)
                  for kk in range(k))
        wrap = j == n
        x3 = (res_s << 1) if wrap else 0
        x4 = (res_c << 1) if wrap else 0
        inputs = [ppr_s << 1, ppr_c << 1, cnt, x3, x4, 0]

        def csa(x, y, z):
            return x ^ y ^ z, ((x & y) | (x & z) | (y & z)) << 1

        s0, c0 = csa(inputs[0], inputs[1], inputs[2])
        s1, c1 = csa(inputs[3], inputs[4], inputs[5])
        s2, c2 = csa(s0, c0, s1)
        s3, c3 = csa(s2, c1, c2)
        if wrap:
            res_s, res_c, ppr_s, ppr_c = s3, c3, 0, 0
        else:
            ppr_s, ppr_c = s3, c3
    return res_s + res_c
