"""Kernel B6: the register-level PE-array simulation of the composite
IPU, and its plain version.

B6 (``csrc/cipu_array.cu``) replaces
``repro/kernels/msdf_ipu/kernel.py:_kernel`` (entry
``cipu_array_pallas``): M PEs, each running the n^2-cycle carry-save
datapath of ``core/ipu.py`` on one SOP of k products -> (M,) int32, the
exact SOPs.  One CUDA thread per PE; the ragged end of M is masked, not
padded.  A persistent grid stages rows 32 operands deep through a
``cp.async`` ring; each thread turns its own operands into bit planes
(byte packing and 8x8 bit transposes, no warp votes) and counts the
n^2 AND planes with popc before clocking the cycles.

The wrapper dispatches on the operands' device: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes the plain version.
``LAUNCHES["cipu_array"]`` counts the kernel's launches and nothing else.
Inside a graph capture, and on a ``meta`` tensor on the card's path
(kernels/_build.py:as_op), the wrapper calls the custom op
``repro_torch::cipu_array``: one node, the launch on the card and the
plain version on the CPU.  :func:`cipu_cost` is the work PERF.md's bound
counts: the op's FLOP formula and chip_smoke.py's bound read it.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.ipu import datapath_cycles, sop_width
from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "cipu_array", "cipu_array_plain", "cipu_cost"]

#: kernel launches since the count was last reset (plain calls are not
#: counted)
LAUNCHES = {"cipu_array": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, _I, _I]


def _check(a: torch.Tensor, b: torch.Tensor, n_bits: int) -> None:
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"operands must both be (M, k), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    sop_width(n_bits, a.shape[1])  # the reference's int32 range guard


def cipu_cost(m: int, k: int, n_bits: int) -> tuple[dict, int]:
    """Kernel B6's work on m SOPs of k products: each of the n^2 cycles
    needs its counter (ceil(k/32) AND, popc and add) and the 6:2 compressor
    (four 3:2 CSAs of 2 XOR, 3 AND, 2 OR, 1 shift) plus the two PPR
    shifts, so ``{"int32": m n^2 (2 ceil(k/32) + 34), "popc": m n^2
    ceil(k/32)}`` operations (two pipes: their times overlap); the int32
    operands read once and the outputs written once."""
    words = -(-k // 32)
    cycles = m * n_bits ** 2
    return ({"int32": cycles * (2 * words + 34), "popc": cycles * words},
            2 * m * k * 4 + 4 * m)


def cipu_array_plain(a: torch.Tensor, b: torch.Tensor,
                     n_bits: int = 8) -> torch.Tensor:
    """Plain version of kernel B6: the TPU kernel's body in torch, the
    n^2 cycles of the carry-save datapath over all M PEs at once (no
    stable-bit bookkeeping).  a, b: (M, k) unsigned -> (M,) int32."""
    _check(a, b, n_bits)
    for *_, res_s, res_c in datapath_cycles(a.to(torch.int32),
                                            b.to(torch.int32), n_bits):
        pass
    return res_s + res_c


def cipu_array(a: torch.Tensor, b: torch.Tensor,
               n_bits: int = 8) -> torch.Tensor:
    """a, b: (M, k) unsigned operands -> (M,) exact SOPs, simulated at
    the register level: kernel B6.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel on the operands as int32, the reference's interface (other
    integer dtypes are cast, as the reference casts them).  Raises where
    the SOP width exceeds the int32 range, as the reference's golden
    model does.
    """
    _check(a, b, n_bits)
    if _build.as_op(a):
        return torch.ops.repro_torch.cipu_array(
            a.to(torch.int32).contiguous(), b.to(torch.int32).contiguous(),
            n_bits)
    if not a.is_cuda:
        return cipu_array_plain(a, b, n_bits)
    return _b6_launch(a, b, n_bits)


def _b6_launch(a, b, n_bits) -> torch.Tensor:
    """B6 on the card: the eager path and the op's CUDA implementation."""
    if b.device != a.device:
        raise ValueError(f"kernel B6 takes operands on one card, got "
                         f"{a.device} and {b.device}")
    a = a.to(torch.int32).contiguous()
    b = b.to(torch.int32).contiguous()
    m, k = a.shape
    out = torch.empty(m, dtype=torch.int32, device=a.device)
    if m == 0:
        return out
    _build.launch("cipu_array", _ARGTYPES, a.device,
                  f"M={m} k={k} n_bits={n_bits}", a.data_ptr(), b.data_ptr(),
                  out.data_ptr(), m, k, n_bits, reads=(a, b), writes=(out,))
    LAUNCHES["cipu_array"] += 1
    return out


@torch.library.custom_op("repro_torch::cipu_array", mutates_args=())
def _b6_op(a: torch.Tensor, b: torch.Tensor, n_bits: int) -> torch.Tensor:
    return cipu_array_plain(a, b, n_bits)


_b6_op.register_kernel("cuda")(_b6_launch)
_b6_op.register_fake(lambda a, b, n_bits: a.new_empty(a.shape[:1]))


@register_flop_formula(torch.ops.repro_torch.cipu_array)
def _b6_flops(a_shape, b_shape, n_bits, **_):
    ops, _ = cipu_cost(a_shape[0], a_shape[1], n_bits)
    return sum(ops.values())
