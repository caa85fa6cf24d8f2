"""Kernel B1: the level-stacked MSDF digit-plane GEMM, and its plain version.

Replaces ``repro/kernels/l2r_gemm/kernel.py:_l2r_stacked_kernel`` (entry
``l2r_gemm_pallas_stacked_planes``).  The CUDA source is
``csrc/l2r_stacked_gemm.cu``; its header says how the TPU's sequential
(level, k-block) grid became a level loop inside each thread block.

:func:`l2r_gemm_stacked_planes` dispatches on the operands' device: a
CUDA tensor launches the kernel (or raises), a CPU tensor takes
:func:`l2r_gemm_stacked_planes_plain`.  ``LAUNCHES`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.l2r_gemm import stacked_gemm_planes
from repro_torch.core.online import msdf_level_slices
from repro_torch.core.quant import PlaneOperands

__all__ = ["LAUNCHES", "stacked_schedule", "level_table",
           "l2r_gemm_stacked_planes", "l2r_gemm_stacked_planes_plain"]

#: kernel launches since the count was last reset (plain calls not counted)
LAUNCHES = 0

_FN = None


def stacked_schedule(d: int, k_blocks: int, levels: int | None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """The TPU kernel's static (level, k-block) walk, MSDF order:
    ``a_blocks[t]`` is the block column into A_stack (plane i, chunk c ->
    i * k_blocks + c), ``b_blocks[t]`` the block row into B_rev (plane
    j = s - i at reversed offset (d-1-j) * k_blocks).  The CUDA kernel
    walks the same order with each level's chunks fused (see
    :func:`level_table`)."""
    a_blocks: list[int] = []
    b_blocks: list[int] = []
    for (s, i_lo, i_hi) in msdf_level_slices(d, levels):
        for i in range(i_lo, i_hi + 1):
            for c in range(k_blocks):
                a_blocks.append(i * k_blocks + c)
                b_blocks.append((d - 1 - s + i) * k_blocks + c)
    return (np.asarray(a_blocks, np.int32), np.asarray(b_blocks, np.int32))


def level_table(d: int, k: int, levels: int | None
                ) -> tuple[list[int], list[int], list[int]]:
    """Per MSDF level: first A_stack column, first B_rev row and depth of
    its contiguous slab (the k_blocks=1 walk of :func:`stacked_schedule`
    with each level's plane blocks merged)."""
    a_col, b_row, depth = [], [], []
    for (s, i_lo, i_hi) in msdf_level_slices(d, levels):
        a_col.append(i_lo * k)
        b_row.append((d - 1 - s + i_lo) * k)
        depth.append((i_hi - i_lo + 1) * k)
    return a_col, b_row, depth


def _unshift(stack: torch.Tensor, side: str, n_bits: int, log2_radix: int,
             k: int) -> torch.Tensor:
    axis = -1 if side == "lhs" else -2
    po = PlaneOperands(stack, side, n_bits, log2_radix, k, axis, True)
    return po.core_stack(shifted=False)


def l2r_gemm_stacked_planes_plain(
    a_stack: torch.Tensor,
    b_rev: torch.Tensor,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of kernel B1 on the same pre-shifted stacks.

    Walks the same level slices.  It converts the stacks to raw digits
    (exact) and runs :func:`stacked_gemm_planes` ``(shifted=False)``:
    true-f32 level dots where :func:`_f32_dot_exact` holds (every
    VGG-16 shape; the only form that runs on a CUDA tensor) and int64
    dots narrowed to int32 otherwise (CPU only).  With ``out`` the
    result is added to it in place (int32, wrapping) and returned.
    """
    d = n_bits // log2_radix
    k = a_stack.shape[-1] // d
    res = stacked_gemm_planes(
        _unshift(a_stack, "lhs", n_bits, log2_radix, k),
        _unshift(b_rev, "rhs", n_bits, log2_radix, k),
        k, n_bits, log2_radix, levels, shifted=False)
    if out is None:
        return res
    out += res
    return out


def _check(a_stack, b_rev, n_bits, log2_radix, out):
    d = n_bits // log2_radix
    if a_stack.ndim != 2 or b_rev.ndim != 2:
        raise ValueError(f"plane stacks must be 2-D, got {tuple(a_stack.shape)}"
                         f" and {tuple(b_rev.shape)}")
    m, dk = a_stack.shape
    if dk % d or b_rev.shape[0] != dk:
        raise ValueError(
            f"stacks ({m}, {dk}) x {tuple(b_rev.shape)} do not hold D={d} "
            f"plane chunks of one contraction length")
    if out is not None and (out.shape != (m, b_rev.shape[1])
                            or out.dtype != torch.int32
                            or out.device != a_stack.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 ({m}, "
                         f"{b_rev.shape[1]}) tensor on {a_stack.device}")
    return m, dk // d, b_rev.shape[1]


def _kernel_fn():
    global _FN
    if _FN is None:
        from repro_torch.kernels._build import load

        fn = load("l2r_stacked_gemm").l2r_stacked_gemm
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def l2r_gemm_stacked_planes(
    a_stack: torch.Tensor,
    b_rev: torch.Tensor,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Level-stacked MSDF GEMM over pre-shifted plane stacks: kernel B1.

    ``a_stack`` (M, D*K) ascending and ``b_rev`` (D*K, N) descending
    (core/quant.py:stack_planes_lhs/rhs, ``shifted=True``) -> int32
    (M, N), bit-identical to ``l2r_matmul_int(levels)``.  With ``out``
    the product is added into it (the conv's tap sum) and returned.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel: int8 contiguous stacks only (n_bits <= 8; wider configs have
    int16 planes and no int16 tensor-core path, so they raise).
    """
    global LAUNCHES
    m, k, n = _check(a_stack, b_rev, n_bits, log2_radix, out)
    if not a_stack.is_cuda:
        return l2r_gemm_stacked_planes_plain(a_stack, b_rev, n_bits,
                                             log2_radix, levels, out)
    if n_bits > 8:
        raise ValueError(
            f"kernel B1 takes int8 plane stacks only; the config n_bits="
            f"{n_bits}, log2_radix={log2_radix} has int16 planes and has no "
            f"CUDA route")
    for name, x in (("a_stack", a_stack), ("b_rev", b_rev)):
        if x.dtype != torch.int8 or not x.is_contiguous() \
                or x.device != a_stack.device:
            raise ValueError(f"{name} must be a contiguous int8 tensor on "
                             f"{a_stack.device}, got {x.dtype} on {x.device}"
                             f"{'' if x.is_contiguous() else ', strided'}")
    # the kernel adds into its output (atomically where it splits the walk)
    c = torch.zeros((m, n), dtype=torch.int32, device=a_stack.device) \
        if out is None else out
    a_col, b_row, depth = level_table(n_bits // log2_radix, k, levels)
    if not depth or 0 in (m, n, k):  # levels=0: empty MSDF prefix
        return c
    arr = ctypes.c_int * len(depth)
    err = _kernel_fn()(
        a_stack.data_ptr(), b_rev.data_ptr(), c.data_ptr(), m, n,
        a_stack.shape[1], n, len(depth), arr(*a_col), arr(*b_row),
        arr(*depth), torch.cuda.current_stream(a_stack.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"l2r_stacked_gemm launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name(a_stack.device)}, "
                           f"M={m} K={k} N={n})")
    LAUNCHES += 1
    return c
