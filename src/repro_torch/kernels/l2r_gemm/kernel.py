"""Kernels B1, B2 and B3: the MSDF digit-plane GEMMs, and their plain
versions.

* B1 (``csrc/l2r_stacked_gemm.cu``) replaces
  ``repro/kernels/l2r_gemm/kernel.py:_l2r_stacked_kernel`` (entry
  ``l2r_gemm_pallas_stacked_planes``): the level-stacked GEMM over
  pre-shifted plane stacks -> (M, N), run as the few plane-range
  products of ``core/online.py:msdf_products`` (one at full depth) over
  a cp.async pipeline; B read K-major.
* B2 (``csrc/l2r_streaming_gemm.cu``) replaces ``_l2r_streaming_kernel``
  (entry ``l2r_gemm_pallas_streaming_planes``): the same walk, every plane
  pair of a staged chunk into its level's accumulator, writing the level
  prefixes -> (L, M, N) snapshot stream, with a dynamic level count read
  from device memory; B read K-major; small M splits the contraction over
  a thread-block cluster.
* B3 (``csrc/l2r_pairs_gemm.cu``) replaces ``_l2r_gemm_kernel`` (entry
  ``l2r_gemm_pallas``): the pair loop over raw int8 operands, run as the
  plane-range products of ``msdf_products`` (byte masks), B read row-major
  as the weight cache holds it.

The three kernels have their own pipelines and share device helpers
(``csrc/l2r_mma.cuh``).  On int16 planes (n_bits 9-16) each wrapper
launches its kernel's int16 entry, counted in the same ``LAUNCHES[name]``:
B1's and B3's (``l2r_stacked_gemm16``, ``l2r_pairs_gemm16``) run the same
walk on the int8 tensor cores through the byte split (``csrc/l2r_gemm16.cuh``
on ``csrc/l2r_byte_split.cuh``; its plain form is
:func:`byte_split_matmul`), B2's (``l2r_streaming_gemm16``) on the CUDA
cores (``csrc/l2r_int16.cuh``).

Each wrapper dispatches on the operands' device: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes the plain version.
``LAUNCHES[name]`` counts one kernel's launches and nothing else.  Inside
a graph capture, and on a ``meta`` tensor on the card's path
(kernels/_build.py:as_op), a wrapper calls its kernel as the custom op
``repro_torch::<name>`` instead: one node of the captured graph, whose
CUDA implementation is the same launch, whose CPU implementation is the
plain version and whose fake returns the output's shape.  Each kernel's
work, as PERF.md's bound column counts it, has one home here
(:func:`stacked_cost`, :func:`slab_cost`, :func:`streaming_cost`,
:func:`pairs_cost`): the ops' FLOP formulas and chip_smoke.py's bounds
read it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.l2r_gemm import (l2r_matmul_int, stacked_gemm_planes,
                                      wrap_int32)
from repro_torch.core.online import (msdf_level_slices, msdf_products,
                                    plane_bits)
from repro_torch.core.progressive import scan_plain
from repro_torch.core.quant import PlaneOperands, _int_dtype
from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "stacked_schedule", "streaming_schedule",
           "streaming_plan",
           "pairs_plan", "l2r_gemm_stacked_planes",
           "l2r_gemm_stacked_planes_plain", "l2r_gemm_streaming_planes",
           "l2r_gemm_streaming_planes_plain", "l2r_gemm_pairs",
           "l2r_gemm_pairs_plain", "stacked_cost", "slab_cost",
           "streaming_cost", "pairs_cost", "byte_split_matmul", "FOLD"]

#: kernel launches per library since the counts were last reset (plain
#: calls are not counted)
LAUNCHES = {"l2r_stacked_gemm": 0, "l2r_streaming_gemm": 0,
            "l2r_pairs_gemm": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {  # the C entries' arguments before the stream
    "l2r_stacked_gemm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                         _P],
    "l2r_streaming_gemm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I,
                           _I, _I],
    "l2r_pairs_gemm": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "l2r_stacked_gemm16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                           _P, _P],
    "l2r_streaming_gemm16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                             _I],
    "l2r_pairs_gemm16": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
}


def stacked_schedule(d: int, k_blocks: int, levels: int | None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """The TPU kernel's static (level, k-block) walk, MSDF order:
    ``a_blocks[t]`` is the block column into A_stack (plane i, chunk c ->
    i * k_blocks + c), ``b_blocks[t]`` the block row into B_rev (plane
    j = s - i at reversed offset (d-1-j) * k_blocks).  The CUDA kernels
    sum the same pairs in other groupings (int32 wraps alike in any
    order)."""
    a_blocks: list[int] = []
    b_blocks: list[int] = []
    for (s, i_lo, i_hi) in msdf_level_slices(d, levels):
        for i in range(i_lo, i_hi + 1):
            for c in range(k_blocks):
                a_blocks.append(i * k_blocks + c)
                b_blocks.append((d - 1 - s + i) * k_blocks + c)
    return (np.asarray(a_blocks, np.int32), np.asarray(b_blocks, np.int32))


def streaming_schedule(d: int, k_blocks: int, levels: int | None
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The stacked walk plus each step's level index: the snapshot plane
    that step's write goes to (kernel B2 writes the same planes)."""
    a_blocks, b_blocks = stacked_schedule(d, k_blocks, levels)
    steps = [(i_hi - i_lo + 1) * k_blocks
             for (_, i_lo, i_hi) in msdf_level_slices(d, levels)]
    lv_idx = np.repeat(np.arange(len(steps), dtype=np.int32), steps)
    return a_blocks, b_blocks, np.asarray(lv_idx, np.int32)


def _unshift(stack: torch.Tensor, side: str, n_bits: int, log2_radix: int,
             k: int) -> torch.Tensor:
    axis = -1 if side == "lhs" else -2
    po = PlaneOperands(stack, side, n_bits, log2_radix, k, axis, True)
    return po.core_stack(shifted=False)


def _launch(name: str, dev: torch.device, shape: str, reads: tuple,
            writes: tuple, *args, wide: bool = False) -> None:
    """Launch library ``name``'s int8 entry, or with ``wide`` its int16
    entry ``<name>16``; either counts as one launch of the kernel."""
    entry = f"{name}16" if wide else name
    _build.launch(name, _ARGTYPES[entry], dev, shape, *args, reads=reads,
                  writes=writes, entry=entry)
    LAUNCHES[name] += 1


def _require_planes(n_bits: int, **tensors):
    dev = next(iter(tensors.values())).device
    dt = _int_dtype(n_bits)
    for name, x in tensors.items():
        if x.dtype != dt or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name} must be a contiguous "
                             f"{str(dt).split('.')[-1]} tensor on "
                             f"{dev} (n_bits={n_bits}), got {x.dtype} on "
                             f"{x.device}"
                             f"{'' if x.is_contiguous() else ', strided'}")


def _check(a_stack, b_rev, n_bits, log2_radix):
    d = n_bits // log2_radix
    if a_stack.ndim != 2 or b_rev.ndim != 2:
        raise ValueError(f"plane stacks must be 2-D, got {tuple(a_stack.shape)}"
                         f" and {tuple(b_rev.shape)}")
    m, dk = a_stack.shape
    if dk % d or b_rev.shape[0] != dk:
        raise ValueError(
            f"stacks ({m}, {dk}) x {tuple(b_rev.shape)} do not hold D={d} "
            f"plane chunks of one contraction length")
    return m, dk // d, b_rev.shape[1]


@functools.lru_cache(maxsize=None)
def _b1_plan(d: int, levels: int | None, first_level: int):
    """The walk's products for the C entry: (count, il, ih, jl, jh) as
    ctypes arrays, built once per table."""
    prods = msdf_products(d, levels, first_level)
    arr = ctypes.c_int * max(len(prods), 1)
    return (len(prods), *(arr(*col) for col in zip(*prods))) if prods \
        else (0,)


@functools.lru_cache(maxsize=None)
def streaming_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """Kernel B2's launch shape: ``(tile, splits)``.  Tile 0 is 16 x 64
    (M <= 16, the FC head at small batch), tile 1 32 x 64.  Where the
    tiles fill less than half of the ``sms`` SMs, the
    contraction (32-deep chunks) is split over a cluster of up to 8
    blocks, enough to fill the card, at least one chunk each."""
    tile = 0 if m <= 16 else 1
    tiles = -(-m // (16 if tile == 0 else 32)) * -(-n // 64)
    steps = -(-k // 32)
    if 2 * tiles >= sms:
        return tile, 1
    return tile, max(1, min(8, steps, -(-sms // tiles)))


@functools.lru_cache(maxsize=None)
def pairs_plan(d: int, log2_radix: int, levels: int | None, bits: int = 8
               ) -> tuple[tuple[int, int], ...]:
    """Kernel B3's products: ``(mask_a, mask_b)`` masks of the raw
    ``bits``-bit operands (8 or 16), one pair per plane-range product of
    ``msdf_products(d, levels)`` (at most D; one, all ones, at full
    depth)."""
    return tuple((plane_bits(d, log2_radix, il, ih, bits),
                  plane_bits(d, log2_radix, jl, jh, bits))
                 for il, ih, jl, jh in msdf_products(d, levels))


@functools.lru_cache(maxsize=None)
def _b3_c_plan(d: int, log2_radix: int, levels: int | None, bits: int = 8):
    """:func:`pairs_plan` for the C entry: (count, masks a, masks b) as
    ctypes arrays, built once per table."""
    plan = pairs_plan(d, log2_radix, levels, bits)
    arr = ctypes.c_int * max(len(plan), 1)
    return len(plan), arr(*(a for a, _ in plan)), arr(*(b for _, b in plan))


@functools.lru_cache(maxsize=None)
def _n_levels(d: int, levels: int | None) -> int:
    return len(msdf_level_slices(d, levels))


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def _count_tensor(dev: torch.device, value: int) -> torch.Tensor:
    """A one-element int32 level count on the card, made once per value
    (the kernel only reads it)."""
    return torch.full((1,), value, dtype=torch.int32, device=dev)


def _k_major(b_rev: torch.Tensor) -> tuple[torch.Tensor, int]:
    """B1's and B2's B operand: the (N, D*K) rows of ``b_rev`` (D*K, N),
    read K-major, and their stride.  A K-major stack (unit stride along
    D*K: the weight caches, ``k_major=True``) is used in place; a
    row-major one is transposed here, one copy of the stack."""
    (dk, n), (s0, s1) = b_rev.shape, b_rev.stride()
    if s0 == 1 and (n <= 1 or s1 >= dk):
        return b_rev.t(), s1 if n > 1 else dk
    bt = b_rev.t().contiguous()
    return bt, dk


def _check_b_rev(b_rev: torch.Tensor, dev: torch.device, n_bits: int) -> None:
    # B1's and B2's B stack: any strides (see _k_major)
    if b_rev.dtype != _int_dtype(n_bits) or b_rev.device != dev:
        raise ValueError(f"b_rev must be a {_int_dtype(n_bits)} tensor on "
                         f"{dev} (n_bits={n_bits}), got {b_rev.dtype} on "
                         f"{b_rev.device}")


def _check_out(out, shape, dev):
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.int32
                            or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 {shape} tensor on "
                         f"{dev}")


# ------------------------------------------------------------- the work
def _width(n_bits: int) -> tuple[int, int]:
    """(int8 products an operand product counts as, bytes an element): an
    int16 product is four int8 products on the tensor cores (the byte
    split), the least the card could spend on it."""
    return (1, 1) if n_bits <= 8 else (4, 2)


def stacked_cost(m: int, k: int, n: int, d: int, levels: int | None = None,
                 first_level: int = 0, accumulate: bool = False,
                 n_bits: int = 8) -> tuple[dict, int]:
    """Kernel B1's work: ``({"int8": operations}, bytes)``.  A prefix
    (``first_level=0``) is at most D plane-range products of 2 M N K int8
    operations (one at full depth: the function is aq @ bq mod 2^32),
    reading the two stacks once and writing (with ``accumulate``, reading
    and writing) the int32 result; a table that starts above level 0 is
    its plane pairs, reading the slices they touch (:func:`slab_cost`).
    int16 planes (``n_bits`` > 8): four int8 operations a product, two
    bytes an element."""
    x, e = _width(n_bits)
    prods = len(msdf_products(d, levels, first_level))
    ops = {"int8": 2 * m * n * k * prods * x}
    if first_level:
        return ops, prods * (m * k + k * n) * e + m * n * 4
    return ops, (m * d * k + d * k * n) * e + m * n * 4 * (2 if accumulate
                                                          else 1)


def slab_cost(m: int, k: int, n: int, t: int, d: int, n_bits: int = 8
              ) -> tuple[dict, int]:
    """Level ``t``'s slab of B1's walk (``levels=t+1, first_level=t``): its
    plane pairs (i + j = t) at 2 M N K int8 operations each, the planes
    they read and the (M, N) int32 it writes (int16: as
    :func:`stacked_cost`)."""
    x, e = _width(n_bits)
    pairs = min(t, 2 * d - 2 - t) + 1
    return ({"int8": 2 * m * n * k * pairs * x},
            pairs * (m * k + k * n) * e + m * n * 4)


def streaming_cost(m: int, k: int, n: int, d: int, n_levels: int,
                   accumulate: bool = False, n_bits: int = 8
                   ) -> tuple[dict, int]:
    """Kernel B2's work: each snapshot plane is a different sum of the D²
    pair products, 2 M N K int8 operations each; the stacks read once, the
    (L, M, N) int32 stream written (read and written with
    ``accumulate``).  int16: as :func:`stacked_cost`."""
    x, e = _width(n_bits)
    return ({"int8": 2 * m * n * k * d * d * x},
            (m * d * k + d * k * n) * e
            + n_levels * m * n * 4 * (2 if accumulate else 1))


def pairs_cost(m: int, k: int, n: int, d: int = 4,
               levels: int | None = None, n_bits: int = 8
               ) -> tuple[dict, int]:
    """Kernel B3's work: its plane-range products (one at full depth) at
    2 M N K int8 operations each, the raw operands read once and the
    int32 result written.  int16: as :func:`stacked_cost`."""
    x, e = _width(n_bits)
    return ({"int8": 2 * m * n * k * len(msdf_products(d, levels)) * x},
            (m * k + k * n) * e + m * n * 4)


# ---------------------------------------------------------- the byte split
#: contraction elements between the int16 routes' folds of their byte
#: accumulators (csrc/l2r_gemm16.cuh: 1,024 passes of 32)
FOLD = 32768


def byte_split_matmul(aq: torch.Tensor, bq: torch.Tensor, masks,
                      fold: int | None = FOLD) -> torch.Tensor:
    """The int16 product as the int16 routes compute it on the int8 tensor
    cores: ``aq`` (..., M, K) and ``bq`` (..., K, N) int16 codes -> (..., M,
    N) int32, the sum over ``masks`` ((mask_a, mask_b) 16-bit pairs, one
    per product of the walk) of (aq & mask_a) @ (bq & mask_b) mod 2^32.

    Each masked operand is read back as int16 (the top plane's sign
    extension included, as the raw bits hold it) and split as x = 256 xh +
    xl (xh = x >> 8 in [-128, 127], xl = x & 0xff in [0, 255]); the
    byte-pair sums xh.yh, xh.yl + xl.yh and xl.yl over each slice of
    ``fold`` contraction elements are the kernels' three accumulators
    between folds, exact int32, and are combined as (hh << 16) + (cross <<
    8) + ll mod 2^32: the reference's wrapping int32 dot.  (The kernels
    fold after 32,768 elements summed over the products; any grouping gives
    the same bits mod 2^32.)  A slice whose byte sum leaves int32 raises: at
    most 32,896 elements keep the cross sum inside.  ``fold=None`` sums the
    whole contraction in one slice.  The dots run in f64 (exact on any
    device)."""
    def split(x, mask):
        x = x.to(torch.int32) & mask
        x = x - ((x & 0x8000) << 1)  # the masked bits read as int16
        return (x >> 8).to(torch.float64), (x & 0xFF).to(torch.float64)

    k = aq.shape[-1]
    step = fold or max(k, 1)
    acc = torch.zeros(torch.broadcast_shapes(aq.shape[:-2], bq.shape[:-2])
                      + (aq.shape[-2], bq.shape[-1]), dtype=torch.int64,
                      device=aq.device)
    for ma, mb in masks:
        (ah, al), (bh, bl) = split(aq, ma), split(bq, mb)
        for k0 in range(0, k, step):
            a_h, a_l = ah[..., k0:k0 + step], al[..., k0:k0 + step]
            b_h, b_l = bh[..., k0:k0 + step, :], bl[..., k0:k0 + step, :]
            sums = [torch.matmul(x, y).to(torch.int64) for x, y in
                    ((a_h, b_h), (a_h, b_l), (a_l, b_h), (a_l, b_l))]
            hh, cross, ll = sums[0], sums[1] + sums[2], sums[3]
            for part in (hh, cross, ll):
                if part.numel() and (part.min() < -(1 << 31)
                                     or part.max() >= 1 << 31):
                    raise OverflowError(
                        f"a byte accumulator leaves int32 over {step} "
                        f"elements of contraction: fold at most every "
                        f"32,896")
            acc += (hh << 16) + (cross << 8) + ll
    return wrap_int32(acc)


# ------------------------------------------------------------- B1: stacked
def l2r_gemm_stacked_planes_plain(
    a_stack: torch.Tensor,
    b_rev: torch.Tensor,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
    out: torch.Tensor | None = None,
    first_level: int = 0,
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
        k, n_bits, log2_radix, levels, shifted=False,
        first_level=first_level)
    if out is None:
        return res
    out += res
    return out


def l2r_gemm_stacked_planes(
    a_stack: torch.Tensor,
    b_rev: torch.Tensor,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
    out: torch.Tensor | None = None,
    first_level: int = 0,
) -> torch.Tensor:
    """Level-stacked MSDF GEMM over pre-shifted plane stacks: kernel B1.

    ``a_stack`` (M, D*K) ascending and ``b_rev`` (D*K, N) descending
    (core/quant.py:stack_planes_lhs/rhs, ``shifted=True``) -> int32
    (M, N), bit-identical to ``l2r_matmul_int(levels)``.  With ``out``
    the product is added into it (the conv's tap sum) and returned.
    ``first_level`` walks only levels ``[first_level, levels)``: one
    level of an early-exit walk is a one-row level table.

    The kernel reads B K-major: ``b_rev`` may be the transpose of a
    contiguous (N, D*K) stack (the weight caches of
    ``quantize_weights(..., k_major=True)``) and is then read in place; a
    row-major ``b_rev`` is transposed first (one copy).  The walk goes
    to the kernel as ``msdf_products(D, levels, first_level)``: a prefix
    (``first_level=0``) as at most D plane-range products, one at full
    depth; any other table as its plane pairs.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel on the tensor cores: int8 stacks (n_bits <= 8) as they are,
    int16 stacks (n_bits 9-16) through its int16 entry, the byte split.
    """
    m, k, n = _check(a_stack, b_rev, n_bits, log2_radix)
    _check_out(out, (m, n), a_stack.device)
    if _build.as_op(a_stack):
        c = torch.zeros((m, n), dtype=torch.int32, device=a_stack.device) \
            if out is None else out
        torch.ops.repro_torch.l2r_stacked_gemm(a_stack, b_rev, c, n_bits,
                                               log2_radix, levels,
                                               first_level)
        return c
    if not a_stack.is_cuda:
        return l2r_gemm_stacked_planes_plain(a_stack, b_rev, n_bits,
                                             log2_radix, levels, out,
                                             first_level)
    # the kernel adds into its output (atomically where it splits the walk)
    c = torch.zeros((m, n), dtype=torch.int32, device=a_stack.device) \
        if out is None else out
    _b1_launch(a_stack, b_rev, c, n_bits, log2_radix, levels, first_level)
    return c


def _b1_launch(a_stack, b_rev, c, n_bits, log2_radix, levels,
               first_level) -> None:
    """B1 added into ``c`` on the card (the eager path and the op's CUDA
    implementation)."""
    _require_planes(n_bits, a_stack=a_stack)
    _check_b_rev(b_rev, a_stack.device, n_bits)
    (m, dk), n = a_stack.shape, b_rev.shape[1]
    d = n_bits // log2_radix
    k = dk // d
    plan = _b1_plan(d, levels, first_level)
    if not plan[0] or 0 in (m, n, k):  # levels=0: empty MSDF prefix
        return
    bt, ldb = _k_major(b_rev)
    _launch("l2r_stacked_gemm", a_stack.device, f"M={m} K={k} N={n}",
            (a_stack, bt), (c,), a_stack.data_ptr(), bt.data_ptr(),
            c.data_ptr(), m, n, dk, ldb, d, k, *plan, wide=n_bits > 8)


@torch.library.custom_op("repro_torch::l2r_stacked_gemm",
                         mutates_args=("out",))
def _b1_op(a_stack: torch.Tensor, b_rev: torch.Tensor, out: torch.Tensor,
           n_bits: int, log2_radix: int, levels: Optional[int],
           first_level: int) -> None:
    out += l2r_gemm_stacked_planes_plain(a_stack, b_rev, n_bits, log2_radix,
                                         levels, None, first_level)


_b1_op.register_kernel("cuda")(_b1_launch)
_b1_op.register_fake(lambda *args: None)


@register_flop_formula(torch.ops.repro_torch.l2r_stacked_gemm)
def _b1_flops(a_shape, b_shape, c_shape, n_bits, log2_radix, levels,
              first_level, **_):
    d = n_bits // log2_radix
    ops, _ = stacked_cost(a_shape[0], a_shape[1] // d, b_shape[1], d, levels,
                          first_level, n_bits=n_bits)
    return sum(ops.values())


# ----------------------------------------------------------- B2: streaming
def l2r_gemm_streaming_planes_plain(
    a_stack: torch.Tensor,
    b_rev: torch.Tensor,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
    level_count=None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of kernel B2 on the same pre-shifted stacks: the
    reference's streaming scan over zero-padded raw-digit windows
    (core/progressive.py), every level emitted.

    The window dots run in true f32 where the guard holds (every VGG-16
    shape; the only form that runs on a CUDA tensor) and in int64
    narrowed to int32 otherwise.  It computes every level:
    ``level_count`` only marks planes at or above it as unspecified, as
    in the kernel.  With ``out`` the stream is added to it in place.
    """
    del level_count
    d = n_bits // log2_radix
    k = a_stack.shape[-1] // d
    a = PlaneOperands(a_stack, "lhs", n_bits, log2_radix, k, -1, True)
    b = PlaneOperands(b_rev, "rhs", n_bits, log2_radix, k, -2, True)
    _, _, stream = scan_plain(a, b, None, None, n_bits, log2_radix, levels,
                              emit=True)
    if out is None:
        return stream
    out += stream
    return out


def l2r_gemm_streaming_planes(
    a_stack: torch.Tensor,
    b_rev: torch.Tensor,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
    level_count: int | torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-level snapshot stream over pre-shifted plane stacks: kernel B2.

    Same operands as :func:`l2r_gemm_stacked_planes`; returns (L, M, N)
    int32 whose plane l is bit-identical to B1 truncated at
    ``levels=l+1``.  With ``out`` the stream is added into it (the
    progressive conv's tap sum).

    ``level_count`` is the number of levels to run: an int, or a
    one-element int32 tensor on the card that the kernel reads from
    device memory (so an early-exit consumer can set it without a host
    sync).  Levels at or above it skip their products and writes; their
    planes are unspecified.  ``None`` runs every level.

    The kernel reads B K-major, as B1 does: a K-major ``b_rev`` (the
    weight caches) is read in place, a row-major one transposed once.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel: int8 stacks (D 1-8) on the tensor cores, int16 stacks (n_bits
    9-16, D up to 16) through its int16 entry on the CUDA cores.
    """
    m, k, n = _check(a_stack, b_rev, n_bits, log2_radix)
    d = n_bits // log2_radix
    n_lv = _n_levels(d, levels)
    dev = a_stack.device
    _check_out(out, (n_lv, m, n), dev)
    # the level count on the card, else as an int
    count = level_count if isinstance(level_count, torch.Tensor) else None
    n_count = 0 if count is not None else (
        n_lv if level_count is None else int(level_count))
    if _build.as_op(a_stack):
        c = torch.zeros((n_lv, m, n), dtype=torch.int32, device=dev) \
            if out is None else out
        torch.ops.repro_torch.l2r_streaming_gemm(
            a_stack, b_rev, c, n_bits, log2_radix, levels, count, n_count,
            out is not None)
        return c
    if not a_stack.is_cuda:
        return l2r_gemm_streaming_planes_plain(a_stack, b_rev, n_bits,
                                               log2_radix, levels,
                                               level_count, out)
    # without out= the kernel writes the planes (unspecified at or above
    # the level count, as the docstring says) instead of adding to them
    c = torch.empty((n_lv, m, n), dtype=torch.int32, device=dev) \
        if out is None else out
    _b2_launch(a_stack, b_rev, c, n_bits, log2_radix, levels, count,
               n_count, out is not None)
    return c


def _b2_launch(a_stack, b_rev, c, n_bits, log2_radix, levels, count,
               n_count, accumulate) -> None:
    """B2 written (or, with ``accumulate``, added) into ``c`` on the card:
    the eager path and the op's CUDA implementation.  ``count`` is the
    one-element level count on the card, else ``n_count`` levels run."""
    _require_planes(n_bits, a_stack=a_stack)
    _check_b_rev(b_rev, a_stack.device, n_bits)
    (m, dk), n = a_stack.shape, b_rev.shape[1]
    d = n_bits // log2_radix
    k = dk // d
    n_lv = _n_levels(d, levels)
    dev = a_stack.device
    if n_lv == 0 or 0 in (m, n, k):  # nothing to add; written as zeros
        if not accumulate:
            c.zero_()
        return
    if count is None:
        cnt = _count_tensor(dev, n_count)
    else:
        cnt = count
        if cnt.dtype != torch.int32 or cnt.numel() != 1 or cnt.device != dev:
            raise ValueError(f"level_count must be a one-element int32 "
                             f"tensor on {dev}")
    bt, ldb = _k_major(b_rev)
    if n_bits > 8:  # the int16 entry plans its own split
        _launch("l2r_streaming_gemm", dev, f"M={m} K={k} N={n}",
                (a_stack, bt), (c,), a_stack.data_ptr(), bt.data_ptr(),
                c.data_ptr(), m, n, dk, ldb, d, k, n_lv, cnt.data_ptr(),
                int(accumulate), wide=True)
        return
    tile, splits = streaming_plan(m, n, k, _sm_count(dev))
    _launch("l2r_streaming_gemm", dev, f"M={m} K={k} N={n}",
            (a_stack, bt), (c,), a_stack.data_ptr(), bt.data_ptr(),
            c.data_ptr(), m, n, dk, ldb, d, k, n_lv,
            cnt.data_ptr(), tile, splits, int(accumulate))


@torch.library.custom_op("repro_torch::l2r_streaming_gemm",
                         mutates_args=("out",))
def _b2_op(a_stack: torch.Tensor, b_rev: torch.Tensor, out: torch.Tensor,
           n_bits: int, log2_radix: int, levels: Optional[int],
           count: Optional[torch.Tensor], n_count: int,
           accumulate: bool) -> None:
    stream = l2r_gemm_streaming_planes_plain(a_stack, b_rev, n_bits,
                                             log2_radix, levels)
    if accumulate:
        out += stream
    else:
        out.copy_(stream)


_b2_op.register_kernel("cuda")(_b2_launch)
_b2_op.register_fake(lambda *args: None)


@register_flop_formula(torch.ops.repro_torch.l2r_streaming_gemm)
def _b2_flops(a_shape, b_shape, c_shape, n_bits, log2_radix, levels, count,
              n_count, accumulate, **_):
    d = n_bits // log2_radix
    ops, _ = streaming_cost(a_shape[0], a_shape[1] // d, b_shape[1], d,
                            c_shape[0], accumulate, n_bits)
    return sum(ops.values())


# ---------------------------------------------------------- B3: pair loop
def l2r_gemm_pairs_plain(aq: torch.Tensor, bq: torch.Tensor,
                         n_bits: int = 8, log2_radix: int = 2,
                         levels: int | None = None) -> torch.Tensor:
    """Plain version of kernel B3: the pair loop of ``ref.py:l2r_gemm_ref``
    (``core/l2r_gemm.py:l2r_matmul_int``), whose pair dots run in true
    f32 on a CUDA tensor (guarded) and in int64 on the CPU."""
    return l2r_matmul_int(aq, bq, n_bits, log2_radix, levels)


def l2r_gemm_pairs(aq: torch.Tensor, bq: torch.Tensor, n_bits: int = 8,
                   log2_radix: int = 2, levels: int | None = None
                   ) -> torch.Tensor:
    """D² pair-loop MSDF GEMM over raw operands: kernel B3.

    ``aq`` (M, K) and ``bq`` (K, N) signed ints -> int32 (M, N),
    bit-identical to ``l2r_matmul_int(levels)``.  The kernel runs the
    pair list as :func:`pairs_plan`'s plane-range products, masking the
    raw tiles (both read row-major in place).  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel on the tensor cores:
    int8 operands as they are, int16 (n_bits 9-16) through its int16
    entry, the byte split.
    """
    if aq.ndim != 2 or bq.ndim != 2 or aq.shape[1] != bq.shape[0]:
        raise ValueError(f"operands must be (M, K) x (K, N), got "
                         f"{tuple(aq.shape)} x {tuple(bq.shape)}")
    if _build.as_op(aq):
        return torch.ops.repro_torch.l2r_pairs_gemm(aq, bq, n_bits,
                                                    log2_radix, levels)
    if not aq.is_cuda:
        return l2r_gemm_pairs_plain(aq, bq, n_bits, log2_radix, levels)
    return _b3_launch(aq, bq, n_bits, log2_radix, levels)


def _b3_launch(aq, bq, n_bits, log2_radix, levels) -> torch.Tensor:
    """B3 on the card: the eager path and the op's CUDA implementation."""
    _require_planes(n_bits, aq=aq, bq=bq)
    (m, k), n = aq.shape, bq.shape[1]
    wide = n_bits > 8
    plan = _b3_c_plan(n_bits // log2_radix, log2_radix, levels,
                      16 if wide else 8)
    if not plan[0] or 0 in (m, n, k):  # levels=0: empty MSDF prefix
        return torch.zeros((m, n), dtype=torch.int32, device=aq.device)
    c = torch.empty((m, n), dtype=torch.int32, device=aq.device)
    _launch("l2r_pairs_gemm", aq.device, f"M={m} K={k} N={n}",
            (aq, bq), (c,), aq.data_ptr(), bq.data_ptr(), c.data_ptr(), m,
            n, k, *plan, wide=wide)
    return c


@torch.library.custom_op("repro_torch::l2r_pairs_gemm", mutates_args=())
def _b3_op(aq: torch.Tensor, bq: torch.Tensor, n_bits: int, log2_radix: int,
           levels: Optional[int]) -> torch.Tensor:
    return l2r_gemm_pairs_plain(aq, bq, n_bits, log2_radix, levels)


_b3_op.register_kernel("cuda")(_b3_launch)


@_b3_op.register_fake
def _(aq, bq, n_bits, log2_radix, levels):
    return aq.new_empty((aq.shape[0], bq.shape[1]), dtype=torch.int32)


@register_flop_formula(torch.ops.repro_torch.l2r_pairs_gemm)
def _b3_flops(a_shape, b_shape, n_bits, log2_radix, levels, **_):
    ops, _ = pairs_cost(a_shape[0], a_shape[1], b_shape[1],
                        n_bits // log2_radix, levels, n_bits)
    return sum(ops.values())
