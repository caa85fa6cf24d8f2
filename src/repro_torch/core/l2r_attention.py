"""Digit-serial (L2R) attention score walks over plane-stacked operands.

The port of ``repro/core/l2r_attention.py``.  Attention's QK^T is a batch
of inner products, the contraction the paper's composite unit streams
most-significant-digit first.  Queries are the LHS (ascending plane
stack on the head dim), cached keys the RHS (descending stack on the head
dim, the ``PlaneOperands.prepare_rhs(axis=-1)`` layout that the
incrementally stacked KV cache of models/attention.py keeps), and every
significance level is one GQA einsum ``"bqkgd,bskd->bkgqs"`` over a
contiguous slice pair.

Three entry points, one arithmetic:

* :func:`attn_scores_stacked`: 2D-1 level passes (the oracle and the
  default schedule), bit-identical at every ``levels`` truncation to the
  plane-pair decomposition;
* :func:`attn_scores_streaming_scan`: the per-level prefix emitter with
  the fold API of core/progressive.py, every prefix bit-identical to the
  truncated stacked schedule (both stacks zero-padded by D-1 blocks, so
  one fixed-width window per level);
* :func:`attn_scores_streaming_while`: the early-exit form, which stops
  once the consumer's fold says every score row is decided (the
  margin-bounded progressive decode of models/attention.py).  Its done
  flag is read on the host before each level.

These are einsums in the reference, not Pallas kernels, so they are
plain torch on any device.  A level contraction runs in true f32 (TF32
off) where the digit-magnitude guard of
``core/l2r_gemm.py:_f32_dot_exact`` holds, as the reference's
``Precision.HIGHEST`` einsum does; otherwise in int64 narrowed to the
reference's wrapping int32 on the CPU, and on a CUDA tensor (which has
no integer matmul) it raises.  int8 digits are never multiplied as
int8.

Quantization is per *vector*: each query row and each key slot carries
its own scale (:func:`quantize_per_vector`), so the scales commute with
the score contraction and incremental cache updates do not depend on the
chunking.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.device import no_tf32

from .l2r_gemm import _f32_dot_exact, wrap_int32
from .online import msdf_level_slices
from .progressive import _level_walk, _shift_add, _while_emitter
from .quant import (PlaneOperands, QuantConfig, _symmetric_quant,
                    plane_count, stack_planes_lhs, stack_planes_rhs)

__all__ = [
    "quantize_per_vector",
    "attn_scores_stacked",
    "attn_scores_streaming_scan",
    "attn_scores_streaming_while",
]

_GQA = "bqkgd,bskd->bkgqs"


def quantize_per_vector(x: torch.Tensor, cfg: QuantConfig):
    """Symmetric quantization with one scale per trailing vector.

    x (..., K) -> (q (..., K) int, scale (..., 1) f32), through the one
    formula of :func:`~repro_torch.core.quant._symmetric_quant`, so the
    scales are bit-identical to the reference's (jitted) ones.
    """
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    return _symmetric_quant(xf, amax, cfg)


# --------------------------------------------------------------- operands
def _describe(x) -> str:
    if isinstance(x, PlaneOperands):
        return x.describe()
    return f"tensor(shape={tuple(x.shape)}, dtype={x.dtype})"


def _check_attn_operand(op: PlaneOperands, want_side: str, n_bits: int,
                        log2_radix: int, other) -> None:
    if not op.matches(n_bits, log2_radix, side=want_side, contract_axis=None):
        raise ValueError(
            f"{op.describe()} cannot feed the {want_side} slot of an "
            f"attention score walk with n_bits={n_bits}, "
            f"log2_radix={log2_radix} (other operand: {_describe(other)}); "
            f"re-prepare the stack for this config")


def _attn_core_stacks(qq, kq, n_bits: int, log2_radix: int):
    """D-plane raw-digit core stacks of the stacked schedule.

    qq: (B, Q, Kv, G, dh) int or a prepared LHS :class:`PlaneOperands`;
    kq: (B, S, Kv, dh) int or a prepared RHS stack on axis -1 (the
    incrementally stacked KV cache).  Returns (q_stack, k_stack, dh).
    """
    if isinstance(qq, PlaneOperands):
        _check_attn_operand(qq, "lhs", n_bits, log2_radix, kq)
        q_stack, dh = qq.core_stack(shifted=False), qq.k
    else:
        dh = qq.shape[-1]
        q_stack = stack_planes_lhs(qq, n_bits, log2_radix, shifted=False)
    if isinstance(kq, PlaneOperands):
        _check_attn_operand(kq, "rhs", n_bits, log2_radix, qq)
        k_stack = kq.core_stack(shifted=False)
    else:
        k_stack = stack_planes_rhs(kq, n_bits, log2_radix, axis=-1,
                                   shifted=False)
    return q_stack, k_stack, dh


def _attn_window_stacks(qq, kq, n_bits: int, log2_radix: int):
    """Zero-padded (2D-1)-block stacks of the fixed-width streaming window
    (a window-padded cache stack is used as it is, with no copy)."""
    d = plane_count(n_bits, log2_radix)
    if isinstance(qq, PlaneOperands):
        _check_attn_operand(qq, "lhs", n_bits, log2_radix, kq)
        q_pad, dh = qq.window_stack(), qq.k
    else:
        dh = qq.shape[-1]
        q_pad = F.pad(stack_planes_lhs(qq, n_bits, log2_radix, shifted=False),
                      (0, (d - 1) * dh))
    if isinstance(kq, PlaneOperands):
        _check_attn_operand(kq, "rhs", n_bits, log2_radix, qq)
        k_pad = kq.window_stack()
    else:
        k_pad = F.pad(stack_planes_rhs(kq, n_bits, log2_radix, axis=-1,
                                       shifted=False), (0, (d - 1) * dh))
    return q_pad, k_pad, dh


def _score_shape(qq, kq) -> tuple[int, ...]:
    qs = qq.stack.shape if isinstance(qq, PlaneOperands) else qq.shape
    ks = kq.stack.shape if isinstance(kq, PlaneOperands) else kq.shape
    b, q, kv, g = qs[:4]
    return (b, kv, g, q, ks[1])


def _level_einsum(a_l: torch.Tensor, b_l: torch.Tensor) -> torch.Tensor:
    """One level's GQA contraction as int32: a true-f32 einsum when the
    operands were cast to f32 under the exactness guard, else an int64
    einsum narrowed to the reference's wrapping int32 (CPU only)."""
    if a_l.is_floating_point():
        with no_tf32():
            return torch.einsum(_GQA, a_l, b_l).to(torch.int32)
    if a_l.is_cuda:
        raise RuntimeError(
            "CUDA has no integer matmul: this digit config's score levels "
            "fail the f32 exactness guard (core/l2r_gemm.py:_f32_dot_exact) "
            "and have no route on the card")
    return wrap_int32(torch.einsum(_GQA, a_l.to(torch.int64),
                                   b_l.to(torch.int64)))


def _zeros(qq, kq) -> torch.Tensor:
    dev = (qq.stack if isinstance(qq, PlaneOperands) else qq).device
    return torch.zeros(_score_shape(qq, kq), dtype=torch.int32, device=dev)


# --------------------------------------------------------- stacked schedule
def attn_scores_stacked(
    qq,
    kq,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
) -> torch.Tensor:
    """Level-stacked digit-serial QK^T: int32 scores (B, Kv, G, Q, S).

    qq: (B, Q, Kv, G, dh) signed ints (or a prepared LHS stack); kq:
    (B, S, Kv, dh) signed ints (or the cache's RHS stack on axis -1).
    With ``levels=None`` this equals the int32 einsum of the raw operands
    exactly; fewer levels give the MSDF progressive prefix, the pair set
    of the pair decomposition (core/online.py:msdf_level_slices).
    """
    d = plane_count(n_bits, log2_radix)
    q_stack, k_stack, dh = _attn_core_stacks(qq, kq, n_bits, log2_radix)
    slices = msdf_level_slices(d, levels)
    acc = _zeros(qq, kq)
    if not slices:  # levels=0: empty MSDF prefix
        return acc
    if _f32_dot_exact(dh, max(hi - lo + 1 for _, lo, hi in slices),
                      log2_radix):
        q_stack = q_stack.to(torch.float32)
        k_stack = k_stack.to(torch.float32)
    for (s, i_lo, i_hi) in slices:
        a_l = q_stack[..., i_lo * dh:(i_hi + 1) * dh]
        r0 = (d - 1 - s + i_lo) * dh
        b_l = k_stack[..., r0:r0 + (i_hi - i_lo + 1) * dh]
        acc = _shift_add(acc, _level_einsum(a_l, b_l), log2_radix * s)
    return acc


# ------------------------------------------------------- streaming emitters
def _attn_stream_setup(qq, kq, n_bits: int, log2_radix: int) -> Callable:
    """Per-level ``term(ao, bo)`` of the fixed-width attention window: the
    scan and the while loop share the same slices and dtypes."""
    d = plane_count(n_bits, log2_radix)
    q_pad, k_pad, dh = _attn_window_stacks(qq, kq, n_bits, log2_radix)
    if _f32_dot_exact(dh, d, log2_radix):
        q_pad = q_pad.to(torch.float32)
        k_pad = k_pad.to(torch.float32)
    w = d * dh

    def term(ao: int, bo: int) -> torch.Tensor:
        return _level_einsum(q_pad[..., ao * dh:ao * dh + w],
                             k_pad[..., bo * dh:bo * dh + w])

    return term


def attn_scores_streaming_scan(
    qq,
    kq,
    fold: Callable | None = None,
    init=None,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
    emit: bool = False,
):
    """Walk every level of the MSDF score prefix stream.

    ``fold(carry, partial, level_index) -> carry`` consumes each int32
    score prefix (B, Kv, G, Q, S) as it is emitted; every prefix is
    bit-identical to :func:`attn_scores_stacked` truncated at that depth.
    Returns ``(final_partial, final_fold_carry, stack_or_None)``
    (``emit=True`` also stacks the per-level prefixes).
    """
    a_off, b_off, svals = _level_walk(plane_count(n_bits, log2_radix),
                                      levels)
    acc = _zeros(qq, kq)
    if not svals:
        empty = acc.new_zeros((0, *acc.shape)) if emit else None
        return acc, init, empty
    term = _attn_stream_setup(qq, kq, n_bits, log2_radix)
    fold_c, snaps = init, []
    for t, (ao, bo, s) in enumerate(zip(a_off, b_off, svals)):
        acc = _shift_add(acc, term(ao, bo), log2_radix * s)
        if fold is not None:
            fold_c = fold(fold_c, acc, t)
        if emit:
            snaps.append(acc)
    return acc, fold_c, (torch.stack(snaps) if emit else None)


def attn_scores_streaming_while(
    qq,
    kq,
    fold: Callable | None = None,
    init=None,
    done_fn: Callable | None = None,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
):
    """Early-exit streaming score walk: the level walk of
    :func:`attn_scores_streaming_scan`, stopping as soon as
    ``done_fn(fold_carry)`` is true (read on the host before each level:
    one device sync a level on the card).  The same per-level arithmetic,
    so the prefix after ``levels_run`` levels is bit-identical to the
    scan's, and so is the exit level.

    Returns ``(partial, fold_carry, levels_run)`` (``levels_run`` an int).
    """
    a_off, b_off, svals = _level_walk(plane_count(n_bits, log2_radix),
                                      levels)
    acc0 = _zeros(qq, kq)
    if not svals:
        return acc0, init, 0
    term = _attn_stream_setup(qq, kq, n_bits, log2_radix)

    def advance(acc: torch.Tensor, t: int) -> torch.Tensor:
        return _shift_add(acc, term(a_off[t], b_off[t]),
                          log2_radix * svals[t])

    t, acc, fold_c = _while_emitter(advance, len(svals), acc0, fold, init,
                                    done_fn)
    return acc, fold_c, t
