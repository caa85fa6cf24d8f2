"""L2R digit-plane GEMM schedules in plain PyTorch.

The port of ``repro/core/l2r_gemm.py``.  With radix-2^b digit planes

    A @ B = sum_{i,j} (A_i @ B_j) * 2^{b (i+j)}

and processing the (i, j) pairs by decreasing significance s = i + j is
the paper's MSDF stream; truncating after ``levels`` significance levels
gives the progressive-precision prefix.  Two schedules live here: the
pair loop (:func:`l2r_matmul_int`, the oracle) and the level-stacked
schedule (:func:`l2r_matmul_int_stacked` / :func:`stacked_gemm_planes`:
2D-1 fused level matmuls, bit-identical including truncation).

These are the plain versions.  The integer dots follow the tensor's
device: on the CPU they run in int64 and narrow to int32 on purpose, so
a sum that leaves int32 wraps exactly as the reference's int32
accumulator does (``L2R_CERTIFY=warn`` parity); CUDA has no integer
matmul, so on a CUDA tensor only the guarded raw-digit f32 dot
(:func:`_f32_dot_exact`, a long level dot as exact chunks) runs and
anything else raises — the card's
integer GEMM is the hand-written kernel (kernels/l2r_gemm/kernel.py).
"""

from __future__ import annotations

import torch

from repro_torch.device import no_tf32

from .online import msdf_level_slices, msdf_pairs
from .quant import (QuantConfig, QuantizedWeights, digit_planes, quantize,
                    stack_planes_lhs, stack_planes_rhs)

__all__ = ["l2r_matmul_int", "l2r_matmul_int_stacked", "stacked_gemm_planes",
           "l2r_matmul", "l2r_dense", "wrap_int32"]


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Narrow an int64 tensor to int32 modulo 2^32 (two's complement)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer contraction of a's last axis with b's first, in
    int64 (a ring homomorphism onto the reference's wrapping int32)."""
    if a.is_cuda:
        raise RuntimeError(
            "CUDA has no integer matmul: the card's integer digit-plane "
            "GEMM is kernels/l2r_gemm/kernel.py:l2r_gemm_stacked_planes, "
            "and the plain versions on the card take only the guarded "
            "raw-digit f32 dot")
    return torch.matmul(a.to(torch.int64), b.to(torch.int64))


def l2r_matmul_int(
    aq: torch.Tensor,
    bq: torch.Tensor,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
) -> torch.Tensor:
    """Exact (or MSDF-truncated) integer matmul via digit planes: the pair
    loop.  aq: (..., M, K), bq: (K, N) signed ints -> int32 (..., M, N);
    with levels=None this equals ``aq @ bq`` exactly (modulo 2^32).
    On a CUDA tensor the pair dots run as guarded true-f32 dots."""
    d = n_bits // log2_radix
    ap = digit_planes(aq, n_bits, log2_radix)  # (D, ..., M, K) int8
    bp = digit_planes(bq, n_bits, log2_radix)  # (D, K, N) int8
    acc = torch.zeros((*aq.shape[:-1], bq.shape[-1]), dtype=torch.int64,
                      device=aq.device)
    if aq.is_cuda and _f32_dot_exact(aq.shape[-1], 1, log2_radix):
        ap, bp = ap.to(torch.float32), bp.to(torch.float32)
    for (i, j) in msdf_pairs(d, levels):
        if ap.is_floating_point():
            with no_tf32():
                term = torch.matmul(ap[i], bp[j]).to(torch.int64)
        else:
            term = _int_dot(ap[i], bp[j])
        acc += term << (log2_radix * (i + j))
    return wrap_int32(acc)


def l2r_matmul_int_stacked(
    aq: torch.Tensor,
    bq: torch.Tensor,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
) -> torch.Tensor:
    """Level-stacked MSDF integer matmul over raw-digit stacks:
    bit-identical to :func:`l2r_matmul_int`, 2D-1 matmuls instead of D²."""
    a_stack = stack_planes_lhs(aq, n_bits, log2_radix, shifted=False)
    b_rev = stack_planes_rhs(bq, n_bits, log2_radix, shifted=False)
    return stacked_gemm_planes(a_stack, b_rev, aq.shape[-1],
                               n_bits, log2_radix, levels, shifted=False)


def _f32_dot_exact(k: int, max_pairs: int, log2_radix: int) -> bool:
    """Can a level contraction of raw digits run exactly in float32?

    Every prefix of a level sum is bounded by
    ``n_pairs(s) * K * (radix-1)^2``; below 2^24 every intermediate is an
    exactly representable f32 integer, whatever the summation order.
    """
    dmax = (1 << log2_radix) - 1
    return max_pairs * k * dmax * dmax < (1 << 24)


def _f32_chunk(max_pairs: int, log2_radix: int) -> int:
    """The longest contraction chunk (of each plane) whose level dot passes
    :func:`_f32_dot_exact`: a longer dot on the card runs as such chunks,
    each exact in f32, summed in int64 (the same integer)."""
    dmax = (1 << log2_radix) - 1
    return max(1, ((1 << 24) - 1) // (max_pairs * dmax * dmax))


def stacked_gemm_planes(
    a_stack: torch.Tensor,
    b_rev: torch.Tensor,
    k: int,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
    shifted: bool = True,
    first_level: int = 0,
) -> torch.Tensor:
    """Level-stacked contraction over pre-stacked digit planes.

    a_stack: (..., M, D*K) ascending planes; b_rev: (D*K, N) descending;
    ``k`` is the un-stacked contraction length.  ``shifted=True`` takes
    pre-shifted bit-field planes (one integer dot per level, no shifts);
    ``shifted=False`` takes raw digits, shifts once per level, and runs
    the level dots in true f32 when :func:`_f32_dot_exact` holds; on a
    CUDA tensor a longer contraction (fc6 at n_bits 12, radix 16) runs as
    exact f32 chunks of :func:`_f32_chunk` summed in int64.
    ``first_level`` skips the walk's leading levels: the result is the
    sum of levels ``[first_level, levels)`` (one level of an early-exit
    walk).
    """
    d = n_bits // log2_radix
    slices = msdf_level_slices(d, levels)[first_level:]
    acc = torch.zeros((*a_stack.shape[:-1], b_rev.shape[-1]),
                      dtype=torch.int64, device=a_stack.device)
    if not slices:  # levels=0: empty MSDF prefix, same as the pair loop
        return acc.to(torch.int32)
    max_pairs = max(hi - lo + 1 for _, lo, hi in slices)
    exact = _f32_dot_exact(k, max_pairs, log2_radix)
    use_f32 = not shifted and (exact or a_stack.is_cuda)
    kc = k if exact else _f32_chunk(max_pairs, log2_radix)
    if use_f32:
        a_stack = a_stack.to(torch.float32)
        b_rev = b_rev.to(torch.float32)
    for (s, i_lo, i_hi) in slices:
        a_l = a_stack[..., i_lo * k:(i_hi + 1) * k]
        r0 = (d - 1 - s + i_lo) * k
        b_l = b_rev[r0:r0 + (i_hi - i_lo + 1) * k]
        if use_f32 and kc >= k:
            with no_tf32():
                term = torch.matmul(a_l, b_l).to(torch.int64)
        elif use_f32:  # exact chunks of every plane's contraction
            p = i_hi - i_lo + 1
            a3 = a_l.unflatten(-1, (p, k))
            b3 = b_l.unflatten(0, (p, k))
            term = 0
            for c0 in range(0, k, kc):
                with no_tf32():
                    term = term + torch.matmul(
                        a3[..., c0:c0 + kc].flatten(-2),
                        b3[:, c0:c0 + kc].flatten(0, 1)).to(torch.int64)
        else:
            term = _int_dot(a_l, b_l)
        if not shifted:
            term = term << (log2_radix * s)
        acc += term
    return wrap_int32(acc)


def l2r_matmul(
    x: torch.Tensor,
    w: torch.Tensor | None,
    cfg: QuantConfig = QuantConfig(),
    levels: int | None = None,
    w_q: tuple[torch.Tensor, torch.Tensor] | QuantizedWeights | None = None,
) -> torch.Tensor:
    """Float-in/float-out matmul computed through the pair loop: x is
    quantized per row on the fly, w per output channel (or taken from
    ``w_q``), and the int32 result dequantized to x.dtype."""
    xq, x_scale = quantize(x, cfg, axis=x.ndim - 2 if cfg.per_channel else None)
    if w_q is None:
        wq, w_scale = quantize(w, cfg, axis=-1)  # per-out-channel: (1, N)
    elif isinstance(w_q, QuantizedWeights):
        wq, w_scale = w_q.q, w_q.scale
    else:
        wq, w_scale = w_q
    out = l2r_matmul_int(xq, wq, cfg.n_bits, cfg.log2_radix, levels)
    return (out.to(torch.float32) * x_scale * w_scale).to(x.dtype)


def l2r_dense(
    x: torch.Tensor,
    w: torch.Tensor | None,
    cfg: QuantConfig | None,
    levels: int | None = None,
    w_q: tuple[torch.Tensor, torch.Tensor] | QuantizedWeights | None = None,
) -> torch.Tensor:
    """Drop-in dense: a plain ``x @ w`` in x's dtype (true f32, TF32
    off) when ``cfg`` is None, the pair-loop L2R path (:func:`l2r_matmul`)
    otherwise.  ``w_q`` carries pre-quantized weights (built once at
    load) so the call skips the weight quantization."""
    if cfg is None:
        with no_tf32():
            return torch.matmul(x, w.to(x.dtype))
    lead = x.shape[:-1]
    n = (w_q.q if isinstance(w_q, QuantizedWeights) else w_q[0]
         if w_q is not None else w).shape[-1]
    out = l2r_matmul(x.reshape(-1, x.shape[-1]), w, cfg, levels, w_q=w_q)
    return out.reshape(*lead, n)
