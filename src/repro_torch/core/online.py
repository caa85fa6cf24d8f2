"""Most-significant-digit-first (MSDF / left-to-right) schedules.

The composite unit of the paper streams one partial-product term
PP_{i,j} = sum_k A_{k,i} * B_{k,j} per cycle, most significant first.  At
digit-plane granularity the stream is over plane pairs (i, j); the
significance of a pair is s = i + j (weight radix**s).  The *online*
property is that after consuming the pairs with the highest significance
levels, the remaining (unseen) tail has a strictly bounded magnitude, so
most-significant output digits can be emitted early.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = [
    "msdf_pairs",
    "msdf_levels",
    "msdf_level_slices",
    "msdf_products",
    "plane_bits",
    "tail_bound",
    "online_delay",
]


def msdf_levels(planes: int) -> List[int]:
    """Significance levels s = i + j in MSDF (descending) order."""
    return list(range(2 * planes - 2, -1, -1))


def msdf_pairs(planes: int, levels: int | None = None) -> List[Tuple[int, int]]:
    """Plane-pair schedule in MSDF order.

    Pairs (i, j) are emitted grouped by descending significance s = i + j;
    within a level, descending i (arbitrary but fixed — matches the
    paper's row-major walk of the partial product array transposed to
    MSDF order).  ``levels`` truncates to the first `levels` significance
    levels (the progressive-precision prefix).
    """
    out: List[Tuple[int, int]] = []
    lv = msdf_levels(planes)
    if levels is not None:
        lv = lv[:levels]
    for s in lv:
        for i in range(min(s, planes - 1), -1, -1):
            j = s - i
            if j < 0 or j >= planes:
                continue
            out.append((i, j))
    return out


def msdf_level_slices(
    planes: int, levels: int | None = None
) -> List[Tuple[int, int, int]]:
    """Level-stacked schedule: ``[(s, i_lo, i_hi)]`` in MSDF order.

    Significance level ``s`` fuses every plane pair ``(i, s - i)`` for
    ``i in [i_lo, i_hi]`` into ONE contraction: because the pair index
    range at a fixed level is *contiguous* in ``i`` (and hence in
    ``j = s - i``), the level's operands are contiguous slices of the
    K-stacked plane tensors (quant.py:stack_planes_lhs/rhs) and the D²
    pair matmuls of :func:`msdf_pairs` collapse to 2D-1 level matmuls.
    ``levels`` truncates identically to :func:`msdf_pairs` — the same
    pair set is processed, so truncated results are bit-identical.
    """
    out: List[Tuple[int, int, int]] = []
    lv = msdf_levels(planes)
    if levels is not None:
        lv = lv[:levels]
    for s in lv:
        out.append((s, max(0, s - planes + 1), min(s, planes - 1)))
    return out


def msdf_products(
    planes: int, levels: int | None = None, first_level: int = 0
) -> List[Tuple[int, int, int, int]]:
    """The walk of levels ``[first_level, levels)`` as plane-range
    products ``[(i_lo, i_hi, j_lo, j_hi)]``: the walk's sum is the sum
    over the list of ``(sum of A planes i_lo..i_hi) . (sum of B planes
    j_lo..j_hi)``, on pre-shifted planes (quant.py:shifted_planes).

    A pre-shifted plane is a bit-field of its operand, so a plane range
    is the operand under a bit mask (:func:`plane_bits`) and fits the
    operand's type.  A prefix (``first_level == 0``) of L levels holds
    the pairs i + j >= 2D-1-L: plane i meets the B planes from
    j0(i) = 2D-1-L-i up to the top, a range that ends at the top plane.
    Every i whose j0(i) reaches the lowest B plane in play shares one
    product, so the prefix is at most D products and at full depth one,
    ``a . b``.  A table that starts above level 0 gets no such collapse:
    it runs as its plane pairs, one product each, in MSDF order.
    int32 sums wrap identically in any order, so every form gives the
    level walk's bits.
    """
    n_lv = 2 * planes - 1 if levels is None else min(levels, 2 * planes - 1)
    if first_level:
        lv = msdf_levels(planes)[first_level:n_lv]
        return [(i, i, s - i, s - i) for s in lv
                for i in range(min(s, planes - 1), max(0, s - planes + 1) - 1,
                               -1)]
    if n_lv <= 0:
        return []
    j_min = max(0, planes - n_lv)    # the lowest plane in any pair
    t = 2 * planes - 1 - n_lv - j_min  # planes i >= t pair with j >= j_min
    return ([(i, i, 2 * planes - 1 - n_lv - i, planes - 1)
             for i in range(j_min, t)] + [(t, planes - 1, j_min, planes - 1)])


def plane_bits(planes: int, log2_radix: int, lo: int, hi: int,
               bits: int = 8) -> int:
    """The mask of pre-shifted planes ``lo..hi`` of a ``bits``-bit operand
    (int8, or int16 for n_bits 9-16): plane i < D-1 keeps bits [b*i,
    b*(i+1)); the top plane keeps bit b*(D-1) and every bit above it, the
    sign extension included, so ``x & mask`` read as the operand's type
    is the planes' sum."""
    top = bits if hi == planes - 1 else log2_radix * (hi + 1)
    return ((1 << top) - 1) & ~((1 << (log2_radix * lo)) - 1)


def tail_bound(
    planes: int,
    levels_done: int,
    log2_radix: int,
    k: int,
    signed: bool = True,
) -> int:
    """Upper bound on |sum of unprocessed plane-pair products|.

    After the first ``levels_done`` significance levels, the unseen tail is
      sum_{s < s_min} n_pairs(s) * dmax_i * dmax_j * k * radix**s
    with dmax = radix - 1 for unsigned planes (the signed top plane has
    magnitude <= radix/2 <= radix-1, so this is a valid upper bound).
    ``k`` is the contraction (inner-product) length.
    """
    r = 1 << log2_radix
    dmax = r - 1
    s_min = 2 * planes - 1 - levels_done  # smallest processed level
    bound = 0
    for s in range(0, s_min):
        n_pairs = sum(
            1
            for i in range(planes)
            if 0 <= s - i < planes
        )
        bound += n_pairs * dmax * dmax * k * (r ** s)
    return bound


def online_delay(n_bits: int, log2_radix: int) -> int:
    """Steps before the first output digit is guaranteed stable.

    Digit-level analogue of the paper's delta_Mult: the first MS output
    digit of the product is stable once the unseen tail is smaller than
    the weight of that digit.  For the plane-pair stream this is the
    number of levels L such that tail_bound < radix**(2*planes - 1 - L)
    ... resolved numerically for k = 1.
    """
    planes = n_bits // log2_radix
    r = 1 << log2_radix
    for lv in range(1, 2 * planes):
        top_weight = r ** (2 * planes - 1 - lv)
        if tail_bound(planes, lv, log2_radix, k=1) < top_weight:
            return lv
    return 2 * planes - 1
