"""Kernels B1-B6 on the card, against their plain versions, and the
progressive routes and the golden model on the card against the same
calls on the CPU.

Every test here needs a CUDA card (a hand-written kernel has no CPU
mode) and skips without one.  The file imports neither jax nor repro,
so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import progressive as tp
from repro_torch.core.quant import (QuantConfig, quantize, quantize_weights,
                                    stack_planes_lhs, stack_planes_rhs)
from repro_torch.core.ipu import simulate_cipu
from repro_torch.core.l2r_gemm import wrap_int32
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import msdf_ipu
from repro_torch.kernels.l2r_gemm import kernel
from repro_torch.kernels.l2r_gemm import ops

SHAPES = [(5, 3, 7), (130, 19, 67), (16, 64, 1000), (300, 128, 96)]
CONFIGS = [(8, 2), (8, 1), (8, 4), (4, 2)]
# M <= 16 with K over many 64-deep chunks: the walk is split over blocks
SPLIT_SHAPES = [(8, 4096, 1000), (16, 300, 130), (3, 1000, 77)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _ints(dev, m, k, n, n_bits, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    hi = 1 << (n_bits - 1)
    dt = torch.int8 if n_bits <= 8 else torch.int16
    a = torch.randint(-hi, hi, (m, k), generator=g, device=dev, dtype=dt)
    b = torch.randint(-hi, hi, (k, n), generator=g, device=dev, dtype=dt)
    return a, b


def _stacks(dev, m, k, n, n_bits, log2_radix, seed=0):
    a, b = _ints(dev, m, k, n, n_bits, seed)
    return (stack_planes_lhs(a, n_bits, log2_radix),
            stack_planes_rhs(b, n_bits, log2_radix))


def _levels(n_bits, log2_radix):
    return [None] + list(range(2 * (n_bits // log2_radix)))


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_kernel_matches_plain_every_level(dev, m, k, n, n_bits, log2_radix):
    sa, sb = _stacks(dev, m, k, n, n_bits, log2_radix)
    for lv in _levels(n_bits, log2_radix):
        got = kernel.l2r_gemm_stacked_planes(sa, sb, n_bits, log2_radix, lv)
        ref = kernel.l2r_gemm_stacked_planes_plain(sa, sb, n_bits,
                                                   log2_radix, lv)
        assert torch.equal(got, ref), lv


@pytest.mark.cuda
def test_kernel_accumulates_into_out(dev):
    sa, sb = _stacks(dev, 70, 64, 40, 8, 2)
    acc = torch.full((70, 40), -3, dtype=torch.int32, device=dev)
    kernel.l2r_gemm_stacked_planes(sa, sb, out=acc)
    assert torch.equal(acc, kernel.l2r_gemm_stacked_planes_plain(sa, sb) - 3)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(dev):
    sa, sb = _stacks(dev, 8, 16, 8, 8, 2)
    with pytest.raises(ValueError, match="contiguous int8"):
        kernel.l2r_gemm_stacked_planes(sa.t().contiguous().t(), sb)


# int16 planes (n_bits 9-16): the int16 entries of B1-B3, D up to 16
WIDE_CONFIGS = [(12, 4), (16, 4), (16, 2), (16, 1)]
# B1's and B3's int16 tiles beyond SHAPES + SPLIT_SHAPES: 128 x 64 (N <= 64)
# with K a multiple of 8 but not of 32, and with N or K off the 16-byte
# pieces; 64 x 128 with a ragged K tail
INT16_SHAPES = [(200, 72, 64), (150, 40, 33), (257, 200, 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits,log2_radix", WIDE_CONFIGS)
@pytest.mark.parametrize("m,k,n", SHAPES + SPLIT_SHAPES + INT16_SHAPES)
def test_int16_planes_match_plain(dev, m, k, n, n_bits, log2_radix):
    """B1 (prefix tables, a one-level slab, B K-major and row-major), B2
    (every plane, out=) and B3 on int16 planes, bit for bit their plain
    versions at full depth and truncated; one launch each."""
    a, b = _ints(dev, m, k, n, n_bits)
    sa = stack_planes_lhs(a, n_bits, log2_radix)
    sb = stack_planes_rhs(b, n_bits, log2_radix)
    d = n_bits // log2_radix
    for lv in (None, 0, 1, 3, 2 * d - 2):
        ref = kernel.l2r_gemm_stacked_planes_plain(sa, sb, n_bits,
                                                   log2_radix, lv)
        for rhs in (sb, sb.t().contiguous().t()):
            assert torch.equal(kernel.l2r_gemm_stacked_planes(
                sa, rhs, n_bits, log2_radix, lv), ref), ("B1", lv)
        assert torch.equal(kernel.l2r_gemm_streaming_planes(
            sa, sb, n_bits, log2_radix, lv),
            kernel.l2r_gemm_streaming_planes_plain(sa, sb, n_bits,
                                                   log2_radix, lv)), ("B2", lv)
        assert torch.equal(kernel.l2r_gemm_pairs(a, b, n_bits, log2_radix, lv),
                           kernel.l2r_gemm_pairs_plain(a, b, n_bits,
                                                       log2_radix, lv)), lv
    t = d - 1
    assert torch.equal(
        kernel.l2r_gemm_stacked_planes(sa, sb, n_bits, log2_radix, t + 1,
                                       first_level=t),
        kernel.l2r_gemm_stacked_planes_plain(sa, sb, n_bits, log2_radix,
                                             t + 1, first_level=t))
    full = kernel.l2r_gemm_streaming_planes_plain(sa, sb, n_bits, log2_radix)
    acc = torch.full(full.shape, -5, dtype=torch.int32, device=dev)
    kernel.l2r_gemm_streaming_planes(sa, sb, n_bits, log2_radix, out=acc)
    assert torch.equal(acc, full - 5)
    before = dict(kernel.LAUNCHES)
    kernel.l2r_gemm_stacked_planes(sa, sb, n_bits, log2_radix)
    kernel.l2r_gemm_streaming_planes(sa, sb, n_bits, log2_radix)
    kernel.l2r_gemm_pairs(a, b, n_bits, log2_radix)
    assert all(kernel.LAUNCHES[name] == before[name] + 1 for name in before)


def _extreme_int16(dev, m, k, n, seed):
    """int16 codes whose byte split drives the cross accumulator past 2^31
    within 32,900 elements of contraction: -32513 (high byte -128, low byte
    255) up to there, random extremes of the int16 range after it."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ends = torch.tensor([-32768, -32513, -256, 255, 32512, 32767],
                        dtype=torch.int16, device=dev)
    a = torch.full((m, k), -32513, dtype=torch.int16, device=dev)
    b = torch.full((k, n), -32513, dtype=torch.int16, device=dev)
    a[:, 32900:] = ends[torch.randint(0, 6, (m, k - 32900), generator=g,
                                      device=dev)]
    b[32900:] = ends[torch.randint(0, 6, (k - 32900, n), generator=g,
                                   device=dev)]
    return a, b


@pytest.mark.cuda
def test_int16_fold_at_k_33000(dev):
    """B1 and B3 on int16 operands at K = 33,000 of extreme codes, where a
    byte accumulator would pass 2^31 without its fold: bit for bit the
    exact product mod 2^32 (f64 on the card: every partial sum is an
    integer below 2^53).  264 output tiles of 64 x 128 fill a wave of
    resident blocks, so each block walks its tile's whole contraction
    and folds at 32,768.  Then B1's fold after 1,024 passes of many
    products: D = 16 from level 1 (255 plane pairs) over 5 chunks."""
    m, k, n = 8448, 33000, 256
    a, b = _extreme_int16(dev, m, k, n, seed=11)
    ref = wrap_int32(
        (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64))
    sa = stack_planes_lhs(a, 16, 4)
    sbk = stack_planes_rhs(b, 16, 4).t().contiguous().t()
    assert torch.equal(kernel.l2r_gemm_stacked_planes(sa, sbk, 16, 4), ref)
    del sa, sbk
    assert torch.equal(kernel.l2r_gemm_pairs(a, b, 16, 4), ref)
    del a, b, ref
    sa, sb = _stacks(dev, 40, 160, 70, 16, 1, seed=12)
    for lv in (None, 20):
        assert torch.equal(
            kernel.l2r_gemm_stacked_planes(sa, sb, 16, 1, lv, first_level=1),
            kernel.l2r_gemm_stacked_planes_plain(sa, sb, 16, 1, lv,
                                                 first_level=1)), lv


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits,log2_radix", [(6, 2), (7, 1)])
@pytest.mark.parametrize("m,k,n", SHAPES + SPLIT_SHAPES)
def test_b2_int8_plane_counts(dev, m, k, n, n_bits, log2_radix):
    """B2's tensor-core route at D = 3 and 7 (int8 planes): every plane at
    every levels bit for bit, and a device-side level count."""
    sa, sb = _stacks(dev, m, k, n, n_bits, log2_radix)
    for lv in _levels(n_bits, log2_radix):
        assert torch.equal(
            kernel.l2r_gemm_streaming_planes(sa, sb, n_bits, log2_radix, lv),
            kernel.l2r_gemm_streaming_planes_plain(sa, sb, n_bits,
                                                   log2_radix, lv)), lv
    full = kernel.l2r_gemm_streaming_planes_plain(sa, sb, n_bits, log2_radix)
    got = kernel.l2r_gemm_streaming_planes(
        sa, sb, n_bits, log2_radix,
        level_count=torch.full((1,), 2, dtype=torch.int32, device=dev))
    assert torch.equal(got[:2], full[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SHAPES + SPLIT_SHAPES)
def test_b1_one_level_slab(dev, m, k, n):
    """B1 over one level's slab (``first_level``) sums to the full walk."""
    sa, sb = _stacks(dev, m, k, n, 8, 2)
    acc = torch.zeros((m, n), dtype=torch.int32, device=dev)
    for t in range(7):
        kernel.l2r_gemm_stacked_planes(sa, sb, levels=t + 1, first_level=t,
                                       out=acc)
        assert torch.equal(acc, kernel.l2r_gemm_stacked_planes_plain(
            sa, sb, levels=t + 1)), t


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
@pytest.mark.parametrize("m,k,n", SHAPES + SPLIT_SHAPES)
def test_b1_prefix_route_k_major_every_level(dev, m, k, n, n_bits,
                                             log2_radix):
    """B1's prefix route (the collapsed products of msdf_products) on a
    K-major B, the weight cache's layout, read in place."""
    sa, sb = _stacks(dev, m, k, n, n_bits, log2_radix, seed=3)
    sbk = sb.t().contiguous().t()
    for lv in _levels(n_bits, log2_radix):
        got = kernel.l2r_gemm_stacked_planes(sa, sbk, n_bits, log2_radix, lv)
        ref = kernel.l2r_gemm_stacked_planes_plain(sa, sb, n_bits,
                                                   log2_radix, lv)
        assert torch.equal(got, ref), lv


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
@pytest.mark.parametrize("m,k,n", SHAPES + SPLIT_SHAPES)
def test_b1_plane_pair_route_every_first_level(dev, m, k, n, n_bits,
                                               log2_radix):
    """B1's plane-pair route: every table that starts above level 0,
    B K-major, equals the plain walk of those levels."""
    sa, sb = _stacks(dev, m, k, n, n_bits, log2_radix, seed=4)
    sbk = sb.t().contiguous().t()
    n_lv = 2 * (n_bits // log2_radix) - 1
    for first in range(1, n_lv):
        for lv in (first + 1, n_lv):
            got = kernel.l2r_gemm_stacked_planes(sa, sbk, n_bits, log2_radix,
                                                 lv, first_level=first)
            ref = kernel.l2r_gemm_stacked_planes_plain(
                sa, sb, n_bits, log2_radix, lv, first_level=first)
            assert torch.equal(got, ref), (first, lv)


@pytest.mark.cuda
def test_conv_on_k_major_cache_matches_cpu(dev):
    """The fused conv through B1 on a K-major weight cache gives the
    CPU's integer conv bit for bit."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 32, 24))
                         .astype(np.float32))
    kw = dict(prestack=True, plane_axis=-2, plane_shifted=True, k_major=True)
    ref = ops.l2r_conv2d(x, None, w_q=quantize_weights(w, QuantConfig(), **kw))
    got = ops.l2r_conv2d(x.to(dev), None,
                         w_q=quantize_weights(w.to(dev), QuantConfig(), **kw))
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
@pytest.mark.parametrize("m,k,n", SHAPES + SPLIT_SHAPES)
def test_b2_matches_plain_every_level_and_count(dev, m, k, n, n_bits,
                                                log2_radix):
    sa, sb = _stacks(dev, m, k, n, n_bits, log2_radix)
    n_lv = 2 * (n_bits // log2_radix) - 1
    for lv in _levels(n_bits, log2_radix):
        got = kernel.l2r_gemm_streaming_planes(sa, sb, n_bits, log2_radix, lv)
        ref = kernel.l2r_gemm_streaming_planes_plain(sa, sb, n_bits,
                                                     log2_radix, lv)
        assert torch.equal(got, ref), lv
    full = ref
    for cnt in (1, 3, n_lv):
        got = kernel.l2r_gemm_streaming_planes(sa, sb, n_bits, log2_radix,
                                               level_count=cnt)
        assert torch.equal(got[:cnt], full[:cnt]), cnt
    # the count read from device memory
    cnt = torch.full((1,), 2, dtype=torch.int32, device=dev)
    got = kernel.l2r_gemm_streaming_planes(sa, sb, n_bits, log2_radix,
                                           level_count=cnt)
    assert torch.equal(got[:2], full[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SHAPES + SPLIT_SHAPES)
def test_b2_accumulates_into_out(dev, m, k, n):
    sa, sb = _stacks(dev, m, k, n, 8, 2)
    acc = torch.full((7, m, n), 11, dtype=torch.int32, device=dev)
    kernel.l2r_gemm_streaming_planes(sa, sb, out=acc)
    assert torch.equal(acc,
                       kernel.l2r_gemm_streaming_planes_plain(sa, sb) + 11)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
@pytest.mark.parametrize("m,k,n", SHAPES + SPLIT_SHAPES)
def test_b3_matches_plain_every_level(dev, m, k, n, n_bits, log2_radix):
    a, b = _ints(dev, m, k, n, n_bits)
    for lv in _levels(n_bits, log2_radix):
        got = kernel.l2r_gemm_pairs(a, b, n_bits, log2_radix, lv)
        ref = kernel.l2r_gemm_pairs_plain(a, b, n_bits, log2_radix, lv)
        assert torch.equal(got, ref), lv


def _k_major(b_rev):
    # the (D*K, N) stack with the contraction innermost: the weight caches'
    # layout, which B2 reads in place
    return b_rev.t().contiguous().t()


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
@pytest.mark.parametrize("m,k,n", SHAPES + SPLIT_SHAPES)
def test_b2_k_major_every_level_count_and_out(dev, m, k, n, n_bits,
                                              log2_radix):
    """B2 on the K-major B stack (read in place): every ``levels``, every
    ``level_count`` (an int and a device tensor), and ``out=``."""
    sa, sb = _stacks(dev, m, k, n, n_bits, log2_radix, seed=7)
    sbk = _k_major(sb)
    n_lv = 2 * (n_bits // log2_radix) - 1
    for lv in _levels(n_bits, log2_radix):
        ref = kernel.l2r_gemm_streaming_planes_plain(sa, sb, n_bits,
                                                     log2_radix, lv)
        got = kernel.l2r_gemm_streaming_planes(sa, sbk, n_bits, log2_radix,
                                               lv)
        assert torch.equal(got, ref), lv
    full = ref
    for cnt in range(n_lv + 1):
        for c in (cnt, torch.full((1,), cnt, dtype=torch.int32, device=dev)):
            acc = torch.full((n_lv, m, n), -3, dtype=torch.int32, device=dev)
            kernel.l2r_gemm_streaming_planes(sa, sbk, n_bits, log2_radix,
                                             level_count=c, out=acc)
            assert torch.equal(acc[:cnt], full[:cnt] - 3), cnt
            assert bool((acc[cnt:] == -3).all()), cnt  # left as they were


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 4096, 1000), (8, 4096, 1000),
                                   (16, 2048, 96), (5, 512, 3), (16, 96, 64)])
def test_b2_split_over_a_cluster_at_small_m(dev, m, k, n):
    """M <= 16 with few tiles: the contraction is split over a cluster of
    blocks (the plan says so), and the stream is bit-identical."""
    _, splits = kernel.streaming_plan(m, n, k, kernel._sm_count(dev))
    assert splits > 1
    sa, sb = _stacks(dev, m, k, n, 8, 2, seed=8)
    ref = kernel.l2r_gemm_streaming_planes_plain(sa, sb)
    assert torch.equal(kernel.l2r_gemm_streaming_planes(sa, _k_major(sb)),
                       ref)
    acc = torch.full_like(ref, 9)
    kernel.l2r_gemm_streaming_planes(sa, _k_major(sb), level_count=4,
                                     out=acc)
    assert torch.equal(acc[:4], ref[:4] + 9)
    assert bool((acc[4:] == 9).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 3, 1), (7, 3, 100), (16, 48, 4096),
                                   (9, 4112, 520), (33, 1, 17),
                                   (129, 160, 65), (16, 25088, 64)])
def test_b3_ragged_and_small_m_every_level(dev, m, k, n):
    """B3 on raw int8 at ragged M, N and K (K = 3 and 1 included), M <= 16
    with split contractions, and unaligned N: every ``levels``."""
    for n_bits, log2_radix in CONFIGS:
        a, b = _ints(dev, m, k, n, n_bits, seed=m + k + n)
        for lv in _levels(n_bits, log2_radix):
            got = kernel.l2r_gemm_pairs(a, b, n_bits, log2_radix, lv)
            ref = kernel.l2r_gemm_pairs_plain(a, b, n_bits, log2_radix, lv)
            assert torch.equal(got, ref), (n_bits, log2_radix, lv)


@pytest.mark.cuda
@pytest.mark.parametrize("size", range(1, 15))
def test_head_resize_on_card_matches_cpu(dev, size):
    """The FC head's 7x7 resize (the reference's jax.image.resize bits,
    models/resize.py) gives the CPU's bits on the card."""
    from repro_torch.models.resize import resize_7x7

    for batch in (1, 8):
        x = torch.from_numpy(np.maximum(np.random.default_rng(size)
                                        .standard_normal((batch, size, size,
                                                          512)), 0)
                             .astype(np.float32))
        got = resize_7x7(x.to(dev)).cpu()
        assert torch.equal(got.view(torch.int32),
                           resize_7x7(x).view(torch.int32)), batch


@pytest.mark.cuda
@pytest.mark.parametrize("early_exit", [False, True])
def test_streaming_argmax_on_card_matches_cpu(dev, early_exit):
    """The card's routes (B2 scan / B1 level loop) give the CPU's logits,
    tokens and exit levels bit for bit."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 40)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    cfg = QuantConfig()
    xq, xs = quantize(x, cfg, axis=0)
    w_q = quantize_weights(w, cfg)
    ref = tp.streaming_argmax(xq, w_q.q, xs, w_q.scale, bias=b,
                              early_exit=early_exit)
    got = tp.streaming_argmax(xq.to(dev), w_q.q.to(dev), xs.to(dev),
                              w_q.scale.to(dev), bias=b.to(dev),
                              early_exit=early_exit, cuda_walk=ops.CUDA_WALK)
    for r, g in zip(ref, got):
        assert torch.equal(g.cpu(), r)
    with pytest.raises(ValueError, match="CUDA_WALK"):
        tp.streaming_argmax(xq.to(dev), w_q.q.to(dev), xs.to(dev),
                            w_q.scale.to(dev), early_exit=early_exit)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_progressive_on_card_matches_cpu(dev, stride):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 16, 24))
                         .astype(np.float32))
    w_q = quantize_weights(w, QuantConfig(), prestack=True, plane_axis=-2,
                           plane_shifted=True)
    ref, _ = ops.l2r_conv2d_progressive(x, w_q=w_q, stride=stride)
    w_dev = quantize_weights(w.to(dev), QuantConfig(), prestack=True,
                             plane_axis=-2, plane_shifted=True)
    got, _ = ops.l2r_conv2d_progressive(x.to(dev), w_q=w_dev, stride=stride)
    assert torch.equal(got.partial.cpu(), ref.partial)
    acc, _, t, _ = ops.l2r_conv2d_progressive_while(x.to(dev), w_q=w_dev,
                                                     stride=stride)
    assert t == 7 and torch.equal(acc.cpu(), ref.partial[-1])


# ------------------------------------------- B6: the PE-array simulator
@pytest.mark.cuda
@pytest.mark.parametrize("n_bits", [4, 6, 8, 10])
@pytest.mark.parametrize("k", [1, 9, 27, 72, 100])
@pytest.mark.parametrize("m", [1, 127, 300])
def test_b6_matches_plain_and_int_sop(dev, m, k, n_bits):
    g = torch.Generator(device=dev).manual_seed(m * 1000 + k * 10 + n_bits)
    a = torch.randint(0, 1 << n_bits, (m, k), generator=g, device=dev,
                      dtype=torch.int32)
    b = torch.randint(0, 1 << n_bits, (m, k), generator=g, device=dev,
                      dtype=torch.int32)
    got = msdf_ipu.cipu_array(a, b, n_bits)
    assert torch.equal(got, msdf_ipu.cipu_array_plain(a, b, n_bits))
    assert torch.equal(got, msdf_ipu.int_sop_ref(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n_bits", [(300, 72, 12), (300, 1, 15),
                                        (129, 72, 8), (4097, 72, 8)])
def test_b6_wide_operands_and_partial_row_blocks(dev, m, k, n_bits):
    """Widths above 8 bits (the second operand byte's planes, up to the
    guard's 15 at k = 1) and M that leaves a partial 128-row block."""
    g = torch.Generator(device=dev).manual_seed(m + k + n_bits)
    a = torch.randint(0, 1 << n_bits, (m, k), generator=g, device=dev,
                      dtype=torch.int32)
    b = torch.randint(0, 1 << n_bits, (m, k), generator=g, device=dev,
                      dtype=torch.int32)
    got = msdf_ipu.cipu_array(a, b, n_bits)
    assert torch.equal(got, msdf_ipu.cipu_array_plain(a, b, n_bits))
    assert torch.equal(got, msdf_ipu.int_sop_ref(a, b))


@pytest.mark.cuda
def test_b6_unaligned_operands_and_high_bits(dev):
    """Rows that start off a 16-byte boundary take the 4-byte copies, and
    operand bits at or above n are never counted."""
    g = torch.Generator(device=dev).manual_seed(9)
    a = torch.randint(0, 1 << 12, (200 * 72 + 1,), generator=g, device=dev,
                      dtype=torch.int32)[1:].view(200, 72)
    b = torch.randint(0, 1 << 12, (200, 72), generator=g, device=dev,
                      dtype=torch.int32)
    got = msdf_ipu.cipu_array(a, b, 8)
    assert torch.equal(got, msdf_ipu.cipu_array_plain(a, b, 8))
    assert torch.equal(got, msdf_ipu.int_sop_ref(a & 255, b & 255))


@pytest.mark.cuda
def test_b6_matches_golden_model_and_counts_launches(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randint(0, 256, (500, 72), generator=g, device=dev,
                      dtype=torch.int32)
    b = torch.randint(0, 256, (500, 72), generator=g, device=dev,
                      dtype=torch.int32)
    before = msdf_ipu.LAUNCHES["cipu_array"]
    got = msdf_ipu.simulate_pe_array(a, b)
    assert msdf_ipu.LAUNCHES["cipu_array"] == before + 1
    assert torch.equal(got, simulate_cipu(a, b).final)
    with pytest.raises(ValueError, match="one card"):
        msdf_ipu.cipu_array(a, b.cpu())
    with pytest.raises(ValueError, match="SOP width"):
        msdf_ipu.cipu_array(a, b, 13)  # 2*13 + ceil(log2 72) = 33 bits


@pytest.mark.cuda
def test_golden_model_on_card_matches_cpu(dev):
    """simulate_cipu on CUDA tensors gives the CPU's final SOPs; its
    stable-bit counts use the card's log, which may round differently."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.integers(0, 256, (8, 72)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 256, (8, 72)).astype(np.int32))
    ref = simulate_cipu(a, b)
    got = simulate_cipu(a.to(dev), b.to(dev))
    assert torch.equal(got.final.cpu(), ref.final)
    assert (got.stable_bits.cpu() - ref.stable_bits).abs().max() <= 1


# ------------------------------------------- B5 / B4: flash attention
ATTN_CASES = [  # (sq, skv, h, kvh, dh, causal, window), after the JAX suite
    (256, 256, 4, 2, 64, True, None),
    (256, 256, 4, 1, 64, True, 64),
    (200, 200, 2, 2, 32, True, None),
    (128, 128, 8, 4, 64, False, None),
    (64, 64, 2, 2, 128, True, 16),
    (70, 130, 3, 1, 24, False, 40),
    (40, 40, 2, 2, 16, True, 0),  # a window that masks every key
    (33, 70, 2, 1, 20, True, None),  # bf16 rows of 40 bytes: element copies
]
# |got - ref| <= rel * |ref| + abs against the plain version, which walks
# the kernels' KV tiles: f32 the JAX suite's 3e-5; bf16 one ulp of the
# output (at most 2^-7 |x|) plus 1e-4, as chip_smoke.py holds them
ATTN_TOL = {torch.float32: (0.0, 3e-5), torch.bfloat16: (2.0 ** -7, 1e-4)}


def _qkv(dev, case, dtype, seed=0):
    sq, skv, h, kvh, dh = case[:5]
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((2, sq, h, dh), generator=g, device=dev).to(dtype)
    k = torch.randn((2, skv, kvh, dh), generator=g, device=dev).to(dtype)
    v = torch.randn((2, skv, kvh, dh), generator=g, device=dev).to(dtype)
    return q, k, v


def _close(got, ref, dtype):
    rel, atol = ATTN_TOL[dtype]
    d = (got.float() - ref.float()).abs() - rel * ref.float().abs()
    assert got.dtype == ref.dtype and d.max().item() <= atol, d.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_b5_matches_plain(dev, case, dtype):
    q, k, v = _qkv(dev, case, dtype)
    causal, window = case[5:]
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal, window)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    _close(got, fa.flash_attention_kernel_plain(q, k, v, causal, window),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b5_rows_that_see_no_key_are_zero(dev, dtype):
    """window=0 masks every key: B5's rows come out exactly 0, as the
    reference kernel's do (ROADMAP Queue C)."""
    q, k, v = _qkv(dev, (130, 130, 4, 2, 64), dtype, seed=2)
    got = fa.flash_attention(q, k, v, causal=True, window=0)
    assert got.dtype == dtype and not got.float().abs().max().item()
    assert torch.equal(got, fa.flash_attention_kernel_plain(q, k, v, True, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 3, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_b4_matches_plain(dev, case, dtype, levels):
    q, k, v = _qkv(dev, case, dtype)
    causal, window = case[5:]
    got = fa.flash_attention_l2r(q, k, v, levels=levels, causal=causal,
                                 window=window)
    _close(got, fa.flash_attention_l2r_plain(q, k, v, levels=levels,
                                             causal=causal, window=window),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 3, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b4_launch_on_prepared_operands(dev, dtype, levels):
    """The launch alone on operands quantized beforehand (what
    chip_smoke.py times as kernel_ms) is the wrapper's call."""
    case = ATTN_CASES[0]
    q, k, v = _qkv(dev, case, dtype, seed=5)
    ops_ = fa.l2r_kernel_operands(q, k, v)
    before = fa.LAUNCHES["flash_attention_l2r"]
    got = fa.flash_attention_l2r_launch(ops_, q.shape[-1], levels=levels)
    assert fa.LAUNCHES["flash_attention_l2r"] == before + 1
    assert torch.equal(got, fa.flash_attention_l2r(q, k, v, levels=levels))


@pytest.mark.cuda
def test_b4_b5_reject_what_they_do_not_take(dev):
    q, k, v = _qkv(dev, (16, 16, 2, 1, 64), torch.float32)
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_attention(q, k, v.to(torch.bfloat16))


# heads wider than 128 (the wide layout) and B4 on int16 q, k
WIDE_ATTN = [  # (sq, skv, h, kvh, dh, causal, window)
    (130, 130, 2, 1, 256, True, None),
    (100, 100, 4, 2, 256, True, 40),
    (70, 130, 2, 1, 200, False, None),
    (33, 70, 2, 2, 136, True, None),
    (150, 150, 10, 1, 256, True, 48),  # recurrentgemma-2b's 10 heads on 1
    (70, 100, 2, 1, 320, True, None),  # above 256: two column blocks
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WIDE_ATTN)
def test_b5_wide_heads_match_plain(dev, case, dtype):
    q, k, v = _qkv(dev, case, dtype, seed=3)
    causal, window = case[5:]
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal, window)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    _close(got, fa.flash_attention_kernel_plain(q, k, v, causal, window),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits,log2_radix", [(12, 4), (16, 4), (16, 2)])
def test_byte_split_scores_are_the_plain_walk_on_the_card(dev, n_bits,
                                                          log2_radix):
    """B4's int16 byte split as its plain version computes it, on CUDA
    tensors, bit for bit the plain walk's scores at every level prefix
    (full-range codes, the extremes included, dh 256)."""
    from repro_torch.core.quant import (plane_count, stack_planes_lhs,
                                        stack_planes_rhs)

    g = torch.Generator(device=dev).manual_seed(n_bits + log2_radix)
    hi = 1 << (n_bits - 1)
    q = torch.randint(-hi, hi, (2, 16, 256), generator=g, device=dev,
                      dtype=torch.int32).to(torch.int16)
    k = torch.randint(-hi, hi, (2, 24, 256), generator=g, device=dev,
                      dtype=torch.int32).to(torch.int16)
    q[0, :2], k[0, :2] = -hi, hi - 1
    qs = stack_planes_lhs(q, n_bits, log2_radix)
    ks = stack_planes_rhs(k, n_bits, log2_radix, axis=-1)
    d = plane_count(n_bits, log2_radix)
    for levels in [*range(1, 2 * d), None]:
        got = fa.l2r_byte_split_scores(q, k, n_bits, log2_radix, levels)
        assert got.is_cuda and got.dtype == torch.int32
        assert torch.equal(got, fa.l2r_score_tile(qs, ks, n_bits, log2_radix,
                                                  levels)), levels


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits,log2_radix,levels", [
    (8, 2, None), (8, 2, 3), (12, 4, None), (12, 4, 2), (16, 4, None),
    (16, 1, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WIDE_ATTN + ATTN_CASES[:2])
def test_b4_wide_route_matches_plain(dev, case, dtype, n_bits, log2_radix,
                                     levels):
    """B4's wide route: int8 q, k at dh > 128 and int16 q, k at any dh,
    within the limits of its plain version; one launch."""
    q, k, v = _qkv(dev, case, dtype, seed=4)
    causal, window = case[5:]
    before = fa.LAUNCHES["flash_attention_l2r"]
    got = fa.flash_attention_l2r(q, k, v, n_bits, log2_radix, levels, causal,
                                 window)
    assert fa.LAUNCHES["flash_attention_l2r"] == before + 1
    _close(got, fa.flash_attention_l2r_plain(q, k, v, n_bits, log2_radix,
                                             levels, causal, window), dtype)


# ----------------------------------------------------- slice 7: the LM path
def _smoke_lm(l2r):
    """The smoke SmolLM (6 layers, d = 96, f32) with seeded params on the
    CPU: (cfg, params)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models.common import materialize
    from repro_torch.models.transformer import lm_build

    cfg = get_smoke("smollm-135m")
    if l2r:
        cfg = dataclasses.replace(cfg, l2r=QuantConfig())
    params = materialize(lm_build(cfg), torch.Generator().manual_seed(7),
                         device="cpu")
    return cfg, params


def _serve(cfg, params, prompt, steps):
    """Prefill, then ``steps`` decode steps fed the prefill's greedy
    token and then its own: the logits of every step, (B, V) each."""
    from repro_torch.serve.engine import (make_decode_step,
                                          make_prefill_step, prepare_params)

    pp = prepare_params(cfg, params)
    state, logits = make_prefill_step(cfg, prompt.shape[1] + steps,
                                      torch.float32)(pp, {"tokens": prompt})
    decode = make_decode_step(cfg)
    out = [logits[:, 0]]
    tok = torch.argmax(logits, -1).to(torch.int32)
    for _ in range(steps):
        state, tok, logits = decode(pp, state, tok)
        out.append(logits[:, 0])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 24])
def test_chunked_attention_launches_b5_once_when_it_fits(dev, dtype, window):
    """chunked_attention on the card: one B5 launch when the arguments
    fit, none with softcap (the plain loop on the card); either within
    ATTN_TOL, elementwise, of the CPU's plain loop walking the same KV
    blocks (B5's KV_TILE keys, which its route ignores ``kv_chunk`` for),
    so that p rounds to bf16 against the same running maxima."""
    from repro_torch.kernels.flash_attention.kernel import KV_TILE
    from repro_torch.models.attention import chunked_attention

    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 70, 6, 64), generator=g).to(dtype)
    k, v = (torch.randn((2, 70, 2, 64), generator=g).to(dtype)
            for _ in range(2))
    for softcap, launches in ((None, 1), (30.0, 0)):
        ref = chunked_attention(q, k, v, window=window, softcap=softcap,
                                q_chunk=32, kv_chunk=KV_TILE)
        before = fa.LAUNCHES["flash_attention"]
        got = chunked_attention(q.to(dev), k.to(dev), v.to(dev),
                                window=window, softcap=softcap, q_chunk=32,
                                kv_chunk=KV_TILE)
        assert fa.LAUNCHES["flash_attention"] == before + launches
        _close(got.cpu(), ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("l2r", [False, True])
def test_smoke_lm_on_card_matches_cpu(dev, l2r):
    """The smoke LM's prefill and 3 decode steps on the card (B1 under
    every dense with l2r, B5 under the prefill's attention) against the
    same run on the CPU: logits within 1e-4 (f32 sums in other orders,
    B5's 3xTF32 within 3e-5), or, with l2r, on a row behind an int8
    activation code that rounded the other way, within 5 % of the row's
    largest |logit|; at least half of the rows within 1e-4."""
    cfg, params = _smoke_lm(l2r)
    prompt = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(8),
                           dtype=torch.int32)
    from repro_torch.models.common import tree_map

    ref = _serve(cfg, params, prompt, 3)
    got = _serve(cfg, tree_map(lambda t: t.to(dev), params), prompt.to(dev),
                 3)
    d = torch.stack([(a.cpu() - b).abs().amax(-1) for a, b in zip(got, ref)])
    mag = torch.stack([b.abs().amax(-1) for b in ref])
    if not l2r:
        assert d.max() <= 1e-4, d
    else:
        assert (d <= 0.05 * mag).all(), d / mag
        assert (d <= 1e-4).float().mean() >= 0.5, d


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [None, 5])
def test_l2r_forward_on_card_equals_plain_gemm_forward(dev, levels,
                                                       monkeypatch):
    """With B5 swapped for its plain version in both runs, the smoke LM's
    prefill and decode on B1 equal the same run on B1's plain version bit
    for bit; 6 x 6 + 1 B1 launches a step (the head on one position)."""
    import dataclasses

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.common import tree_map

    monkeypatch.setattr(fa_ops, "flash_attention_kernel",
                        fa.flash_attention_kernel_plain)
    cfg, params = _smoke_lm(True)
    cfg = dataclasses.replace(cfg, l2r_levels=levels)
    params = tree_map(lambda t: t.to(dev), params)
    prompt = torch.randint(0, cfg.vocab, (2, 16), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(9),
                           dtype=torch.int32)
    before = kernel.LAUNCHES["l2r_stacked_gemm"]
    got = _serve(cfg, params, prompt, 2)
    assert kernel.LAUNCHES["l2r_stacked_gemm"] == before + 3 * 37
    monkeypatch.setattr(kernel, "l2r_gemm_stacked_planes",
                        kernel.l2r_gemm_stacked_planes_plain)
    ref = _serve(cfg, params, prompt, 2)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# ------------------------------------- slice 8: digit-serial attention
@pytest.mark.cuda
@pytest.mark.parametrize("levels", [None, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 24])
def test_chunked_attention_l2r_launches_b4_once_when_it_fits(dev, dtype,
                                                             window, levels):
    """chunked_attention(l2r=) on the card: one B4 launch when the
    arguments fit, none with softcap (the plain loop on the card, its
    level einsums in true f32 under the guard); either within ATTN_TOL,
    elementwise, of the CPU's loop walking B4's KV_TILE-key blocks.  The
    loop rounds p to v's dtype before the row sum and B4 does not; one
    bf16 ulp of the output covers it."""
    from repro_torch.kernels.flash_attention.kernel import KV_TILE
    from repro_torch.models.attention import chunked_attention

    cfg = QuantConfig()
    g = torch.Generator().manual_seed(4)
    q = torch.randn((2, 70, 6, 64), generator=g).to(dtype)
    k, v = (torch.randn((2, 70, 2, 64), generator=g).to(dtype)
            for _ in range(2))
    for softcap, launches in ((None, 1), (30.0, 0)):
        kw = dict(window=window, softcap=softcap, q_chunk=32,
                  kv_chunk=KV_TILE, l2r=cfg, levels=levels)
        ref = chunked_attention(q, k, v, **kw)
        before = dict(fa.LAUNCHES)
        got = chunked_attention(q.to(dev), k.to(dev), v.to(dev), **kw)
        assert fa.LAUNCHES["flash_attention_l2r"] == \
            before["flash_attention_l2r"] + launches
        assert fa.LAUNCHES["flash_attention"] == before["flash_attention"]
        _close(got.cpu(), ref, dtype)


def _quantized_qk(b, q, kv, g, s, dh, n_bits, log2_radix, seed):
    from repro_torch.core.l2r_attention import quantize_per_vector

    cfg = QuantConfig(n_bits=n_bits, log2_radix=log2_radix)
    gen = torch.Generator().manual_seed(seed)
    qq, _ = quantize_per_vector(torch.randn((b, q, kv, g, dh), generator=gen),
                                cfg)
    kq, _ = quantize_per_vector(torch.randn((b, s, kv, dh), generator=gen),
                                cfg)
    return qq, kq


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
@pytest.mark.parametrize("q,s,dh", [(5, 70, 64), (1, 130, 24)])
def test_l2r_attn_scores_on_b1_bit_identical(dev, q, s, dh, n_bits,
                                             log2_radix):
    """l2r_attn_scores on CUDA tensors: one B1 launch per (batch, kv
    head) (none at levels=0), bit-identical to attn_scores_stacked on the CPU at every
    levels, from raw operands and from the cache's window-padded stack,
    on both schedules."""
    from repro_torch.core.l2r_attention import attn_scores_stacked
    from repro_torch.core.quant import PlaneOperands

    qq, kq = _quantized_qk(2, q, 2, 3, s, dh, n_bits, log2_radix, seed=q)
    k_po = PlaneOperands.prepare_rhs(kq.to(dev), n_bits, log2_radix, axis=-1,
                                     window_pad=True)
    for lv in _levels(n_bits, log2_radix):
        ref = attn_scores_stacked(qq, kq, n_bits, log2_radix, lv)
        for kin, sched in ((kq.to(dev), "stacked"), (k_po, "stacked"),
                           (kq.to(dev), "streaming")):
            before = kernel.LAUNCHES["l2r_stacked_gemm"]
            got = ops.l2r_attn_scores(qq.to(dev), kin, n_bits, log2_radix,
                                      lv, schedule=sched)
            # levels=0 is the empty prefix: B1 returns zeros, no launch
            assert kernel.LAUNCHES["l2r_stacked_gemm"] == \
                before + (0 if lv == 0 else 2 * 2)
            assert torch.equal(got.cpu(), ref), (lv, sched)
    with pytest.raises(ValueError, match="while-loop emitter"):
        ops.l2r_attn_scores(qq.to(dev), kq.to(dev), n_bits, log2_radix,
                            schedule="streaming", early_exit=True)


def _plane_cache(dev_, b=3, length=48, kvh=3, dh=64, steps=40, seed=0):
    from repro_torch.models.attention import init_kv_cache, update_kv_cache

    cfg = QuantConfig()
    gen = torch.Generator().manual_seed(seed)
    cache = init_kv_cache(b, length, kvh, dh, torch.float32, quant=cfg,
                          device="cpu")
    update_kv_cache(cache, torch.randn((b, steps, kvh, dh), generator=gen),
                    torch.randn((b, steps, kvh, dh), generator=gen),
                    torch.arange(steps, dtype=torch.int32)[None].expand(
                        b, steps), quant=cfg)
    q = torch.randn((b, 1, 3 * kvh, dh), generator=gen)
    return cache, q


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["tight", "loose", "mixed", "full"])
def test_decode_walk_on_card_matches_cpu(dev, walk):
    """decode_attention(l2r=) on the plane cache, on the card against the
    same call on the CPU: the exit levels and levels run equal (the
    decisions are f32 products and compares, exact on both), the int32
    scores of the walk equal, the outputs within 1e-5 (f32 softmax and
    PV sum in other orders); the card's cache appends equal the CPU's."""
    from repro_torch.core.l2r_attention import (attn_scores_streaming_while,
                                                quantize_per_vector)
    from repro_torch.core.policy import LevelPolicy, PrecisionClass
    from repro_torch.models.attention import (KVCache, attn_exit_tap,
                                              decode_attention,
                                              kv_plane_operands,
                                              update_kv_cache)

    cfg = QuantConfig()
    cache, q = _plane_cache(dev)
    kw = {"tight": dict(early_exit=True, exit_tol=1e-4),
          "loose": dict(early_exit=True, exit_tol=10.0),
          "mixed": dict(policy=LevelPolicy.from_classes(
              [PrecisionClass.exact(), PrecisionClass.budget(3),
               PrecisionClass.bounded(1e-3)])),
          "full": dict()}[walk]
    qpos = torch.full((3,), 39, dtype=torch.int32)
    runs = []
    for d in ("cpu", dev):
        c = KVCache(*(x.to(d) for x in cache))
        gen = torch.Generator().manual_seed(5)
        kn, vn = (torch.randn((3, 1, 3, 64), generator=gen).to(d)
                  for _ in range(2))
        update_kv_cache(c, kn, vn, torch.full((3, 1), 40, dtype=torch.int32,
                                              device=d), quant=cfg)
        with attn_exit_tap() as rec:
            out = decode_attention(q.to(d), c.k, c.v, c.positions,
                                   (qpos + 1).to(d), l2r=cfg,
                                   k_planes=c.k_planes, k_scale=c.k_scale,
                                   **kw)
        qq, _ = quantize_per_vector(q.to(d).reshape(3, 1, 3, 3, 64), cfg)
        acc, _, t = attn_scores_streaming_while(qq, kv_plane_operands(c, cfg))
        runs.append((c, rec, out.cpu(), acc.cpu(), t))
    (c0, r0, o0, a0, t0), (c1, r1, o1, a1, t1) = runs
    for name in ("k_planes", "k_scale", "k", "positions"):
        assert torch.equal(getattr(c1, name).cpu(), getattr(c0, name)), name
    assert torch.equal(a1, a0) and t0 == t1 == 7
    assert len(r0) == len(r1) == (0 if walk == "full" else 1)
    for x, y in zip(r0, r1):
        assert x["levels_run"] == y["levels_run"]
        np.testing.assert_array_equal(x["exit_levels"], y["exit_levels"])
    assert (o1 - o0).abs().max() <= 1e-5


@pytest.mark.cuda
def test_decode_walk_raises_on_card_where_the_f32_guard_fails(dev):
    """radix 256 at dh = 300: 300 * 255^2 >= 2^24, so no level einsum is
    exact in f32; CUDA has no integer matmul, and the walk raises (the
    CPU takes int64 dots, tests/test_torch_l2r_attention.py)."""
    from repro_torch.models.attention import decode_attention

    cfg = QuantConfig(n_bits=8, log2_radix=8)
    q = torch.randn((1, 1, 2, 300), device=dev)
    k = torch.randn((1, 4, 1, 300), device=dev)
    pos = torch.arange(4, dtype=torch.int32, device=dev)[None]
    for kw in (dict(), dict(early_exit=True)):
        with pytest.raises(RuntimeError, match="integer matmul"):
            decode_attention(q, k, k, pos, pos[:, -1], l2r=cfg, **kw)


@pytest.mark.cuda
def test_smoke_lm_attn_l2r_on_card_matches_cpu(dev):
    """The smoke LM with l2r and attn_l2r, prefill and 3 decode steps on
    the card (B1 under every dense, B4 under the prefill's attention, the
    decode walk on the plane cache) against the same run on the CPU, by
    test_smoke_lm_on_card_matches_cpu's rule: every row within 5 % of its
    largest |logit|, at least half within 1e-4."""
    import dataclasses

    from repro_torch.models.common import tree_map

    cfg, params = _smoke_lm(True)
    cfg = dataclasses.replace(cfg, attn_l2r=QuantConfig())
    prompt = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(8),
                           dtype=torch.int32)
    ref = _serve(cfg, params, prompt, 3)
    before = dict(fa.LAUNCHES)
    got = _serve(cfg, tree_map(lambda t: t.to(dev), params), prompt.to(dev),
                 3)
    assert fa.LAUNCHES["flash_attention_l2r"] == \
        before["flash_attention_l2r"] + cfg.n_layers
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"]
    d = torch.stack([(a.cpu() - b).abs().amax(-1) for a, b in zip(got, ref)])
    mag = torch.stack([b.abs().amax(-1) for b in ref])
    assert (d <= 0.05 * mag).all(), d / mag
    assert (d <= 1e-4).float().mean() >= 0.5, d


# ------------------------------------------- slice 9: the rest of serving
LM_HEAD_K, LM_HEAD_N = 576, 49152  # SmolLM-135M's tied head


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [None, 5])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_b2_at_the_lm_head_shapes(dev, m, levels):
    """B2 on the head cache's layout (window-padded, pre-shifted, K-major;
    its D-plane view has an N stride of (2D-1)·K and is read in place)
    equals its plain version bit for bit at K = 576, N = 49152."""
    from repro_torch.core.quant import PlaneOperands

    a, b = _ints(dev, m, LM_HEAD_K, LM_HEAD_N, 8, seed=m)
    sa = stack_planes_lhs(a)
    view = PlaneOperands.prepare_rhs(b, shifted=True, window_pad=True,
                                     k_major=True).core_stack(True)
    assert view.stride() == (1, 7 * LM_HEAD_K)
    bt, ldb = kernel._k_major(view)
    assert bt.data_ptr() == view.data_ptr() and ldb == 7 * LM_HEAD_K
    before = kernel.LAUNCHES["l2r_streaming_gemm"]
    got = kernel.l2r_gemm_streaming_planes(sa, view, levels=levels)
    assert kernel.LAUNCHES["l2r_streaming_gemm"] == before + 1
    ref = kernel.l2r_gemm_streaming_planes_plain(sa, stack_planes_rhs(b),
                                                 levels=levels)
    assert got.shape == ref.shape == (7 if levels is None else 5, m,
                                      LM_HEAD_N)
    assert torch.equal(got, ref)


def _prepared_smoke(dev):
    from repro_torch.models.common import tree_map
    from repro_torch.serve.engine import prepare_params

    cfg, params = _smoke_lm(True)
    return cfg, prepare_params(cfg, tree_map(lambda t: t.to(dev), params))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [False, True])
@pytest.mark.parametrize("levels", [None, 5])
def test_progressive_head_on_card(dev, levels, policy):
    """The streamed head on the card: the scan is one B2 launch with the
    one-shot head's logits and argmax; early exit commits the same tokens
    at the same levels with one B1 launch per level walked; all of it
    equal to the same call on the CPU."""
    import dataclasses

    from repro_torch.core.policy import LevelPolicy, PrecisionClass
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import logits_from_hidden
    from repro_torch.serve.engine import (prepare_params,
                                          progressive_logits_from_hidden)

    cfg, params = _smoke_lm(True)
    cfg = dataclasses.replace(cfg, l2r_levels=levels)
    cpu = prepare_params(cfg, params)
    card = prepare_params(cfg, tree_map(lambda t: t.to(dev), params))
    g = torch.Generator().manual_seed(21)
    hidden = torch.randn((8, 1, 96), generator=g) \
        * torch.rand((8, 1, 1), generator=g) * 4
    pol = LevelPolicy.from_classes(
        [PrecisionClass.exact(), PrecisionClass.budget(3),
         PrecisionClass.bounded(), PrecisionClass.bounded(0.01)] * 2) \
        if policy else None
    b1, b2 = "l2r_stacked_gemm", "l2r_streaming_gemm"
    n0 = dict(kernel.LAUNCHES)
    scan = progressive_logits_from_hidden(cfg, card, hidden.to(dev),
                                          policy=pol)
    assert kernel.LAUNCHES[b2] == n0[b2] + 1 and kernel.LAUNCHES[b1] == n0[b1]
    assert torch.equal(scan[0], logits_from_hidden(cfg, card, hidden.to(dev)))
    if pol is None:  # budget rows commit their truncated prefix's argmax
        assert torch.equal(scan[1], scan[0].argmax(-1).int())
    n0 = dict(kernel.LAUNCHES)
    early = progressive_logits_from_hidden(cfg, card, hidden.to(dev),
                                           early_exit=True, policy=pol)
    assert kernel.LAUNCHES[b2] == n0[b2]
    assert kernel.LAUNCHES[b1] == n0[b1] + int(early[2].max()) + 1
    assert torch.equal(early[1], scan[1]) and torch.equal(early[2], scan[2])
    for ee, got in ((False, scan), (True, early)):
        ref = progressive_logits_from_hidden(cfg, cpu, hidden, early_exit=ee,
                                             policy=pol)
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("attn_l2r", [False, True])
def test_bucketed_prefill_state_equals_unbucketed_on_card(dev, attn_l2r):
    """On the card (B1 under every dense; B5, or B4 with attn_l2r, walking
    64-key tiles) a right-padded prompt's cache equals the unpadded
    prefill's at every real slot of every layer bit for bit, and so do
    the logits and the streamed first token.  Both calls hold at least 16
    rows: below that PyTorch's row reduction (rms_norm's mean) gives each
    row more threads, and sums in another order."""
    import dataclasses

    from repro_torch.serve.engine import (make_bucket_prefill_step,
                                          make_prefill_step)

    cfg, params = _prepared_smoke(dev)
    if attn_l2r:
        cfg = dataclasses.replace(cfg, attn_l2r=QuantConfig())
    g = torch.Generator().manual_seed(22)
    lengths, lb = (16, 23, 40), 64
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g,
                             dtype=torch.int32) for n in lengths]
    tokens = torch.zeros((4, lb), dtype=torch.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    true_len = torch.tensor([*lengths, 1], dtype=torch.int32, device=dev)
    st_b, lg_b, tok_b, lv_b = make_bucket_prefill_step(
        cfg, 96, torch.float32, progressive=True)(params, tokens.to(dev),
                                                  true_len)
    plain = make_prefill_step(cfg, 96, torch.float32, progressive=True)
    for i, p in enumerate(prompts):
        st_u, lg_u, tok_u, lv_u = plain(params, {"tokens": p[None].to(dev)})
        n = len(p)
        assert torch.equal(lg_b[i], lg_u[0])
        assert int(tok_b[i, 0]) == int(tok_u[0, 0])
        assert int(lv_b[i, 0]) == int(lv_u[0, 0])
        cb, cu = st_b.stack[0], st_u.stack[0]
        for name in ("k", "v", "k_planes", "k_scale"):
            a, b = getattr(cb, name), getattr(cu, name)
            if a is not None:
                assert torch.equal(a[:, i, :n], b[:, 0, :n]), name
        assert torch.equal(cb.positions[:, i], cu.positions[:, 0])


@pytest.mark.cuda
def test_batcher_and_gateway_on_card_keep_the_state_storage(dev):
    """The decode steps of the batcher and the gateway update the slot
    state in place on the card (both assert it), and the gateway serves
    the batcher's tokens and exit levels."""
    import numpy as np

    from repro_torch.core.policy import PrecisionClass
    from repro_torch.serve import ContinuousBatcher, Request, ServingGateway

    cfg, params = _prepared_smoke(dev)
    rng = np.random.default_rng(23)
    lengths = (16, 19, 33, 24, 30)  # >= 16 rows a prefill, as above
    classes = [PrecisionClass.exact(), PrecisionClass.budget(3),
               PrecisionClass.bounded()]

    def reqs():
        return [Request(uid=i, prompt=p, max_new_tokens=5,
                        precision=classes[i % 3])
                for i, p in enumerate(prompts)]

    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in lengths]
    eng = ContinuousBatcher(cfg, params, n_slots=3, max_len=48,
                            progressive=True, early_exit=True, device=dev)
    k0 = eng.state.stack[0].k.data_ptr()
    b_reqs = reqs()
    for r in b_reqs:
        eng.submit(r)
    eng.run()
    assert eng.state.stack[0].k.data_ptr() == k0
    gw = ServingGateway(cfg, params, n_slots=3, max_len=48,
                        progressive=True, early_exit=True, prefill_group=2,
                        device=dev)
    assert set(gw.warmup_s) == {*gw.buckets, "decode"}
    g_reqs = reqs()
    gw.run(g_reqs)
    gw.close()
    for a, b in zip(b_reqs, g_reqs):
        assert a.output == b.output and a.exit_levels == b.exit_levels
        assert a.prefill_exit_level == b.prefill_exit_level


@pytest.mark.cuda
def test_prepared_checkpoint_round_trip_onto_the_card(dev, tmp_path):
    """A prepared tree saved on the CPU loads onto the card in the port's
    layouts (pre-shifted, K-major plane stacks) equal bit for bit to the
    tree prepared on the card, and serves the same tokens."""
    import numpy as np

    from repro_torch.checkpoint import load_prepared, save_prepared
    from repro_torch.checkpoint.manager import _leaves
    from repro_torch.core.quant import PlaneOperands
    from repro_torch.serve import ContinuousBatcher, Request
    from repro_torch.serve.engine import prepare_params

    cfg, params = _smoke_lm(True)
    path = str(tmp_path / "prep.npz")
    save_prepared(prepare_params(cfg, params), path)
    _, live = _prepared_smoke(dev)
    loaded = load_prepared(cfg, params, path, device=dev)
    for (k, a), (_, b) in zip(_leaves(live), _leaves(loaded)):
        if isinstance(a, PlaneOperands):
            assert a.stack.stride() == b.stack.stride(), k
            a, b = a.stack, b.stack
        assert b.device.type == "cuda" and torch.equal(a, b), k
    prompt = np.arange(1, 12, dtype=np.int32)

    def serve(tree):
        eng = ContinuousBatcher(cfg, tree, n_slots=1, max_len=24,
                                progressive=True, device=dev)
        req = Request(uid=0, prompt=prompt, max_new_tokens=6)
        eng.submit(req)
        eng.run()
        return req.output, req.exit_levels

    assert serve(live) == serve(loaded)


# ------------------------------------------------ slice 10: the other mixers
WHISPER_B5 = [  # (sq, skv, h, kvh, dh, causal): whisper-base's B5 calls
    (1500, 1500, 8, 8, 64, False),  # the encoder's self-attention
    (128, 1500, 8, 8, 64, False),  # the prefill's cross-attention
    (1, 1500, 8, 8, 64, False),  # a decode step's cross-attention
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WHISPER_B5)
def test_b5_at_whisper_shapes(dev, case, dtype):
    """Skv = 1500 is no multiple of B5's 64-key tile; Sq = 1 is a decode
    step's cross-attention."""
    q, k, v = _qkv(dev, case, dtype, seed=3)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=case[5])
    assert fa.LAUNCHES["flash_attention"] == before + 1
    _close(got, fa.flash_attention_kernel_plain(q, k, v, case[5]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b5_at_deepseek_prefill_shape(dev, dtype):
    """deepseek-moe-16b's prefill attention: causal, S 2048, 16 heads of
    128 (B5's widest head), no GQA."""
    case = (2048, 2048, 16, 16, 128, True)
    q, k, v = _qkv(dev, case, dtype, seed=4)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=True)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    _close(got, fa.flash_attention_kernel_plain(q, k, v, True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 1920])
@pytest.mark.parametrize("k,n", [(2048, 2816), (1408, 2048)])
def test_b1_at_routed_expert_shapes(dev, m, k, n):
    """deepseek-moe-16b's expert matmuls (M = the capacity: 8 a decode
    step, 1920 a prefill of 8 x 2048), the weight quantized inside the
    call: l2r_matmul_f on the card equals the same call on the CPU bit
    for bit (one B1 launch), empty capacity rows included."""
    g = torch.Generator().manual_seed(m + k)
    x = torch.randn((m, k), generator=g).to(torch.bfloat16)
    x[m // 2:] = 0
    w = torch.randn((k, n), generator=g) / k ** 0.5
    ref = ops.l2r_matmul_f(x, w, QuantConfig())
    before = kernel.LAUNCHES["l2r_stacked_gemm"]
    got = ops.l2r_matmul_f(x.to(dev), w.to(dev), QuantConfig())
    assert kernel.LAUNCHES["l2r_stacked_gemm"] == before + 1
    assert torch.equal(got.cpu(), ref)


def _moe_layer(dev):
    """deepseek-moe-16b's MoE layer at full width (64 experts, top-6, 2
    shared, d 2048, expert hidden 1408), seeded, on ``dev``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.common import materialize
    from repro_torch.models.moe import moe_build

    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              l2r=QuantConfig())
    params = materialize(moe_build(cfg), torch.Generator(device=dev)
                         .manual_seed(4), device=dev)
    return cfg, params


@pytest.mark.cuda
def test_moe_layer_on_card_is_deterministic_and_routes_as_cpu(dev):
    """Two runs of a MoE layer on the card give identical bits (no atomic
    scatter-add), and its routing integers on bf16-rounded logits (ties
    included) equal the CPU's."""
    from repro_torch.models.moe import moe_apply, moe_capacity, moe_route

    cfg, params = _moe_layer(dev)
    x = torch.randn((8, 64, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5)
                    ).to(torch.bfloat16)
    a = moe_apply(cfg, params, x)
    b = moe_apply(cfg, params, x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.isfinite(a[0].float()).all()
    lg = torch.randn((16384, 64), generator=torch.Generator().manual_seed(6))
    lg[:, :4] += 2.0  # four favoured experts: past the capacity
    lg = (lg * 0.5).to(torch.bfloat16).float()
    cap = moe_capacity(cfg, 16384)
    got = moe_route(cfg, lg.to(dev), cap)
    ref = moe_route(cfg, lg, cap)
    for g_, r_ in zip(got[2:], ref[2:]):
        assert torch.equal(g_.cpu(), r_)
    assert not ref[4].all()  # a capacity of 1920 drops some assignments


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 7, 2048])
def test_rglru_scan_on_card_equals_cpu_bits(dev, s):
    from repro_torch.models.rglru import lru_scan

    g = torch.Generator().manual_seed(s)
    a = torch.rand((4, s, 256), generator=g) * 0.999 + 0.001
    b = torch.randn((4, s, 256), generator=g)
    ra, rb = lru_scan(a, b)
    ga, gb = lru_scan(a.to(dev), b.to(dev))
    assert torch.equal(ga.cpu(), ra) and torch.equal(gb.cpu(), rb)


# ---------------------------------------------------- slice 11: training
C2_CASES = [  # (q shape, kv shape, kwargs): C2's smallest input first
    ((1, 8, 1, 64), (1, 8, 1, 64), {}),
    ((2, 40, 4, 16), (2, 40, 2, 16), {"window": 9})]
# gradients on the card against the CPU's: the same plain loop in another
# summation order (f32), or with p rounding to bf16 the other way (bf16)
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


def _attn_grads(q, k, v, w, **kw):
    from repro_torch.models.attention import chunked_attention

    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = chunked_attention(*xs, **kw)
    return out, torch.autograd.grad((out.float() * w).sum(), xs)


@pytest.mark.cuda
@pytest.mark.parametrize("l2r", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", C2_CASES)
def test_attention_kernels_carry_the_plain_gradient(dev, case, dtype, l2r):
    """Fault C2, pinned: on the card the output of kernel B5 (B4 with
    ``l2r``) has a gradient, and it equals the CPU's plain route's within
    GRAD_TOL of the largest; the kernel launched once, the backward
    launched nothing."""
    shape_q, shape_kv, kw = case
    g = torch.Generator().manual_seed(11)
    host = [torch.randn(s, generator=g).to(dtype)
            for s in (shape_q, shape_kv, shape_kv)]
    w = torch.randn(shape_q, generator=g)
    if l2r:
        kw = {**kw, "l2r": QuantConfig()}
    lib = "flash_attention_l2r" if l2r else "flash_attention"
    before = dict(fa.LAUNCHES)
    out, grads = _attn_grads(*(x.to(dev) for x in host), w.to(dev), **kw)
    assert type(out.grad_fn).__name__ == (
        "FlashAttentionL2RBackward" if l2r else "FlashAttentionBackward")
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        n: int(n == lib) for n in before}
    ref_out, ref = _attn_grads(*host, w, **kw)
    _close(out, ref_out.to(dev), dtype)
    for got, want in zip(grads, ref):
        assert got.dtype == dtype and got.device.type == "cuda"
        err = (got.cpu().float() - want.float()).abs().max().item()
        assert err <= GRAD_TOL[dtype] * want.float().abs().max().item(), err


@pytest.mark.cuda
def test_smoke_train_step_on_card_equals_cpu(dev):
    """One remat step of the smoke SmolLM on the card (B5 under every
    attention, twice a layer: forward and recompute) against the same
    step on the CPU: loss, every leaf's gradient (finite, non-zero, within
    1e-3 of its norm plus 1e-6 of the whole gradient's) and the updated
    params (within 1e-5: lr 1e-3 times an O(1) Adam ratio)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.common import (materialize, tree_leaves, tree_map,
                                           tree_unflatten)
    from repro_torch.models.transformer import lm_build
    from repro_torch.optim.adamw import AdamWConfig, OptState, global_norm
    from repro_torch.train.step import (TrainConfig, make_loss_fn,
                                        make_train_step, value_and_grad)

    cfg = get_smoke("smollm-135m")
    params = materialize(lm_build(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    g = torch.Generator().manual_seed(1)
    m = [torch.randn(p.shape, generator=g) * 1e-3
         for p in tree_leaves(params)]
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    tcfg = TrainConfig(remat=True, xent_chunk=8)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2), tcfg)
    out = {}
    for d in ("cpu", dev):
        p = tree_map(lambda x: x.to(d), params)
        ms = [x.to(d) for x in m]
        opt = OptState(torch.tensor(3, dtype=torch.int32, device=d),
                       tree_unflatten(params, ms),
                       tree_unflatten(params, [x * x + 1e-6 for x in ms]))
        b = {k: v.to(d) for k, v in batch.items()}
        loss, _, grads = value_and_grad(make_loss_fn(cfg, tcfg), p, b)
        before = fa.LAUNCHES["flash_attention"]
        p2, _, metrics = step(p, opt, b)
        launched = fa.LAUNCHES["flash_attention"] - before
        out[str(d)] = (loss.item(), grads, p2, metrics, launched)
    loss_c, grads_c, p_c, met_c, n_c = out["cpu"]
    loss_d, grads_d, p_d, met_d, n_d = out[str(dev)]
    assert (n_c, n_d) == (0, 2 * cfg.n_layers)
    assert abs(loss_d - loss_c) <= 1e-5 * abs(loss_c)
    gn = global_norm(grads_c).item()
    for a, b in zip(tree_leaves(grads_d), tree_leaves(grads_c)):
        a = a.cpu()
        assert torch.isfinite(a).all() and torch.count_nonzero(a)
        assert (a - b).norm().item() <= 1e-3 * b.norm().item() + 1e-6 * gn
    for a, b in zip(tree_leaves(p_d), tree_leaves(p_c)):
        assert (a.cpu() - b).abs().max().item() <= 1e-5
    assert abs(met_d["grad_norm"].item() - met_c["grad_norm"].item()) \
        <= 1e-3 * met_c["grad_norm"].item()



def _head_operands(dev, seed: int = 22):
    """SmolLM-135M's head at batch 8 (K 576, N 49,152): row-quantized
    hidden states and the float head, seeded on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((8, 576), generator=g, device=dev)
    w = torch.randn((576, 49152), generator=g, device=dev) * 0.04
    xq, xs = quantize(x, QuantConfig(), axis=0)
    return xq, xs, w


_HEAD_CACHE = dict(prestack=True, window_pad=True, plane_shifted=True,
                   k_major=True)


def _sharded_head_walk(early_exit: bool):
    """One rank of a (1, 2) mesh on the card: its vocab half of the head
    cache, the consensus walk, and its B2 / B1 launches."""
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_local_mesh(1, 2)
    xq, xs, w = _head_operands(dev)
    cache = quantize_weights(w, QuantConfig(), shard=(None, "model"),
                             mesh=mesh, **_HEAD_CACHE)
    for name in kernel.LAUNCHES:
        kernel.LAUNCHES[name] = 0
    out = tp.streaming_argmax(xq, cache.planes, xs, cache.scale,
                              early_exit=early_exit, mesh=mesh,
                              cuda_walk=ops.CUDA_WALK)
    torch.cuda.synchronize()
    return ([t.cpu() for t in out], dict(kernel.LAUNCHES),
            cache.planes.stack.shape[1])


@pytest.mark.cuda
@pytest.mark.parametrize("early_exit", [False, True])
def test_head_walk_on_two_ranks_of_one_card(dev, early_exit):
    """Two gloo ranks on the one card, each walking its 24,576 columns of
    SmolLM-135M's head on B2 (or B1's level slabs): logits, tokens and
    exit levels equal the one-process walk's bit for bit."""
    from repro_torch.launch.mesh import spawn_local

    xq, xs, w = _head_operands(dev)
    whole = quantize_weights(w, QuantConfig(), **_HEAD_CACHE)
    ref = tp.streaming_argmax(xq, whole.planes, xs, whole.scale,
                              early_exit=early_exit, cuda_walk=ops.CUDA_WALK)
    ranks = spawn_local(2, _sharded_head_walk, early_exit, deadline_s=300)
    run = int(ref[2].max()) + 1
    for got, launches, cols in ranks:
        assert cols == 24576
        for g, r in zip(got, ref):
            assert torch.equal(g, r.cpu())
        assert launches["l2r_streaming_gemm"] == (0 if early_exit else 1)
        assert launches["l2r_stacked_gemm"] == (run if early_exit else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 96, 100, 512, 576, 768, 1536, 2048, 2560,
                               3584, 4096, 5120, 5376])
def test_decode_rows_do_not_depend_on_the_batch(dev, d):
    """rms_norm, layer_norm and decode attention give a row the same bits
    whatever the number of rows beside it (the "batch" slot layout's ranks
    decode their rows as one process does): the served widths (d_model,
    mamba2's d_inner 1536), the smoke widths and one that 32 does not
    divide."""
    from repro_torch.models.attention import decode_attention
    from repro_torch.models.common import layer_norm, rms_norm

    g = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn((16, 1, d), generator=g, device=dev) * 3
    gamma = torch.randn((d,), generator=g, device=dev)
    beta = torch.randn((d,), generator=g, device=dev)
    whole = rms_norm(x, gamma)
    whole_ln = layer_norm(x, gamma, beta)  # whisper's
    for n in (1, 2, 4, 8):
        assert torch.equal(rms_norm(x[:n].clone(), gamma), whole[:n])
        assert torch.equal(layer_norm(x[:n].clone(), gamma, beta),
                           whole_ln[:n])
    b, L, h, kv, dh = 16, 2080, 9, 3, 64
    q = torch.randn((b, 1, h, dh), generator=g, device=dev)
    k = torch.randn((b, L, kv, dh), generator=g, device=dev)
    v = torch.randn((b, L, kv, dh), generator=g, device=dev)
    pos = torch.arange(L, device=dev, dtype=torch.int32).expand(b, L)
    qpos = torch.full((b,), L - 1, device=dev, dtype=torch.int32)
    whole = decode_attention(q, k, v, pos.contiguous(), qpos)
    for n in (1, 3, 4, 8, 9):
        got = decode_attention(q[:n].clone(), k[:n].clone(), v[:n].clone(),
                               pos[:n].contiguous(), qpos[:n].clone())
        assert torch.equal(got, whole[:n])


# the head counts of the tensor-parallel runs (chip_smoke.py phase 20):
# (q heads, kv heads, dh) whole and a rank's
TP_HEADS = [((9, 3, 64), (3, 1, 64)),     # SmolLM-135M at model 3
            ((16, 16, 128), (8, 8, 128))]  # deepseek-moe-16b at model 2


@pytest.mark.cuda
@pytest.mark.parametrize("whole,part", TP_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b5_per_head_bits_do_not_depend_on_the_heads_beside(dev, whole,
                                                             part, dtype):
    """Kernel B5 gives a rank's heads (its kv heads and their q heads)
    the bits the whole call gives them: one block per (batch x head, q
    tile), whatever the heads beside."""
    (h, kv, dh), (hp, kvp, _) = whole, part
    g = torch.Generator(device=dev).manual_seed(31)
    b, s = 2, 320
    q = torch.randn((b, s, h, dh), generator=g, device=dev).to(dtype)
    k = torch.randn((b, s, kv, dh), generator=g, device=dev).to(dtype)
    v = torch.randn((b, s, kv, dh), generator=g, device=dev).to(dtype)
    full = fa.flash_attention(q, k, v, causal=True)
    for j in range(h // hp):
        got = fa.flash_attention(q[:, :, j * hp:(j + 1) * hp].contiguous(),
                                 k[:, :, j * kvp:(j + 1) * kvp].contiguous(),
                                 v[:, :, j * kvp:(j + 1) * kvp].contiguous(),
                                 causal=True)
        assert torch.equal(got, full[:, :, j * hp:(j + 1) * hp]), j


@pytest.mark.cuda
@pytest.mark.parametrize("whole,part", TP_HEADS)
@pytest.mark.parametrize("b", [4, 8])
def test_decode_heads_do_not_depend_on_the_heads_beside(dev, whole, part, b):
    """Decode attention (its two products on fixed blocks of (row, kv
    head) pairs, models/attention.py:_fixed_pairs) gives a rank's heads,
    told the whole model's kv heads, the bits one process gives them."""
    from repro_torch.models.attention import decode_attention

    (h, kv, dh), (hp, kvp, _) = whole, part
    g = torch.Generator(device=dev).manual_seed(37)
    L = 2080
    q = torch.randn((b, 1, h, dh), generator=g, device=dev)
    k = torch.randn((b, L, kv, dh), generator=g, device=dev)
    v = torch.randn((b, L, kv, dh), generator=g, device=dev)
    pos = torch.arange(L, device=dev, dtype=torch.int32).expand(b, L) \
        .contiguous()
    qpos = torch.full((b,), L - 5, device=dev, dtype=torch.int32)
    full = decode_attention(q, k, v, pos, qpos)
    for j in range(h // hp):
        got = decode_attention(
            q[:, :, j * hp:(j + 1) * hp].contiguous(),
            k[:, :, j * kvp:(j + 1) * kvp].contiguous(),
            v[:, :, j * kvp:(j + 1) * kvp].contiguous(), pos, qpos,
            kv_whole=kv)
        assert torch.equal(got, full[:, :, j * hp:(j + 1) * hp]), j


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,ranks", [(8, 576, 576, 3), (40, 1536, 576, 3),
                                         (16, 2048, 1024, 2)])
def test_k_split_b1_partials_sum_to_the_whole_product(dev, m, k, n, ranks):
    """Kernel B1 on each rank's K-slice (the row-parallel products of
    phase 20), the int32 partials summed in int64 and narrowed
    (sharding/collectives.py:sum_int's arithmetic): the whole product at
    every ``levels``."""
    from repro_torch.core.l2r_gemm import wrap_int32

    a, bw = _ints(dev, m, k, n, 8, seed=41)
    kl = k // ranks
    for lv in _levels(8, 2):
        whole = kernel.l2r_gemm_stacked_planes(
            stack_planes_lhs(a), stack_planes_rhs(bw), levels=lv)
        parts = [kernel.l2r_gemm_stacked_planes(
            stack_planes_lhs(a[:, j * kl:(j + 1) * kl].contiguous()),
            stack_planes_rhs(bw[j * kl:(j + 1) * kl].contiguous()),
            levels=lv) for j in range(ranks)]
        total = sum(p.to(torch.int64) for p in parts)
        assert torch.equal(wrap_int32(total), whole), lv


# ------------------------------------------------ the rest of the tp mesh
# (whole heads, a rank's heads) of the SSD products: mamba2-130m's 24
# heads over a model axis of 2 and 4
SSD_HEADS = [(24, 12), (24, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("whole,part", SSD_HEADS)
@pytest.mark.parametrize("b,s,rows", [(8, 2048, 4), (1, 256, 1),
                                      (8, 256, 8)])
def test_ssd_head_block_products_give_a_rank_the_whole_calls_bits(
        dev, whole, part, b, s, rows):
    """The SSD's chunk products and decode readout on fixed calls of 8
    rows of the whole model's heads (models/ssm.py, common.py:fixed_bmm):
    a rank's heads of its rows (the data split) equal those of the whole
    call bit for bit.  The plain einsums did not at a one-row 256-token
    prefill and at the 8-row decode readout on this card."""
    import torch.nn.functional as F

    from repro_torch.models import ssm

    g = torch.Generator(device=dev).manual_seed(51)
    p, n, q = 64, 128, 256
    x = torch.randn((b, s, whole, p), generator=g, device=dev)
    dt = F.softplus(torch.randn((b, s, whole), generator=g, device=dev))
    a = -dt * 0.5
    bb = torch.randn((b, s, n), generator=g, device=dev)
    cc = torch.randn((b, s, n), generator=g, device=dev)
    y, st = ssm.ssd_chunked(x, dt, a, bb, cc, q, whole)
    st_in = torch.randn((b, whole, n, p), generator=g, device=dev)
    c1 = torch.randn((b, n), generator=g, device=dev)
    read = ssm.ssd_readout(c1, st_in, whole)
    for r0 in range(0, b, rows):
        r = slice(r0, r0 + rows)
        for j in range(whole // part):
            h = slice(j * part, (j + 1) * part)
            yj, sj = ssm.ssd_chunked(
                x[r, :, h].contiguous(), dt[r, :, h].contiguous(),
                a[r, :, h].contiguous(), bb[r], cc[r], q, whole, j * part)
            assert torch.equal(yj, y[r, :, h]), (r0, j)
            assert torch.equal(sj, st[r, h]), (r0, j)
            assert torch.equal(ssm.ssd_readout(c1[r], st_in[r, h].contiguous(),
                                               whole), read[r, h]), (r0, j)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("rows", [1, 4, 8, 2048, 16384])
@pytest.mark.parametrize("d", [128, 1536, 2560])
def test_split_gated_norm_is_the_whole_norm(dev, m, rows, d):
    """The split gated RMSNorm's mean (models/common.py:split_row_mean on
    the card): each rank's 32 / m partial sums, gathered in rank order
    and summed, equal :func:`_row_mean` of the whole rows bit for bit."""
    from repro_torch.models.common import (_row_mean, row_mean_of_parts,
                                           row_mean_parts)

    g = torch.Generator(device=dev).manual_seed(53)
    x = torch.randn((rows, 1, d), generator=g, device=dev) ** 2
    dl = d // m
    parts = torch.cat([row_mean_parts(x[..., j * dl:(j + 1) * dl]
                                      .contiguous(), m)
                       for j in range(m)], -1)
    assert torch.equal(row_mean_of_parts(parts, d), _row_mean(x))


@pytest.mark.cuda
@pytest.mark.parametrize("l2r", [False, True])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("h,kv,dh,L", [(9, 3, 64, 2080), (10, 1, 256, 2048),
                                       (3, 1, 32, 17)])
def test_head_dim_decode_is_the_whole_heads_slice(dev, l2r, m, h, kv, dh, L):
    """Decode attention in the head_dim layout (every kv head, the whole
    keys, a rank's dh / m of the values; PV at the whole width,
    models/attention.py:_fixed_pairs ``cols``) gives each rank's slice of
    every head the bits of the whole heads' call."""
    from repro_torch.core.quant import QuantConfig as QC
    from repro_torch.models.attention import (decode_attention,
                                              init_kv_cache,
                                              update_kv_cache)

    g = torch.Generator(device=dev).manual_seed(59)
    b = 8
    quant = QC() if l2r else None
    q = torch.randn((b, 1, h, dh), generator=g, device=dev)
    k = torch.randn((b, L, kv, dh), generator=g, device=dev)
    v = torch.randn((b, L, kv, dh), generator=g, device=dev)
    pos = torch.arange(L, device=dev, dtype=torch.int32).expand(b, L)
    cache = init_kv_cache(b, L, kv, dh, torch.float32, quant=quant,
                          device=dev)
    cache = update_kv_cache(cache, k, v, pos.contiguous(), quant=quant)
    qpos = torch.full((b,), L - 5, device=dev, dtype=torch.int32)
    kw = dict(l2r=quant, k_planes=cache.k_planes, k_scale=cache.k_scale,
              kv_whole=kv)
    full = decode_attention(q, cache.k, cache.v, cache.positions, qpos, **kw)
    vd = dh // m
    for j in range(m):
        got = decode_attention(q, cache.k,
                               cache.v[..., j * vd:(j + 1) * vd].contiguous(),
                               cache.positions, qpos, v_cols=(j * vd, dh),
                               **kw)
        assert torch.equal(got, full[..., j * vd:(j + 1) * vd]), j


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,causal", [(1500, 1500, False),
                                           (128, 128, True),
                                           (128, 1500, False),
                                           (1, 1500, False)])
def test_b5_on_whisper_rank_heads(dev, m, dtype, sq, skv, causal):
    """Kernel B5 on a rank's heads of whisper-base (8 heads of 64: the
    encoder, the causal self-attention, the cross-attention at prefill
    and at decode) equals those heads of the whole call bit for bit."""
    g = torch.Generator(device=dev).manual_seed(61)
    q = torch.randn((4, sq, 8, 64), generator=g, device=dev).to(dtype)
    k = torch.randn((4, skv, 8, 64), generator=g, device=dev).to(dtype)
    v = torch.randn((4, skv, 8, 64), generator=g, device=dev).to(dtype)
    full = fa.flash_attention(q, k, v, causal=causal)
    hl = 8 // m
    for j in range(m):
        h = slice(j * hl, (j + 1) * hl)
        got = fa.flash_attention(q[:, :, h].contiguous(),
                                 k[:, :, h].contiguous(),
                                 v[:, :, h].contiguous(), causal=causal)
        assert torch.equal(got, full[:, :, h]), j


# ------------------------------------------------ the exactness audit
def _cuda_entries():
    from repro_torch.analysis.registry import iter_entries
    return [e.name for e in iter_entries() if e.device == "cuda"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _cuda_entries())
def test_cuda_registry_entry_audits_clean_as_one_node(dev, name):
    """Each ``cuda`` entry of analysis/registry.py on the card: zero
    violations, its kernel seen as exactly one node (B1 for stacked, B2
    for streaming), the result equal to the entry's CPU run bit for
    bit, and the kernel hook unset afterwards."""
    from repro_torch.analysis.exactness import audit_exactness
    from repro_torch.analysis.registry import iter_entries
    from repro_torch.kernels import _build

    e = next(x for x in iter_entries() if x.name == name)
    fn, args = e.build(device="cuda")
    rep = audit_exactness(fn, args, e.contract, entry=name)
    assert rep.ok, [v.to_json() for v in rep.violations]
    want = "l2r_stacked_gemm" if "stacked" in name else "l2r_streaming_gemm"
    assert rep.kernel_nodes == {want: 1}
    cpu_fn, cpu_args = e.build(device="cpu")
    assert torch.equal(rep.output.cpu(), cpu_fn(*cpu_args))
    assert _build.AUDIT is None


@pytest.mark.cuda
def test_pairs_schedule_on_the_card_is_one_b3_node(dev):
    import dataclasses

    from repro_torch.analysis.exactness import audit_exactness
    from repro_torch.analysis.registry import iter_entries

    e = next(x for x in iter_entries() if x.name == "gemm/pairs/cpu")
    fn, args = e.build(device="cuda")
    rep = audit_exactness(fn, args,
                          dataclasses.replace(e.contract, mode="kernel-int"))
    assert rep.ok and rep.kernel_nodes == {"l2r_pairs_gemm": 1}


@pytest.mark.cuda
def test_f32_product_with_tf32_allowed_is_flagged_on_the_card(dev):
    """An f32 product of int8 digits on the card with TF32 allowed is
    not bit-exact: flagged; with TF32 off (repro_torch.device.no_tf32)
    the same product is the guarded fast path."""
    from repro_torch.analysis.exactness import (ExactnessContract,
                                                audit_exactness)
    from repro_torch.device import no_tf32
    from repro_torch.kernels import _build

    a, b = _ints(dev, 16, 64, 32, 8)

    def walk(x, y):
        return (x.to(torch.float32) @ y.to(torch.float32)).to(torch.int32)

    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        rep = audit_exactness(walk, (a, b), ExactnessContract(k=64))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert not rep.ok and "TF32" in rep.violations[0].reason
    with no_tf32():
        assert audit_exactness(walk, (a, b), ExactnessContract(k=64)).ok
    assert _build.AUDIT is None


def _launch_counts():
    return {**kernel.LAUNCHES, **fa.LAUNCHES, **msdf_ipu.LAUNCHES}


def _launched(before):
    return {k: v - before[k] for k, v in _launch_counts().items()
            if v != before[k]}


@pytest.mark.cuda
def test_each_kernel_op_launches_as_its_wrapper(dev):
    """Inside a capture every wrapper calls its kernel as its custom op:
    one graph node each, launching the same kernel once on the card (the
    traced run), with the eager call's bits; the replay launches again."""
    from repro_torch.launch import graph_analysis as ga

    sa, sb = _stacks(dev, 70, 64, 40, 8, 2)
    a, b = _ints(dev, 33, 96, 50, 8, seed=3)
    q = torch.randn((2, 70, 6, 32), device=dev)
    k = torch.randn((2, 70, 2, 32), device=dev)
    v = torch.randn((2, 70, 2, 32), device=dev)
    ua = torch.randint(0, 256, (300, 72), device=dev, dtype=torch.int32)
    ub = torch.randint(0, 256, (300, 72), device=dev, dtype=torch.int32)
    cases = [
        ("l2r_stacked_gemm", kernel.l2r_gemm_stacked_planes, (sa, sb)),
        ("l2r_streaming_gemm", kernel.l2r_gemm_streaming_planes, (sa, sb)),
        ("l2r_pairs_gemm", kernel.l2r_gemm_pairs, (a, b)),
        ("flash_attention_l2r", fa.flash_attention_l2r, (q, k, v)),
        ("flash_attention", fa.flash_attention_kernel, (q, k, v)),
        ("cipu_array", msdf_ipu.simulate_pe_array, (ua, ub)),
    ]
    for lib, fn, args in cases:
        ref = fn(*args)
        before = _launch_counts()
        cap = ga.capture(fn, args)
        assert _launched(before) == {lib: 1}, lib
        assert ga.kernel_nodes(ga.to_records(cap.gm)) == {lib: 1}, lib
        assert torch.equal(cap.output, ref), lib
        before = _launch_counts()
        assert torch.equal(cap(*args), ref), lib
        assert _launched(before) == {lib: 1}, lib


@pytest.mark.cuda
def test_each_wide_route_op_launches_as_its_wrapper(dev):
    """The same on the wide routes: int16 planes through B1, B2 and B3
    (n_bits 12, radix 16), B4 on int16 q, k, and B5 and B4 at dh 256; the
    ops take the new dtypes and widths."""
    from repro_torch.launch import graph_analysis as ga

    sa, sb = _stacks(dev, 70, 64, 40, 12, 4)
    a, b = _ints(dev, 33, 96, 50, 12, seed=3)
    q = torch.randn((2, 70, 4, 256), device=dev)
    k = torch.randn((2, 70, 2, 256), device=dev)
    v = torch.randn((2, 70, 2, 256), device=dev)
    cases = [
        ("l2r_stacked_gemm",
         lambda x, y: kernel.l2r_gemm_stacked_planes(x, y, 12, 4), (sa, sb)),
        ("l2r_streaming_gemm",
         lambda x, y: kernel.l2r_gemm_streaming_planes(x, y, 12, 4),
         (sa, sb)),
        ("l2r_pairs_gemm", lambda x, y: kernel.l2r_gemm_pairs(x, y, 12, 4),
         (a, b)),
        ("flash_attention_l2r",
         lambda x, y, z: fa.flash_attention_l2r(x, y, z, 12, 4),
         (q[..., :64].contiguous(), k[..., :64].contiguous(),
          v[..., :64].contiguous())),
        ("flash_attention_l2r", fa.flash_attention_l2r, (q, k, v)),
        ("flash_attention", fa.flash_attention_kernel, (q, k, v)),
    ]
    for lib, fn, args in cases:
        ref = fn(*args)
        before = _launch_counts()
        cap = ga.capture(fn, args)
        assert _launched(before) == {lib: 1}, lib
        assert ga.kernel_nodes(ga.to_records(cap.gm)) == {lib: 1}, lib
        assert torch.equal(cap.output, ref), lib
        before = _launch_counts()
        assert torch.equal(cap(*args), ref), lib
        assert _launched(before) == {lib: 1}, lib


@pytest.mark.cuda
def test_captured_smoke_steps_replay_bit_for_bit(dev):
    """The smoke SmolLM's l2r prefill and decode step captured on the
    card: kernel nodes equal the eager launches, and the replayed graphs
    give the eager steps' logits, caches and state bit for bit."""
    import dataclasses

    from repro_torch.analysis.exactness import tensors_of
    from repro_torch.configs import get_smoke
    from repro_torch.launch import graph_analysis as ga
    from repro_torch.models.common import materialize
    from repro_torch.models.transformer import lm_build
    from repro_torch.serve.batching import _map
    from repro_torch.serve.engine import (make_decode_step,
                                          make_prefill_step, prepare_params)

    cfg = dataclasses.replace(get_smoke("smollm-135m"), l2r=QuantConfig())
    params = prepare_params(cfg, materialize(
        lm_build(cfg), torch.Generator(device=dev).manual_seed(5),
        device=dev))
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 64), device=dev,
                                     dtype=torch.int32)}
    prefill = make_prefill_step(cfg, 72, torch.float32)
    decode = make_decode_step(cfg)
    with torch.no_grad():
        state, logits = prefill(params, batch)
        tok = torch.argmax(logits, -1).to(torch.int32)
        fresh = lambda: _map(torch.clone, state)  # noqa: E731
        for fn, args in ((prefill, lambda: (params, batch)),
                         (decode, lambda: (params, fresh(), tok))):
            before = _launch_counts()
            ref = fn(*args())
            eager = _launched(before)
            cap = ga.capture(fn, args())
            assert ga.kernel_nodes(ga.to_records(cap.gm)) == eager
            before = _launch_counts()
            got = cap(*args())
            assert _launched(before) == eager
            assert all(torch.equal(x, y) for x, y in
                       zip(tensors_of(ref), tensors_of(got), strict=True))
