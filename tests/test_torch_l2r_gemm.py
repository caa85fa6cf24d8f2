"""Port parity: the L2R GEMM schedules and kernel B1's plain version
(repro_torch.core.l2r_gemm / kernels.l2r_gemm against repro's), bit for
bit over n_bits x radix x every ``levels`` truncation, ragged shapes.

Kernel B1 itself (CUDA) cannot run on a host without a card:
tests/test_torch_cuda.py holds it against its plain version there, and
``chip_smoke.py`` does so at every VGG-16 shape."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import l2r_gemm as jg
from repro.core.quant import stack_planes_lhs as j_lhs
from repro.core.quant import stack_planes_rhs as j_rhs
from repro.kernels.l2r_gemm import kernel as jk
from repro.kernels.l2r_gemm import ops as jops
from repro_torch.core import l2r_gemm as tg
from repro_torch.core.quant import PlaneOperands
from repro_torch.core.quant import stack_planes_lhs as t_lhs
from repro_torch.core.quant import stack_planes_rhs as t_rhs
from repro_torch.kernels.l2r_gemm import kernel as tk
from repro_torch.kernels.l2r_gemm import ops as tops
from repro_torch.kernels.l2r_gemm import ref as tref

CONFIGS = [(4, 1), (4, 2), (4, 4), (8, 1), (8, 2), (8, 4), (16, 4)]


def _ints(rng, n_bits, shape, lim=None):
    hi = (1 << (n_bits - 1)) if lim is None else lim
    dt = np.int8 if n_bits <= 8 else np.int16
    return rng.integers(-hi, hi, shape).astype(dt)


def _operands(n_bits, log2_radix, seed=0, m=5, k=19, n=7):
    rng = np.random.default_rng(seed + 100 * n_bits + log2_radix)
    # 16-bit operands stay small enough that nothing wraps here; the
    # wrapping case has its own test
    lim = 200 if n_bits > 8 else None
    return _ints(rng, n_bits, (m, k), lim), _ints(rng, n_bits, (k, n), lim)


def _levels(n_bits, log2_radix):
    return [None] + list(range(2 * (n_bits // log2_radix)))


@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
def test_pair_loop_and_stacked_bit_identical(n_bits, log2_radix):
    a, b = _operands(n_bits, log2_radix)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for lv in _levels(n_bits, log2_radix):
        ref = np.asarray(jg.l2r_matmul_int(a, b, n_bits, log2_radix, lv))
        for fn in (tg.l2r_matmul_int, tg.l2r_matmul_int_stacked,
                   tref.l2r_gemm_ref, tref.l2r_gemm_ref_stacked):
            got = fn(ta, tb, n_bits, log2_radix, lv)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), ref,
                                          err_msg=f"{fn.__name__} {lv}")
    np.testing.assert_array_equal(tref.int_gemm_ref(ta, tb).numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("shifted", [True, False])
@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
def test_stacked_gemm_planes_bit_identical(n_bits, log2_radix, shifted):
    a, b = _operands(n_bits, log2_radix, seed=1)
    k = a.shape[1]
    ja = j_lhs(jnp.asarray(a), n_bits, log2_radix, shifted=shifted)
    jb = j_rhs(jnp.asarray(b), n_bits, log2_radix, shifted=shifted)
    ts = t_lhs(torch.from_numpy(a), n_bits, log2_radix, shifted=shifted)
    tb = t_rhs(torch.from_numpy(b), n_bits, log2_radix, shifted=shifted)
    for lv in _levels(n_bits, log2_radix):
        ref = np.asarray(jg.stacked_gemm_planes(ja, jb, k, n_bits, log2_radix,
                                                lv, shifted=shifted))
        got = tg.stacked_gemm_planes(ts, tb, k, n_bits, log2_radix, lv,
                                     shifted=shifted)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(lv))


def test_stacked_gemm_planes_batched_lhs():
    a = _ints(np.random.default_rng(2), 8, (2, 3, 11))
    b = _ints(np.random.default_rng(3), 8, (11, 4))
    ref = np.asarray(jg.stacked_gemm_planes(
        j_lhs(jnp.asarray(a), 8, 2, shifted=False),
        j_rhs(jnp.asarray(b), 8, 2, shifted=False), 11, 8, 2, 5,
        shifted=False))
    got = tg.stacked_gemm_planes(t_lhs(torch.from_numpy(a), 8, 2,
                                       shifted=False),
                                 t_rhs(torch.from_numpy(b), 8, 2,
                                       shifted=False),
                                 11, 8, 2, 5, shifted=False)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
def test_kernel_plain_version_bit_identical(n_bits, log2_radix):
    """B1's plain version (the CPU route of the wrapper) against the
    reference's level-stacked schedule on pre-shifted stacks, and its
    ``out=`` accumulation."""
    a, b = _operands(n_bits, log2_radix, seed=2, m=6, k=3, n=9)
    k = a.shape[1]
    ts = t_lhs(torch.from_numpy(a), n_bits, log2_radix)
    tb = t_rhs(torch.from_numpy(b), n_bits, log2_radix)
    ja = j_lhs(jnp.asarray(a), n_bits, log2_radix)
    jb = j_rhs(jnp.asarray(b), n_bits, log2_radix)
    for lv in _levels(n_bits, log2_radix):
        ref = np.asarray(jg.stacked_gemm_planes(ja, jb, k, n_bits, log2_radix,
                                                lv, shifted=True))
        for fn in (tk.l2r_gemm_stacked_planes_plain,
                   tk.l2r_gemm_stacked_planes):
            got = fn(ts, tb, n_bits, log2_radix, lv)
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(lv))
        acc = torch.full((6, 9), 5, dtype=torch.int32)
        got = tk.l2r_gemm_stacked_planes(ts, tb, n_bits, log2_radix, lv,
                                         out=acc)
        assert got is acc
        np.testing.assert_array_equal(acc.numpy(), ref + 5, err_msg=str(lv))


@pytest.mark.parametrize("levels", [None, 3])
def test_kernel_plain_version_matches_pallas_interpret(levels):
    """One block shape (128, 256, 128) through the TPU kernel in
    interpret mode — the kernel this port's B1 replaces."""
    rng = np.random.default_rng(4)
    a, b = _ints(rng, 8, (128, 256)), _ints(rng, 8, (256, 128))
    ref = np.asarray(jk.l2r_gemm_pallas_stacked_planes(
        j_lhs(jnp.asarray(a), 8, 2), j_rhs(jnp.asarray(b), 8, 2), 8, 2,
        levels, interpret=True))
    got = tk.l2r_gemm_stacked_planes(t_lhs(torch.from_numpy(a), 8, 2),
                                     t_rhs(torch.from_numpy(b), 8, 2), 8, 2,
                                     levels)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n_bits,log2_radix,k_blocks", [(8, 2, 1), (8, 2, 3),
                                                        (8, 1, 2), (4, 4, 2)])
def test_schedules_match_reference(n_bits, log2_radix, k_blocks):
    d = n_bits // log2_radix
    for lv in _levels(n_bits, log2_radix):
        for got, ref in zip(tk.stacked_schedule(d, k_blocks, lv),
                            jk.stacked_schedule(d, k_blocks, lv)):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("schedule,prestacked", [
    ("stacked", "none"), ("stacked", "lhs"), ("stacked", "rhs"),
    ("stacked", "both"), ("pairs", "none")])
def test_l2r_gemm_dispatch_bit_identical(schedule, prestacked):
    a, b = _operands(8, 2, seed=5, m=9, k=21, n=6)
    ref = np.asarray(jops.l2r_gemm(jnp.asarray(a), jnp.asarray(b), 8, 2, 5,
                                   schedule=schedule, backend="jnp"))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if prestacked in ("lhs", "both"):
        ta = PlaneOperands.prepare_lhs(ta, 8, 2)
    if prestacked in ("rhs", "both"):
        tb = PlaneOperands.prepare_rhs(tb, 8, 2, shifted=True)
    got = tops.l2r_gemm(ta, tb, 8, 2, 5, schedule=schedule)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_l2r_gemm_rejects_bad_operands():
    a, b = _operands(8, 2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(ValueError, match="passed as the lhs"):
        tops.l2r_gemm(PlaneOperands.prepare_rhs(tb, 8, 2), tb)
    with pytest.raises(ValueError, match="re-prepare"):
        tops.l2r_gemm(ta, PlaneOperands.prepare_rhs(tb, 8, 4))
    with pytest.raises(TypeError, match="raw int"):
        tops.l2r_gemm(PlaneOperands.prepare_lhs(ta), tb, schedule="pairs")
    with pytest.raises(ValueError, match="unknown schedule"):
        tops.l2r_gemm(ta, tb, schedule="blocked")
    with pytest.raises(ValueError, match="streaming-schedule control flow"):
        tops.l2r_gemm(ta, tb, schedule="stacked", early_exit=True)


def test_sixteen_bit_wrap_matches_under_warn(monkeypatch):
    """Full-range 16-bit operands overflow int32: the reference wraps
    (L2R_CERTIFY=warn keeps it running) and the port wraps identically
    on purpose (int64 accumulation narrowed modulo 2^32)."""
    from repro_torch.analysis import overflow as tov

    monkeypatch.setenv("L2R_CERTIFY", "warn")
    rng = np.random.default_rng(6)
    a, b = _ints(rng, 16, (4, 48)), _ints(rng, 16, (48, 3))
    exact = a.astype(np.int64) @ b.astype(np.int64)
    assert np.abs(exact).max() > 2**31  # the case really wraps
    tov._WARNED.clear()
    for lv in (None, 4):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = np.asarray(jops.l2r_gemm(jnp.asarray(a), jnp.asarray(b),
                                           16, 4, lv, backend="jnp"))
        with pytest.warns(tov.AccumulatorOverflowWarning):
            got = tops.l2r_gemm(torch.from_numpy(a), torch.from_numpy(b),
                                16, 4, lv)
        np.testing.assert_array_equal(got.numpy(), ref)
        if lv is None:
            wrapped = (exact + 2**31) % 2**32 - 2**31
            np.testing.assert_array_equal(got.numpy(), wrapped)


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("prestack", [False, True])
def test_l2r_matmul_f_matches(per_channel, prestack):
    """Float outputs: the int32 accumulators are bit-identical, so only
    the dequantize multiplies could differ (rtol 1e-6, one f32 ulp)."""
    from repro.core.quant import QuantConfig as JCfg
    from repro.core.quant import quantize_weights as j_qw
    from repro_torch.core.quant import QuantConfig as TCfg
    from repro_torch.core.quant import quantize_weights as t_qw

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = rng.standard_normal((24, 10)).astype(np.float32)
    jc, tc = JCfg(per_channel=per_channel), TCfg(per_channel=per_channel)
    ref = np.asarray(jops.l2r_matmul_f(
        jnp.asarray(x), None, jc, 6,
        w_q=j_qw(jnp.asarray(w), jc, prestack=prestack), backend="jnp"))
    got = tops.l2r_matmul_f(torch.from_numpy(x), None, tc, 6,
                            w_q=t_qw(torch.from_numpy(w), tc,
                                     prestack=prestack, plane_shifted=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    ref_raw = np.asarray(jg.l2r_matmul(jnp.asarray(x[0]), jnp.asarray(w), jc))
    got_raw = tg.l2r_matmul(torch.from_numpy(x[0]), torch.from_numpy(w), tc)
    np.testing.assert_allclose(got_raw.numpy(), ref_raw, rtol=1e-6, atol=0)


# ---------------------------------------------- kernel B1's product tables
def _plane_sum(stack, lo, hi, k, axis):
    """Sum of pre-shifted planes lo..hi of an ascending stack (int64)."""
    return sum(stack.narrow(axis, i * k, k).to(torch.int64)
               for i in range(lo, hi + 1))


def _products_plain(a_stack, b_rev, d, k, products):
    """The kernel's arithmetic in plain torch: the sum over products of
    (sum of A planes il..ih) @ (sum of B planes jl..jh), wrapped to
    int32.  ``b_rev`` descends: plane j is block D-1-j."""
    b_asc = torch.cat([b_rev[(d - 1 - j) * k:(d - j) * k] for j in range(d)])
    acc = torch.zeros((a_stack.shape[0], b_rev.shape[1]), dtype=torch.int64)
    for il, ih, jl, jh in products:
        acc += _plane_sum(a_stack, il, ih, k, 1) @ _plane_sum(b_asc, jl, jh,
                                                              k, 0)
    return tg.wrap_int32(acc)


def _extreme_operands(n_bits, m=6, k=37, n=5, seed=0):
    """Random operands with the range ends -2^(n-1) and 2^(n-1)-1 in
    both."""
    rng = np.random.default_rng(seed + n_bits)
    lo, hi = -(1 << (n_bits - 1)), (1 << (n_bits - 1)) - 1
    a = rng.integers(lo, hi + 1, (m, k)).astype(np.int8)
    b = rng.integers(lo, hi + 1, (k, n)).astype(np.int8)
    a[0, :3], a[1, :3] = lo, hi
    b[:3, 0], b[:3, 1] = lo, hi
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.parametrize("n_bits,log2_radix", [(4, 2), (8, 2)])
def test_prefix_collapse_matches_plain_every_level(n_bits, log2_radix):
    """A walk from level 0 as at most D plane-range products (one at full
    depth) equals kernel B1's plain version bit for bit; each range is
    the raw operand under a byte mask (a bit-field: OR == sum)."""
    from repro_torch.core.online import msdf_products, plane_bits

    d = n_bits // log2_radix
    a, b = _extreme_operands(n_bits)
    k = a.shape[1]
    sa, sb = t_lhs(a, n_bits, log2_radix), t_rhs(b, n_bits, log2_radix)
    for lv in [None] + list(range(2 * d)):
        prods = msdf_products(d, lv)
        assert len(prods) <= d
        if lv is None or lv >= 2 * d - 1:
            assert prods == [(0, d - 1, 0, d - 1)]
        got = _products_plain(sa, sb, d, k, prods)
        ref = tk.l2r_gemm_stacked_planes_plain(sa, sb, n_bits, log2_radix, lv)
        assert torch.equal(got, ref), lv
        for il, ih, jl, jh in prods:
            for x, lo, hi in ((a, il, ih), (b, jl, jh)):
                masked = (x.to(torch.int32) & plane_bits(d, log2_radix, lo,
                                                         hi)).to(torch.uint8)
                st = t_lhs(x if x is a else x.t(), n_bits, log2_radix)
                ref_sum = _plane_sum(st, lo, hi, k if x is a else x.shape[0],
                                     1)
                assert torch.equal(masked.view(torch.int8).to(torch.int64),
                                   ref_sum if x is a else ref_sum.t())


@pytest.mark.parametrize("n_bits,log2_radix", [(4, 2), (8, 2)])
def test_tables_above_level_zero_run_as_plane_pairs(n_bits, log2_radix):
    """Every ``first_level`` the collapse refuses: the table runs as its
    plane pairs, and their products equal the plain walk of those
    levels bit for bit."""
    from repro_torch.core.online import msdf_pairs, msdf_products

    d = n_bits // log2_radix
    a, b = _extreme_operands(n_bits, seed=1)
    k = a.shape[1]
    sa, sb = t_lhs(a, n_bits, log2_radix), t_rhs(b, n_bits, log2_radix)
    for first in range(1, 2 * d - 1):
        for lv in range(first + 1, 2 * d):
            prods = msdf_products(d, lv, first)
            assert all(il == ih and jl == jh for il, ih, jl, jh in prods)
            assert [(il, jl) for il, _, jl, _ in prods] == \
                msdf_pairs(d, lv)[len(msdf_pairs(d, first)):]
            got = _products_plain(sa, sb, d, k, prods)
            ref = tk.l2r_gemm_stacked_planes_plain(
                sa, sb, n_bits, log2_radix, lv, first_level=first)
            assert torch.equal(got, ref), (first, lv)


def test_b1_takes_a_k_major_stack():
    """The K-major weight cache (``k_major=True``) holds the same values
    with the contraction innermost; B1's wrapper takes either layout."""
    from repro_torch.core.quant import QuantConfig, quantize_weights

    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
    cw = torch.from_numpy(rng.standard_normal((3, 3, 16, 8))
                          .astype(np.float32))
    for wt, axis in ((w, 0), (cw, -2)):
        row = quantize_weights(wt, QuantConfig(), prestack=True,
                               plane_axis=axis, plane_shifted=True)
        kmaj = quantize_weights(wt, QuantConfig(), prestack=True,
                                plane_axis=axis, plane_shifted=True,
                                k_major=True)
        assert torch.equal(row.planes.stack, kmaj.planes.stack)
        assert kmaj.planes.stack.stride(axis) == 1
    st = quantize_weights(w, QuantConfig(), prestack=True,
                          plane_shifted=True, k_major=True).planes.stack
    a, _ = _extreme_operands(8, m=7, k=40, n=2)
    sa = t_lhs(a)
    for lv in (None, 3):
        assert torch.equal(tk.l2r_gemm_stacked_planes(sa, st, levels=lv),
                           tk.l2r_gemm_stacked_planes(sa, st.contiguous(),
                                                      levels=lv))


@pytest.mark.parametrize("n_bits,log2_radix", [(4, 1), (4, 2), (8, 1), (8, 2),
                                               (8, 4), (6, 2)])
def test_b3_plan_masks_sum_the_pair_loop(n_bits, log2_radix):
    """Kernel B3's host plan: at every ``levels`` the byte-mask products
    (at most D, one (0xFF, 0xFF) at full depth) summed over the raw
    operands equal the pair loop of ``msdf_pairs`` bit for bit."""
    d = n_bits // log2_radix
    a, b = _extreme_operands(n_bits, seed=2)
    for lv in _levels(n_bits, log2_radix):
        plan = tk.pairs_plan(d, log2_radix, lv)
        assert len(plan) <= d
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64)
        for ma, mb in plan:
            am = a & torch.tensor(ma, dtype=torch.uint8).view(torch.int8)
            bm = b & torch.tensor(mb, dtype=torch.uint8).view(torch.int8)
            acc += am.long() @ bm.long()
        ref = tk.l2r_gemm_pairs_plain(a, b, n_bits, log2_radix, lv)
        assert torch.equal(tg.wrap_int32(acc), ref), lv
    assert tk.pairs_plan(d, log2_radix, None) == ((0xFF, 0xFF),)


@pytest.mark.parametrize("m,k,n,d", [(8, 4096, 1000, 4), (3, 1000, 77, 4),
                                     (16, 300, 130, 2), (300, 128, 96, 4),
                                     (8, 64, 1000, 8), (5, 3, 7, 4),
                                     (401408, 64, 64, 4)])
def test_b2_split_plan_sums_to_the_stream(m, k, n, d):
    """Kernel B2's host plan: the tile by M (16 x 64 or 32 x 64), and a
    cluster split of the contraction where the tiles leave the card's 132
    SMs half empty (fc8 at batch 8: 16 tiles x 8 blocks).  Each block's share (32-deep chunks)
    gives per-level prefixes whose wrapped sum is the whole stream, as the
    cluster adds them."""
    tile, splits = tk.streaming_plan(m, n, k, 132)
    assert tile == (0 if m <= 16 else 1)
    tiles = -(-m // (16 if tile == 0 else 32)) * -(-n // 64)
    steps = -(-k // 32)
    assert 1 <= splits <= min(8, steps)
    if 2 * tiles >= 132:
        assert splits == 1
    else:
        assert splits == min(8, steps) or tiles * splits >= 132
    if (m, k, n) == (8, 4096, 1000):
        assert (tile, splits) == (0, 8)
    if m * n > 10 ** 5:
        return
    n_bits, log2_radix = 8, 8 // d
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(_ints(rng, 8, (m, k)))
    b = torch.from_numpy(_ints(rng, 8, (k, n)))
    sa, sb = t_lhs(a, n_bits, log2_radix), t_rhs(b, n_bits, log2_radix)
    per = -(-steps // splits) * 32
    total = torch.zeros((2 * d - 1, m, n), dtype=torch.int64)
    for lo in range(0, k, per):
        hi = min(k, lo + per)
        cols = torch.cat([torch.arange(p * k + lo, p * k + hi)
                          for p in range(d)])
        total += tk.l2r_gemm_streaming_planes_plain(
            sa[:, cols], sb[cols], n_bits, log2_radix).long()
    assert torch.equal(tg.wrap_int32(total),
                       tk.l2r_gemm_streaming_planes_plain(sa, sb, n_bits,
                                                          log2_radix))
