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
        # the kernel's level table is the k_blocks=1 walk, levels merged
        a_col, b_row, depth = tk.level_table(d, 5, lv)
        a_blk, b_blk = tk.stacked_schedule(d, 1, lv)
        assert sum(depth) == 5 * len(a_blk)
        t = 0
        for ac, br, dp in zip(a_col, b_row, depth):
            n_pairs = dp // 5
            assert list(a_blk[t:t + n_pairs] * 5) == \
                list(range(ac, ac + dp, 5))
            assert list(b_blk[t:t + n_pairs] * 5) == \
                list(range(br, br + dp, 5))
            t += n_pairs


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
