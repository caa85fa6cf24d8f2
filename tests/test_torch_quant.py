"""Port parity: quantization, digit planes, plane stacks and the int32
overflow certificate (repro_torch.core.quant / analysis.overflow against
repro.core.quant / analysis.overflow).  Integers compare with ``==``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import overflow as jov
from repro.core import quant as jq
from repro_torch.analysis import overflow as tov
from repro_torch.core import quant as tq

CONFIGS = [(n, b) for n in (4, 8, 16) for b in (1, 2, 4) if n % b == 0]


def _j(x):
    return np.asarray(x)


def _t(x):
    return x.numpy()


def _ints(rng, n_bits, shape):
    lo, hi = -(1 << (n_bits - 1)), (1 << (n_bits - 1))
    dt = np.int8 if n_bits <= 8 else np.int16
    return rng.integers(lo, hi, shape).astype(dt)


@pytest.mark.parametrize("mode", ["per_tensor", "per_channel", "axis0"])
@pytest.mark.parametrize("n_bits", [4, 8, 16])
def test_quantize_bit_identical(mode, n_bits):
    rng = np.random.default_rng(n_bits)
    x = (rng.standard_normal((6, 9)) * 3).astype(np.float32)
    x[2, 3] = 0.5 * np.abs(x).max()  # a tie-prone value
    cfg_kw = dict(n_bits=n_bits, log2_radix=2,
                  per_channel=mode != "per_tensor")
    axis = 0 if mode == "axis0" else None
    qj, sj = jq.quantize(jnp.asarray(x), jq.QuantConfig(**cfg_kw), axis=axis)
    qt, st = tq.quantize(torch.from_numpy(x), tq.QuantConfig(**cfg_kw),
                         axis=axis)
    assert _t(qt).dtype == _j(qj).dtype
    np.testing.assert_array_equal(_t(qt), _j(qj))
    np.testing.assert_array_equal(_t(st), _j(sj))


@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
def test_planes_and_stacks_bit_identical(n_bits, log2_radix):
    rng = np.random.default_rng(n_bits * 10 + log2_radix)
    a = _ints(rng, n_bits, (5, 7))
    w = _ints(rng, n_bits, (3, 3, 7, 4))
    for fn in ("digit_planes", "shifted_planes"):
        got = getattr(tq, fn)(torch.from_numpy(a), n_bits, log2_radix)
        ref = getattr(jq, fn)(jnp.asarray(a), n_bits, log2_radix)
        assert _t(got).dtype == _j(ref).dtype, fn
        np.testing.assert_array_equal(_t(got), _j(ref), err_msg=fn)
    for shifted in (True, False):
        np.testing.assert_array_equal(
            _t(tq.stack_planes_lhs(torch.from_numpy(a), n_bits, log2_radix,
                                   shifted=shifted)),
            _j(jq.stack_planes_lhs(jnp.asarray(a), n_bits, log2_radix,
                                   shifted=shifted)))
        np.testing.assert_array_equal(
            _t(tq.stack_planes_rhs(torch.from_numpy(a.T.copy()), n_bits,
                                   log2_radix, shifted=shifted)),
            _j(jq.stack_planes_rhs(jnp.asarray(a.T), n_bits, log2_radix,
                                   shifted=shifted)))
        np.testing.assert_array_equal(
            _t(tq.stack_planes_rhs(torch.from_numpy(w), n_bits, log2_radix,
                                   axis=-2, shifted=shifted)),
            _j(jq.stack_planes_rhs(jnp.asarray(w), n_bits, log2_radix,
                                   axis=-2, shifted=shifted)))


@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
def test_plane_operands_layouts_bit_identical(n_bits, log2_radix):
    rng = np.random.default_rng(7 + n_bits + log2_radix)
    a = _ints(rng, n_bits, (4, 6))
    w = _ints(rng, n_bits, (3, 3, 6, 5))
    for shifted in (False, True):
        pl = tq.PlaneOperands.prepare_lhs(torch.from_numpy(a), n_bits,
                                          log2_radix, shifted=shifted)
        pr = tq.PlaneOperands.prepare_rhs(torch.from_numpy(w), n_bits,
                                          log2_radix, axis=-2,
                                          shifted=shifted)
        jl = jq.PlaneOperands.prepare_lhs(jnp.asarray(a), n_bits, log2_radix,
                                          shifted=shifted)
        jr = jq.PlaneOperands.prepare_rhs(jnp.asarray(w), n_bits, log2_radix,
                                          axis=-2, shifted=shifted)
        assert (pl.k, pl.axis, pr.k, pr.axis) == (jl.k, jl.axis, jr.k, jr.axis)
        assert pr.matches(n_bits, log2_radix, ndim=4, side="rhs",
                          contract_axis=2)
        assert not pr.matches(n_bits, log2_radix, side="lhs")
        assert f"stack.shape={tuple(pr.stack.shape)}" in pr.describe()
        for to in (False, True):
            np.testing.assert_array_equal(_t(pl.core_stack(to)),
                                          _j(jl.core_stack(to)))
            np.testing.assert_array_equal(_t(pr.core_stack(to)),
                                          _j(jr.core_stack(to)))


@pytest.mark.parametrize("plane_shifted", [False, True])
@pytest.mark.parametrize("n_bits,log2_radix", [(8, 2), (8, 4), (4, 1)])
def test_quantize_weights_prestack_bit_identical(n_bits, log2_radix,
                                                 plane_shifted):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 3, 5, 6)).astype(np.float32)
    cfg = dict(n_bits=n_bits, log2_radix=log2_radix)
    got = tq.quantize_weights(torch.from_numpy(w), tq.QuantConfig(**cfg),
                              prestack=True, plane_axis=-2,
                              plane_shifted=plane_shifted)
    ref = jq.quantize_weights(jnp.asarray(w), jq.QuantConfig(**cfg),
                              prestack=True, plane_axis=-2,
                              plane_shifted=plane_shifted)
    np.testing.assert_array_equal(_t(got.q), _j(ref.q))
    np.testing.assert_array_equal(_t(got.scale), _j(ref.scale))
    np.testing.assert_array_equal(_t(got.planes.stack), _j(ref.planes.stack))
    assert got.planes.shifted == plane_shifted and got.shape == ref.shape


@pytest.mark.parametrize("k,sound", [(131071, True), (131072, False)])
def test_certificate_tightness_pair(k, sound):
    """The worst-case accumulator of 8-bit radix-4 fits int32 up to
    K=131071 and wraps at K=131072, in both packages."""
    got, ref = tov.certify(8, 2, k), jov.certify(8, 2, k)
    assert got.sound is sound and ref.sound is sound
    assert got.to_json() == ref.to_json()
    assert got.bound == (2147467264 if sound else 131072 * 16384)


@pytest.mark.parametrize("n_bits,log2_radix", [(8, 1), (8, 2), (16, 4)])
def test_per_element_extremes_match(n_bits, log2_radix):
    got = tov.per_element_extremes(n_bits, log2_radix)
    ref = jov.per_element_extremes(n_bits, log2_radix)
    assert (got.lo, got.hi, got.exact, got.lo_wit, got.hi_wit) == \
        (ref.lo, ref.hi, ref.exact, ref.lo_wit, ref.hi_wit)


def test_certify_mode_strict_raises(monkeypatch):
    monkeypatch.setenv("L2R_CERTIFY", "strict")
    with pytest.raises(OverflowError, match="OVERFLOWS int32"):
        tov.check_or_raise(16, 4, 64, where="test")
    monkeypatch.setenv("L2R_CERTIFY", "off")
    assert tov.check_or_raise(16, 4, 64, where="test") is None
