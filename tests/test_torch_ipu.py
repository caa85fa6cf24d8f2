"""Port parity: the CIPU golden model and the accelerator model
(repro_torch.core.ipu / hw_model against repro.core.ipu / hw_model) on
the cases of tests/test_ipu.py and tests/test_cycle_model.py, the same
numpy inputs on both sides.

Final SOPs and stable-bit counts compare bit for bit; the Table I/II
dicts of the (pure-Python, copied) hardware model compare with ``==``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cycle_model as jcm
from repro.core import hw_model as jhw
from repro.core import ipu as jipu
from repro_torch.core import cycle_model as tcm
from repro_torch.core import hw_model as thw
from repro_torch.core import ipu as tipu


def _both(a, b, n_bits):
    j = jipu.simulate_cipu(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32),
                           n_bits)
    t = tipu.simulate_cipu(torch.from_numpy(a.astype(np.int32)),
                           torch.from_numpy(b.astype(np.int32)), n_bits)
    return j, t


def _same(j, t):
    np.testing.assert_array_equal(t.final.numpy(), np.asarray(j.final))
    np.testing.assert_array_equal(t.stable_bits.numpy(),
                                  np.asarray(j.stable_bits))
    assert t.final.dtype == t.stable_bits.dtype == torch.int32


@pytest.mark.parametrize("k", [1, 9, 27, 72])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_cipu_bit_identical(seed, k):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(3, k))
    b = rng.integers(0, 256, size=(3, k))
    j, t = _both(a, b, 8)
    _same(j, t)
    np.testing.assert_array_equal(t.final.numpy(), (a * b).sum(-1))


@pytest.mark.parametrize("n_bits", [4, 6, 8, 10])
def test_simulate_cipu_bitwidth_sweep(n_bits):
    rng = np.random.default_rng(n_bits)
    hi = 1 << n_bits
    a = rng.integers(0, hi, size=(4, 16))
    b = rng.integers(0, hi, size=(4, 16))
    j, t = _both(a, b, n_bits)
    _same(j, t)
    np.testing.assert_array_equal(t.final.numpy(), (a * b).sum(-1))


@pytest.mark.parametrize("seed,lo,shape", [(11, 0, (8, 72)), (13, 128, (4, 8))])
def test_online_digits_bit_identical(seed, lo, shape):
    """The monotone-digits and online-delay inputs of tests/test_ipu.py:
    the stable-bit trace is the reference's, so both properties carry."""
    rng = np.random.default_rng(seed)
    a = rng.integers(lo, 256, size=shape)
    b = rng.integers(lo, 256, size=shape)
    j, t = _both(a, b, 8)
    _same(j, t)
    assert (torch.diff(t.stable_bits, dim=-1) >= 0).all()


def test_python_golden_model():
    rng = np.random.default_rng(7)
    a = [int(x) for x in rng.integers(0, 256, size=72)]
    b = [int(x) for x in rng.integers(0, 256, size=72)]
    exact = sum(x * y for x, y in zip(a, b))
    assert tipu.simulate_cipu_python(a, b, 8) == \
        jipu.simulate_cipu_python(a, b, 8) == exact
    t = tipu.simulate_cipu(torch.tensor([a]), torch.tensor([b]), 8)
    assert int(t.final[0]) == exact


@pytest.mark.parametrize("n_bits,k", [(16, 4), (12, 200), (8, 1 << 16)])
def test_width_guard(n_bits, k):
    a = np.zeros((1, k), np.int32)
    with pytest.raises(ValueError) as je:
        jipu.simulate_cipu(jnp.asarray(a), jnp.asarray(a), n_bits=n_bits)
    with pytest.raises(ValueError) as te:
        tipu.simulate_cipu(torch.from_numpy(a), torch.from_numpy(a),
                           n_bits=n_bits)
    assert str(te.value) == str(je.value)


def test_stable_msb_count_every_diff_below_2_24():
    """lo ^ hi is the only input, so lo = 0 and hi over [0, 2^24) is
    every difference the reference shapes reach; a sample above adds
    where f32 rounds the difference."""
    rng = np.random.default_rng(0)
    diffs = np.concatenate([np.arange(1 << 24),
                            rng.integers(1 << 24, 2**31 - 1, 100_000),
                            [2**30 - 1, 2**31 - 1]]).astype(np.int32)
    for width in (23, 31):
        j = jipu.stable_msb_count(jnp.zeros_like(jnp.asarray(diffs)),
                                  jnp.asarray(diffs), width)
        t = tipu.stable_msb_count(torch.zeros(len(diffs), dtype=torch.int32),
                                  torch.from_numpy(diffs), width)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_hw_model_tables_equal():
    assert thw.table1() == jhw.table1()
    assert thw.table2() == jhw.table2()
    assert thw.calibration() == jhw.calibration()
    assert thw.PAPER_TABLE1 == jhw.PAPER_TABLE1
    assert thw.PAPER_TABLE2 == jhw.PAPER_TABLE2
    for l2r in (True, False):
        assert thw.critical_path_ns(l2r) == jhw.critical_path_ns(l2r)
        assert thw.accelerator_area_um2(l2r) == jhw.accelerator_area_um2(l2r)


def test_cycle_model_cases_equal():
    """The numbers tests/test_cycle_model.py checks, from the port's
    copy, equal the reference's."""
    cfg_t, cfg_j = tcm.AcceleratorConfig(), jcm.AcceleratorConfig()
    for lt, lj in zip(tcm.VGG16_CONV_LAYERS, jcm.VGG16_CONV_LAYERS):
        for l2r in (True, False):
            assert tcm.layer_cycles(lt, cfg_t, l2r) == \
                jcm.layer_cycles(lj, cfg_j, l2r)
    for l2r in (True, False):
        assert tcm.peak_gops(l2r=l2r) == jcm.peak_gops(l2r=l2r)
        assert tcm.network_cycles(l2r=l2r) == jcm.network_cycles(l2r=l2r)
