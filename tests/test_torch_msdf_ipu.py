"""Port parity: the PE-array CIPU simulator (repro_torch.kernels.msdf_ipu)
against the Pallas kernel in interpret mode and the integer SOP, on the
shapes of tests/test_kernel_msdf_ipu.py.  Kernel B6 itself runs on the
card only (tests/test_torch_cuda.py, chip_smoke.py); here its plain
version, the golden-model oracle and the entry point on CPU tensors are
held bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import msdf_ipu as jm
from repro_torch.kernels import msdf_ipu as tm

SHAPES = [(64, 72, 8), (100, 9, 8), (256, 16, 6), (8, 72, 8)]


@pytest.mark.parametrize("m,k,n_bits", SHAPES)
def test_pe_array_bit_identical(m, k, n_bits):
    rng = np.random.default_rng(m + k)
    hi = 1 << n_bits
    a = rng.integers(0, hi, (m, k)).astype(np.int32)
    b = rng.integers(0, hi, (m, k)).astype(np.int32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pallas = np.asarray(jm.cipu_array_pallas(ja, jb, n_bits, bm=64))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for got in (tm.cipu_array_plain(ta, tb, n_bits),
                tm.simulate_pe_array(ta, tb, n_bits),
                tm.cipu_array_ref(ta, tb, n_bits)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(tm.int_sop_ref(ta, tb).numpy(),
                                  np.asarray(jm.int_sop_ref(ja, jb)))
    np.testing.assert_array_equal(pallas, (a.astype(np.int64) * b).sum(-1))


def test_pe_array_uint8_operands_and_width_guard():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (37, 72)).astype(np.uint8)
    b = rng.integers(0, 256, (37, 72)).astype(np.uint8)
    got = tm.simulate_pe_array(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(
        got.numpy(), (a.astype(np.int64) * b).sum(-1))
    with pytest.raises(ValueError, match="SOP width"):
        tm.cipu_array_plain(torch.zeros((2, 4), dtype=torch.int32),
                            torch.zeros((2, 4), dtype=torch.int32), 16)
    with pytest.raises(ValueError, match=r"\(M, k\)"):
        tm.cipu_array(torch.zeros((2, 4)), torch.zeros((2, 5)))
