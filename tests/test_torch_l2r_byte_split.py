"""The byte split of kernels B1's and B3's int16 routes, in its plain form
(``kernels/l2r_gemm/kernel.py:byte_split_matmul``), against the reference
on the same numpy inputs.

The int16 entries of B1 and B3 run on the int8 tensor cores: each masked
int16 operand splits into an s8 high and a u8 low byte, and the three
byte-pair sums, folded into the result every 32,768 elements of
contraction, combine mod 2^32.  Here that arithmetic meets the reference's
pair loop (``repro.core.l2r_gemm.l2r_matmul_int``) and the TPU kernel B3
replaces (``l2r_gemm_pallas``, interpret mode, one block) at n_bits 12 and
16, radix 4 and 16, every level prefix, codes at the range's extremes; and
at K = 33,000 of extreme codes, where a byte accumulator leaves int32
without the fold.  Integer results compare bit for bit.  One intra-op
thread, small shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import l2r_gemm as jg
from repro.kernels.l2r_gemm import kernel as jk
from repro_torch.core import quant as tq
from repro_torch.kernels.l2r_gemm import kernel as tk


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prefixes():
    """(n_bits, log2_radix, levels): n_bits 12 and 16 at radix 4 and 16,
    every level prefix of the walk and full depth."""
    return [(nb, r, lv) for nb, r in ((12, 2), (12, 4), (16, 2), (16, 4))
            for lv in [*range(1, 2 * tq.plane_count(nb, r)), None]]


def _codes(rng, n_bits, shape):
    """Random n_bits codes as int16, the range's extremes in the first two
    rows and columns."""
    hi = 1 << (n_bits - 1)
    x = rng.integers(-hi, hi, shape).astype(np.int16)
    x[0], x[1], x[:, 0], x[:, 1] = -hi, hi - 1, -hi, hi - 1
    return x


def _masks(n_bits, log2_radix, levels):
    return tk.pairs_plan(tq.plane_count(n_bits, log2_radix), log2_radix,
                         levels, 16)


@pytest.mark.parametrize("n_bits,log2_radix,levels", _prefixes())
def test_byte_split_matches_reference_every_prefix(n_bits, log2_radix,
                                                   levels):
    """byte_split_matmul over B3's masks (pairs_plan, 16 bits) equals the
    reference's pair loop and the Pallas pair-loop kernel in interpret
    mode, bit for bit, on one (8, 64) x (64, 8) block."""
    rng = np.random.default_rng(100 * n_bits + 10 * log2_radix
                                + (levels or 0))
    a, b = _codes(rng, n_bits, (8, 64)), _codes(rng, n_bits, (64, 8))
    got = tk.byte_split_matmul(torch.from_numpy(a), torch.from_numpy(b),
                               _masks(n_bits, log2_radix, levels))
    assert got.dtype == torch.int32 and got.shape == (8, 8)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jg.l2r_matmul_int(ja, jb, n_bits, log2_radix, levels)))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jk.l2r_gemm_pallas(ja, jb, n_bits, log2_radix, levels,
                                      bm=8, bk=32, bn=8, interpret=True)))


@pytest.mark.parametrize("n_bits,log2_radix", [(12, 4), (16, 4)])
def test_byte_split_is_the_stacked_walk(n_bits, log2_radix):
    """With B1's products (plane ranges of the pre-shifted stacks) the byte
    split of the raw operands under plane_bits' masks is B1's plain walk
    at every prefix: a plane range is a bit-field of its operand."""
    rng = np.random.default_rng(7 + n_bits)
    a = torch.from_numpy(_codes(rng, n_bits, (5, 40)))
    b = torch.from_numpy(_codes(rng, n_bits, (40, 6)))
    sa = tq.stack_planes_lhs(a, n_bits, log2_radix)
    sb = tq.stack_planes_rhs(b, n_bits, log2_radix)
    for lv in [*range(1, 2 * tq.plane_count(n_bits, log2_radix)), None]:
        got = tk.byte_split_matmul(a, b, _masks(n_bits, log2_radix, lv))
        np.testing.assert_array_equal(
            got.numpy(), tk.l2r_gemm_stacked_planes_plain(
                sa, sb, n_bits, log2_radix, lv).numpy())


def test_byte_split_folds_at_k_33000():
    """K = 33,000 of extreme int16 codes (-32513: high byte -128, low byte
    255, for 32,900 elements; random extremes after): unfolded, the cross
    sum leaves int32 and the function raises; folded every 32,768, the
    result is the reference's bit for bit, at full depth and at a prefix."""
    k = 33000
    rng = np.random.default_rng(33)
    ends = np.array([-32768, -32513, -256, 255, 32512, 32767], np.int16)
    a = np.full((2, k), -32513, np.int16)
    b = np.full((k, 3), -32513, np.int16)
    a[:, 32900:] = rng.choice(ends, (2, k - 32900))
    b[32900:] = rng.choice(ends, (k - 32900, 3))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(OverflowError, match="leaves int32"):
        tk.byte_split_matmul(ta, tb, _masks(16, 4, None), fold=None)
    for lv in (None, 4):
        got = tk.byte_split_matmul(ta, tb, _masks(16, 4, lv))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jg.l2r_matmul_int(
                jnp.asarray(a), jnp.asarray(b), 16, 4, lv)))
    full = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(
        tk.byte_split_matmul(ta, tb, _masks(16, 4, None)).numpy(),
        ((full + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32))
