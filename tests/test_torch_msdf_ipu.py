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


# ---- kernel B6's packing and datapath, mirrored in plain torch.  A test aid
# (nothing on the main path calls it): the kernel's own steps on int64
# tensors, so that its arithmetic is held here without a card.
_DELTA_SWAPS = [(0x00AA00AA00AA00AA, 7), (0x0000CCCC0000CCCC, 14),
                (0x00000000F0F0F0F0, 28)]  # Hacker's Delight 7-3


def _transpose8(x):
    """8x8 bit blocks (byte r = operand r) -> byte p = bit p of the 8."""
    for mask, d in _DELTA_SWAPS:
        t = ((x >> d) ^ x) & mask
        x = x ^ t ^ (t << d)
    return x


def _b6_planes(ops, n_bits):
    """(M, k) operands -> (chunks, n, M) plane words: bit 8g + r of word
    (c, p) is bit p of operand 32c + 8g + r, as the kernel packs them."""
    m, k = ops.shape
    chunks = max(1, -(-k // 32))
    ops = torch.nn.functional.pad(ops.to(torch.int64), (0, 32 * chunks - k))
    groups = ops.reshape(m, chunks, 4, 8)  # 4 blocks of 8 operands a chunk
    words = []
    for byte in range(-(-n_bits // 8)):  # planes 8*byte .. 8*byte + 7
        packed = sum(((groups[..., r] >> (8 * byte)) & 0xFF) << (8 * r)
                     for r in range(8))  # byte r = operand r
        x = _transpose8(packed)  # (M, chunks, 4)
        for p in range(8):
            words.append(sum(((x[..., g] >> (8 * p)) & 0xFF) << (8 * g)
                             for g in range(4)))
    return torch.stack(words[:n_bits]).permute(2, 0, 1)


def _popc(x):
    return sum((x >> s) & 1 for s in range(32))


def _b6_counts(a, b, n_bits):
    """(M, n, n): cnt[i, j] = sum over chunks of popc(A_{n-1-i} & B_{n-1-j})."""
    pa, pb = _b6_planes(a, n_bits), _b6_planes(b, n_bits)
    rev = list(range(n_bits - 1, -1, -1))
    both = pa[:, rev, None, :] & pb[:, None, rev, :]  # (chunks, n, n, M)
    return _popc(both).sum(0).permute(2, 0, 1)


def _b6_datapath(cnt, n_bits):
    """The kernel's n^2 clocked cycles over the counts, uint32 wrapping."""
    u32 = 0xFFFFFFFF

    def csa(x, y, z):
        return x ^ y ^ z, (((x & y) | (x & z) | (y & z)) << 1) & u32

    zero = torch.zeros(cnt.shape[0], dtype=torch.int64)
    ppr_s = ppr_c = res_s = res_c = zero
    for i in range(n_bits):
        for j in range(n_bits):
            wrap = j == n_bits - 1
            x3 = (res_s << 1) & u32 if wrap else zero
            x4 = (res_c << 1) & u32 if wrap else zero
            s0, c0 = csa((ppr_s << 1) & u32, (ppr_c << 1) & u32, cnt[:, i, j])
            s1, c1 = csa(x3, x4, zero)
            s2, c2 = csa(s0, c0, s1)
            s3, c3 = csa(s2, c1, c2)
            if wrap:
                res_s, res_c, ppr_s, ppr_c = s3, c3, zero, zero
            else:
                ppr_s, ppr_c = s3, c3
    return ((res_s + res_c) & u32).to(torch.int32)


B6_MIRROR = ([(1, n) for n in (4, 6, 8, 10, 15)]
             + [(k, n) for k in (9, 27, 72, 100) for n in (4, 6, 8, 10)])


@pytest.mark.parametrize("k,n_bits", B6_MIRROR)
def test_b6_packing_mirror_counts_and_datapath(k, n_bits):
    """B6's packing (byte pack, 8x8 bit transposes, plane words per
    32-deep chunk, popc) gives the direct counts, and its datapath over
    them gives cipu_array_plain, for M not a multiple of 32 and operand
    bits at and above n (never counted)."""
    rng = np.random.default_rng(k * 16 + n_bits)
    m = 45
    a = torch.from_numpy(rng.integers(0, 1 << 16, (m, k)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 1 << 16, (m, k)).astype(np.int32))
    cnt = _b6_counts(a, b, n_bits)
    bit = lambda x, p: (x.to(torch.int64) >> p) & 1  # noqa: E731
    for i in range(n_bits):
        for j in range(n_bits):
            direct = (bit(a, n_bits - 1 - i) & bit(b, n_bits - 1 - j)).sum(-1)
            assert torch.equal(cnt[:, i, j], direct), (i, j)
    got = _b6_datapath(cnt, n_bits)
    np.testing.assert_array_equal(got.numpy(),
                                  tm.cipu_array_plain(a, b, n_bits).numpy())
    low = (1 << n_bits) - 1
    np.testing.assert_array_equal(
        got.numpy(), tm.int_sop_ref(a & low, b & low).numpy())
