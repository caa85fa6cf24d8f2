"""Kernel B1 on the card, against its plain version.

Every test here needs a CUDA card (a hand-written kernel has no CPU
mode) and skips without one.  The file imports neither jax nor repro,
so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.core.quant import stack_planes_lhs, stack_planes_rhs
from repro_torch.kernels.l2r_gemm import kernel

SHAPES = [(5, 3, 7), (130, 19, 67), (16, 64, 1000), (300, 128, 96)]
CONFIGS = [(8, 2), (8, 1), (8, 4), (4, 2)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B1 has no CPU mode")
    return torch.device("cuda")


def _stacks(dev, m, k, n, n_bits, log2_radix, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    hi = 1 << (n_bits - 1)
    a = torch.randint(-hi, hi, (m, k), generator=g, device=dev,
                      dtype=torch.int8)
    b = torch.randint(-hi, hi, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    return (stack_planes_lhs(a, n_bits, log2_radix),
            stack_planes_rhs(b, n_bits, log2_radix))


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_kernel_matches_plain_every_level(dev, m, k, n, n_bits, log2_radix):
    sa, sb = _stacks(dev, m, k, n, n_bits, log2_radix)
    for lv in [None] + list(range(2 * (n_bits // log2_radix))):
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
    with pytest.raises(ValueError, match="int16 planes"):
        kernel.l2r_gemm_stacked_planes(sa.to(torch.int16), sb.to(torch.int16),
                                       16, 4)
    with pytest.raises(ValueError, match="contiguous int8"):
        kernel.l2r_gemm_stacked_planes(sa.t().contiguous().t(), sb)
