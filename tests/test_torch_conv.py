"""Port parity: the fused L2R conv (repro_torch.kernels.l2r_gemm.ops
against repro's).  The integer core is bit-identical; the float conv and
matmul differ at most in the last f32 bit of the dequantize multiply
(rtol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels.l2r_gemm import ops as jops
from repro_torch.core import quant as tq
from repro_torch.kernels.l2r_gemm import ops as tops

GEOMS = [  # (k, stride, dilation)
    (1, 1, 1), (1, 2, 1), (3, 1, 1), (3, 2, 1), (3, 1, 2), (3, 2, 2),
    (5, 1, 1), (5, 2, 2),
]


def _case(k, seed, cin=3, cout=5, h=9, w=7, n_bits=8):
    rng = np.random.default_rng(seed)
    hi = 1 << (n_bits - 1)
    xq = rng.integers(-hi, hi, (2, h, w, cin)).astype(np.int8)
    wf = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    return xq, wf


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("k,stride,dilation", GEOMS)
def test_conv_int_core_bit_identical(k, stride, dilation, cached):
    xq, wf = _case(k, seed=k * 10 + stride + dilation)
    configs = [(8, 2, None), (8, 1, 9)] if cached else [(8, 2, 4)]
    for (n_bits, log2_radix, levels) in configs:
        jw = jq.quantize_weights(jnp.asarray(wf), jq.QuantConfig(
            n_bits=n_bits, log2_radix=log2_radix), prestack=True,
            plane_axis=-2)
        tw = tq.quantize_weights(torch.from_numpy(wf), tq.QuantConfig(
            n_bits=n_bits, log2_radix=log2_radix), prestack=True,
            plane_axis=-2, plane_shifted=True)
        ref = np.asarray(jops._l2r_conv2d_int(
            jnp.asarray(xq), jw.planes if cached else jw.q, n_bits,
            log2_radix, levels, "jnp", (stride, stride),
            (dilation, dilation)))
        got = tops._l2r_conv2d_int(
            torch.from_numpy(xq), tw.planes if cached else tw.q, n_bits,
            log2_radix, levels, (stride, stride), (dilation, dilation))
        assert got.dtype == torch.int32 and got.shape == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref,
                                      err_msg=f"{n_bits},{log2_radix},{levels}")


@pytest.mark.parametrize("h,w", [(8, 8), (7, 5)])
def test_conv_same_geometry_matches(h, w):
    for kh in (1, 3, 5):
        for s in ((1, 1), (2, 2), (2, 1)):
            for d in ((1, 1), (2, 2)):
                assert tops._conv_same_geometry(h, w, kh, kh, s, d) == \
                    jops._conv_same_geometry(h, w, kh, kh, s, d)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("k,stride", [(3, 1), (1, 2), (5, 1)])
def test_l2r_conv2d_float_matches(k, stride, bias):
    """Quantize -> fused conv -> dequantize: only the float multiplies
    can differ, so the outputs agree to rtol 1e-6."""
    rng = np.random.default_rng(k + stride)
    x = rng.standard_normal((2, 9, 9, 4)).astype(np.float32)
    wf = rng.standard_normal((k, k, 4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32) if bias else None
    jw = jq.quantize_weights(jnp.asarray(wf), jq.QuantConfig(),
                             prestack=True, plane_axis=-2)
    ref = np.asarray(jops.l2r_conv2d(
        jnp.asarray(x), None, None if b is None else jnp.asarray(b),
        jq.QuantConfig(), 5, w_q=jw, backend="jnp", stride=stride))
    got = tops.l2r_conv2d(torch.from_numpy(x), torch.from_numpy(wf),
                          None if b is None else torch.from_numpy(b),
                          tq.QuantConfig(), 5, stride=stride)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
