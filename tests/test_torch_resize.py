"""The FC head's 7x7 resize, bit for bit against the reference.

``repro_torch.models.resize.resize_7x7`` against
``jax.image.resize(x, (B, 7, 7, C), "linear")`` as
``repro/models/cnn.py:_vgg16_trunk`` calls it: equal bits at every final
map size 1-14 (images of 32-448 px) with C = 512, batches 1, 2 and 8,
three seeds; non-square maps; the same bits when the reference runs the
trunk's tail (ReLU, pool, resize, flatten, fc6's input quantization)
under one ``jit``; fc6's quantized input equal at the 8x8 map where the
old antialiased ``F.interpolate`` quantized one value to 39 against 40;
the committed weight table rebuilt from ``jax.image.resize`` itself; and
the f32 fused multiply-add emulation against exact rational arithmetic.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.configs.vgg16_l2r import SMOKE
from repro_torch.core import quant as tq
from repro_torch.models.resize import fma_f32, resize_7x7, resize_weights
from repro_torch.models.resize_table import MAX_SIZE
from test_torch_train import _one_torch_thread  # noqa: F401


def _map(seed, batch, h, w, c=512):
    # a post-ReLU feature map, as the head receives it
    x = np.random.default_rng(seed).standard_normal((batch, h, w, c))
    return np.maximum(x, 0).astype(np.float32)


def _ref(x):
    b, _, _, c = x.shape
    return np.asarray(jax.image.resize(jnp.asarray(x), (b, 7, 7, c), "linear"))


def _bits_equal(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("size", range(1, 15))
def test_resize_bit_identical(size, batch, seed):
    x = _map(seed, batch, size, size)
    _bits_equal(resize_7x7(torch.from_numpy(x)).numpy(), _ref(x))


@pytest.mark.parametrize("hw", [(8, 10), (10, 8), (7, 9), (9, 7), (2, 14),
                                (14, 3), (1, 9), (13, 11), (11, 13)])
def test_resize_non_square_bit_identical(hw):
    """The longer side is contracted first (H on a tie); a side of 7 is
    left alone."""
    x = _map(sum(hw), 2, *hw)
    _bits_equal(resize_7x7(torch.from_numpy(x)).numpy(), _ref(x))


@pytest.mark.parametrize("size", [2, 8, 11, 14])
def test_resize_inside_jit_matches_standalone_and_port(size):
    """The trunk's tail under one jit (the last ReLU and pool, the resize,
    the flatten and fc6's input quantization, repro/models/cnn.py:136-146
    and kernels/l2r_gemm/ops.py:545) gives the standalone call's bits,
    and the port's tail gives the same resized map and quantized input."""
    x = np.random.default_rng(size).standard_normal(
        (2, 2 * size, 2 * size, 512)).astype(np.float32)
    cfg = jq.QuantConfig(n_bits=8, log2_radix=2)

    @jax.jit
    def tail(v):
        v = jax.lax.reduce_window(jax.nn.relu(v), -jnp.inf, jax.lax.max,
                                  (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
        r = jax.image.resize(v, (2, 7, 7, 512), "linear")
        return (v, r) + jq.quantize(r.reshape(2, -1), cfg, axis=0)

    pooled, resized, q, s = (np.asarray(a) for a in tail(jnp.asarray(x)))
    _bits_equal(_ref(pooled), resized)
    t = torch.nn.functional.max_pool2d(
        torch.relu(torch.from_numpy(x)).permute(0, 3, 1, 2), 2, 2)
    got = resize_7x7(t.permute(0, 2, 3, 1).contiguous())
    _bits_equal(got.numpy(), resized)
    tq_, ts = tq.quantize(got.reshape(2, -1), SMOKE.quant, axis=0)
    np.testing.assert_array_equal(tq_.numpy(), q)
    np.testing.assert_array_equal(ts.numpy(), s)


def test_fc6_quantized_input_equal_at_8x8():
    """ROADMAP C1's case: a 256x256 image's 8x8 map, seed 2.  The old
    antialiased F.interpolate gave 0.77071023 at flat (1, 3791), which
    quantized to 39; the reference's 0.77071035 quantizes to 40."""
    x = _map(2, 2, 8, 8)
    ref = _ref(x)
    got = resize_7x7(torch.from_numpy(x))
    _bits_equal(got.numpy(), ref)
    qj, sj = jax.jit(lambda v: jq.quantize(
        v, jq.QuantConfig(n_bits=8, log2_radix=2), axis=0))(
            jnp.asarray(ref.reshape(2, -1)))
    qt, st = tq.quantize(got.reshape(2, -1), SMOKE.quant, axis=0)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert int(qt[1, 3791]) == 40


def _reference_weights(size):
    # one-hot rows along H, a 1-wide W axis the reference leaves alone:
    # out[0, i, 0, c] = weight[c, i], each an exact single-term dot
    x = np.zeros((1, size, 1, size), np.float32)
    x[0, np.arange(size), 0, np.arange(size)] = 1
    y = np.asarray(jax.image.resize(jnp.asarray(x), (1, 7, 1, size), "linear"))
    return y[0, :, 0, :].T


@pytest.mark.parametrize("size", range(1, MAX_SIZE + 1))
def test_weight_table_matches_reference(size):
    got = resize_weights(size)
    assert got.shape == (size, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32),
                                  _reference_weights(size).view(np.int32))


def test_sizes_outside_the_table_raise():
    with pytest.raises(ValueError, match="map sides 1..64"):
        resize_weights(MAX_SIZE + 1)
    with pytest.raises(ValueError, match="got a side of 65"):
        resize_7x7(torch.zeros(1, 65, 65, 1))


def _exact_fma_f32(a, b, c):
    """Correctly rounded f32 a*b + c from exact rationals."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))  # within one f32 step of the answer
    cands = [np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf))]
    cands = [v for v in cands if np.isfinite(v)]
    dist = [abs(Fraction(float(v)) - exact) for v in cands]
    best = min(dist)
    ties = [v for v, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda v: int(np.array(v).view(np.int32)) & 1)


def test_fma_f32_rounds_once():
    """Random operands across magnitudes, and products that land an f32
    half-step from c (where rounding the f64 sum to f32 would round
    twice)."""
    rng = np.random.default_rng(0)
    n = 3000
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n))
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n))
    c = (rng.standard_normal(n) * 2.0 ** rng.integers(-40, 40, n))
    a, b, c = (v.astype(np.float32) for v in (a, b, c))
    # double-rounding traps: c = 1 + 2^-23 has an odd significand and
    # a*b = 2^-24 - 2^-70 falls just short of half its ulp; the f64 sum
    # rounds onto the midpoint and then, to even, away from c
    u, h = 1 + 2.0 ** -23, 2.0 ** -24 - 2.0 ** -47
    a = np.concatenate([a, np.float32([u, -u, u, u])])
    b = np.concatenate([b, np.float32([h, h, h * 2.0 ** 10, h * 2.0 ** -30])])
    c = np.concatenate([c, np.float32([u, -u, u * 2.0 ** 10, u * 2.0 ** -30])])
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    want = np.array([_exact_fma_f32(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive != want).any()  # the traps do trip a plain f64 rounding
