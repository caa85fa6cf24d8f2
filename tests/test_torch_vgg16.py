"""The slice end to end: full-width VGG-16 (all 13 convs and fc6-fc8 at
their published widths, 10 classes) at 32x32, batch 2, through the port
and through the reference, with the reference test's own fixture
(tests/test_vgg16.py) passed across by value.

Tolerances: the L2R path's integer accumulators are bit-identical, so
the logits can differ only through float rounding in the dequantize and
bias steps: max|Δ| <= 1e-5 * max|logit|, same argmax.  The float path's
conv sums run in another order (oneDNN vs XLA), so it holds to rtol
1e-4.  The 32x32 map reaches the head at 1x1 and is upsampled to 7x7;
the port's resize (models/resize.py) gives ``jax.image.resize``'s bits
at every map size, so on this input the L2R logits agree bit for bit;
the tolerance above is what the test holds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QuantConfig as JCfg
from repro.models.cnn import vgg16_apply as j_apply
from repro.models.cnn import vgg16_build as j_build
from repro.models.common import materialize
from repro_torch.configs.vgg16_l2r import SMOKE
from repro_torch.models.cnn import VGG16, _resize_7x7, vgg16_apply, vgg16_shapes
from repro_torch.models.convert import params_from_jax


@pytest.fixture(scope="module")
def run():
    params = materialize(j_build(n_classes=10), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref_l2r = np.asarray(j_apply(params, jnp.asarray(img), l2r=JCfg()))
    ref_f = np.asarray(j_apply(params, jnp.asarray(img)))
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    model = VGG16(tp, l2r=SMOKE.quant)
    got_l2r = model(torch.from_numpy(img)).numpy()
    got_f = vgg16_apply(tp, torch.from_numpy(img), device="cpu").numpy()
    return ref_l2r, got_l2r, ref_f, got_f, params, tp


def test_param_tree_crosses_by_value(run):
    *_, params, tp = run
    assert set(tp) == set(params)
    for name, shape in vgg16_shapes(10).items():
        assert tuple(tp[name]["w"].shape) == shape == params[name]["w"].shape
        np.testing.assert_array_equal(tp[name]["w"].numpy(),
                                      np.asarray(params[name]["w"]))


def test_l2r_logits_match_reference(run):
    ref, got, *_ = run
    assert got.shape == (2, 10) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_float_logits_match_reference(run):
    _, _, ref, got, *_ = run
    assert got.shape == (2, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("size", [1, 2, 3, 7, 9, 14])
def test_head_resize_matches_reference(size):
    """The head's 7x7 resize against jax.image.resize "linear": equal bits
    at every size (tests/test_torch_resize.py covers sizes 1-14 at the
    head's width)."""
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 8)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 7, 7, 8), "linear"))
    got = _resize_7x7(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


# 224x224 (the paper's size), one layer at a time: the whole network at
# 224 is the card's (chip_smoke.py phase 3), against the port's own plain
# GEMM; here two of its conv layers meet the reference itself
@pytest.mark.parametrize("layer,cin", [("conv1_1", 3), ("conv1_2", 64)])
def test_conv_layer_at_224_matches_reference(layer, cin):
    """One VGG-16 conv layer at 224x224, batch 1, He-normal weights of its
    shape (3x3, ``cin`` -> 64): the integer accumulators of the fused L2R
    conv bit for bit the reference's ``_l2r_conv2d_int`` (raw and
    pre-stacked weights), and ``l2r_conv2d``'s dequantized output (the
    input quantized inside the call) to rtol 1e-6 (the float multiplies,
    as tests/test_torch_conv.py)."""
    from repro.core import quant as jq
    from repro.kernels.l2r_gemm import ops as jops
    from repro_torch.core import quant as tq
    from repro_torch.kernels.l2r_gemm import ops as tops

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rng = np.random.default_rng(cin)
        x = rng.standard_normal((1, 224, 224, cin)).astype(np.float32)
        if cin > 3:  # a ReLU'd activation map
            x = np.maximum(x, 0)
        wf = (rng.standard_normal((3, 3, cin, 64))
              * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        xq = rng.integers(-128, 128, x.shape).astype(np.int8)
        jw = jq.quantize_weights(jnp.asarray(wf), jq.QuantConfig(),
                                 prestack=True, plane_axis=-2)
        tw = tq.quantize_weights(torch.from_numpy(wf), tq.QuantConfig(),
                                 prestack=True, plane_axis=-2,
                                 plane_shifted=True)
        for jrhs, trhs in ((jw.q, tw.q), (jw.planes, tw.planes)):
            ref = np.asarray(jops._l2r_conv2d_int(
                jnp.asarray(xq), jrhs, 8, 2, None, "jnp", (1, 1), (1, 1)))
            got = tops._l2r_conv2d_int(torch.from_numpy(xq), trhs, 8, 2,
                                       None, (1, 1), (1, 1))
            assert ref.shape == (1, 224, 224, 64)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=layer)
        ref = np.asarray(jops.l2r_conv2d(jnp.asarray(x), None, None,
                                         jq.QuantConfig(), None, w_q=jw,
                                         backend="jnp"))
        got = tops.l2r_conv2d(torch.from_numpy(x), torch.from_numpy(wf),
                              None, tq.QuantConfig(), None)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    finally:
        torch.set_num_threads(n)
