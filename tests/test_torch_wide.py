"""Port parity on the TPU kernels' whole domain: head widths above 128 in
kernels B5 and B4, int16 planes (n_bits 9-16) and plane counts past 8 in
B1-B3, against repro's on the same numpy inputs.

The CUDA routes themselves run on the card only (tests/test_torch_cuda.py,
chip_smoke.py phases 2, 10-11 and 25); here the plain versions they are
held to meet the reference: the Pallas kernels in interpret mode (B5, B4
at dh 256; B2's stream at D = 3 and 16), the reference's integer
accumulators of a full-width VGG-16 conv layer and of the FC head at
``QuantConfig(n_bits=12, log2_radix=4)`` (int16 planes, D = 3; fc6's K
wraps int32, as the reference's accumulator does), and
``chunked_attention`` at recurrentgemma-2b's head width; and B4's int16
byte split, as its plain version computes the score tile the kernel runs
on the int8 tensor cores, against the reference's level walk and its int32
dot of the masked operands.  Integer results
compare bit for bit; float ones to tests/test_torch_flash_attention.py's
limits: 3e-5 in f32, one output ulp (2^-7 |x|) plus 1e-4 in bf16 on the
same KV tiles.  One intra-op thread, small shapes.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.recurrentgemma_2b import SMOKE as J_SMOKE
from repro.core import l2r_gemm as jg
from repro.core import quant as jq
from repro.core.l2r_attention import attn_scores_stacked as j_scores
from repro.core.quant import stack_planes_lhs as j_lhs
from repro.core.quant import stack_planes_rhs as j_rhs
from repro.kernels import flash_attention as jfa
from repro.kernels.l2r_gemm import kernel as jk
from repro.kernels.l2r_gemm import ops as jops
from repro.models import attention as ja
from repro_torch.core import quant as tq
from repro_torch.core.quant import stack_planes_lhs as t_lhs
from repro_torch.core.quant import stack_planes_rhs as t_rhs
from repro_torch.kernels.flash_attention import kernel as tfk
from repro_torch.kernels.l2r_gemm import kernel as tk
from repro_torch.kernels.l2r_gemm import ops as tops
from repro_torch.models import attention as ta

F32_TOL = 3e-5
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-4
W12 = dict(n_bits=12, log2_radix=4)  # int16 planes, D = 3, 5 levels
DH = 256  # recurrentgemma-2b's head width


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b=1, s=64, h=2, kvh=1, dh=DH):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dh)).astype(np.float32),
            rng.standard_normal((b, s, kvh, dh)).astype(np.float32),
            rng.standard_normal((b, s, kvh, dh)).astype(np.float32))


def _close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got, ref, rtol=BF16_REL, atol=BF16_ABS)


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b5_plain_at_dh256_matches_pallas_interpret(dtype, window):
    """Kernel B5's plain version at dh 256 (causal, and a window shorter
    than the sequence) on the reference kernel's KV tiles."""
    q, k, v = _qkv(1)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jfa.flash_attention_pallas(
        *(jnp.asarray(x, jt) for x in (q, k, v)), causal=True, window=window,
        bq=16, bkv=16, interpret=True)
    got = tfk.flash_attention_kernel_plain(
        *(torch.from_numpy(x).to(tt) for x in (q, k, v)), causal=True,
        window=window, bkv=16)
    assert got.dtype == tt and got.shape == (1, 64, 2, DH)
    _close(got, ref, dtype)


@pytest.mark.parametrize("n_bits,log2_radix,levels,window", [
    (8, 2, None, None), (12, 4, None, 24), (16, 4, 3, None)])
def test_b4_plain_at_dh256_matches_pallas_interpret(n_bits, log2_radix,
                                                     levels, window):
    """Kernel B4's plain version at dh 256, int8 and int16 planes, full
    depth and truncated, on the reference kernel's KV tiles."""
    q, k, v = _qkv(2)
    ref = jfa.flash_attention_l2r_pallas(
        *(jnp.asarray(x) for x in (q, k, v)), n_bits=n_bits,
        log2_radix=log2_radix, levels=levels, causal=True, window=window,
        bq=16, bkv=16, interpret=True)
    got = tfk.flash_attention_l2r_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), n_bits, log2_radix,
        levels, True, window, bkv=16)
    _close(got, ref, "float32")


@pytest.mark.parametrize("n_bits,log2_radix,levels", [
    (12, 4, None), (12, 4, 4), (16, 1, None)])
def test_b2_plain_stream_matches_pallas_interpret(n_bits, log2_radix,
                                                  levels):
    """Kernel B2's plain stream at D = 3 and D = 16 (int16 planes, every
    level) bit for bit the reference kernel's, wrapping int32 sums
    included (full-range 16-bit operands, K = 64)."""
    rng = np.random.default_rng(n_bits + log2_radix)
    hi = 1 << (n_bits - 1)
    a = rng.integers(-hi, hi, (8, 64)).astype(np.int16)
    b = rng.integers(-hi, hi, (64, 16)).astype(np.int16)
    ref = np.asarray(jk.l2r_gemm_pallas_streaming_planes(
        j_lhs(jnp.asarray(a), n_bits, log2_radix),
        j_rhs(jnp.asarray(b), n_bits, log2_radix), n_bits, log2_radix,
        levels, bm=8, bk=32, bn=8, interpret=True))
    got = tk.l2r_gemm_streaming_planes(
        t_lhs(torch.from_numpy(a), n_bits, log2_radix),
        t_rhs(torch.from_numpy(b), n_bits, log2_radix), n_bits, log2_radix,
        levels)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_w12_conv_layer_matches_reference():
    """VGG-16's conv5_1 at full width (3x3, 512 -> 512) on a 14x14 map,
    batch 1, at n_bits 12 / radix 16: the fused conv's int32 accumulators
    bit for bit the reference's ``_l2r_conv2d_int`` (raw and pre-stacked
    int16 weights)."""
    rng = np.random.default_rng(12)
    xq = rng.integers(-2047, 2048, (1, 14, 14, 512)).astype(np.int16)
    wf = (rng.standard_normal((3, 3, 512, 512))
          * np.sqrt(2.0 / (9 * 512))).astype(np.float32)
    jw = jq.quantize_weights(jnp.asarray(wf), jq.QuantConfig(**W12),
                             prestack=True, plane_axis=-2)
    tw = tq.quantize_weights(torch.from_numpy(wf), tq.QuantConfig(**W12),
                             prestack=True, plane_axis=-2,
                             plane_shifted=True)
    assert tw.q.dtype == torch.int16
    for jrhs, trhs in ((jw.q, tw.q), (jw.planes, tw.planes)):
        ref = np.asarray(jops._l2r_conv2d_int(
            jnp.asarray(xq), jrhs, 12, 4, None, "jnp", (1, 1), (1, 1)))
        got = tops._l2r_conv2d_int(torch.from_numpy(xq), trhs, 12, 4, None,
                                   (1, 1), (1, 1))
        assert got.dtype == torch.int32 and ref.shape == (1, 14, 14, 512)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("layer,k,n", [("fc6", 25088, 4096),
                                       ("fc7", 4096, 4096),
                                       ("fc8", 4096, 1000)])
def test_w12_fc_head_matches_reference(layer, k, n):
    """The FC head at full width, one row of ReLU'd activations, n_bits 12
    / radix 16: kernel B1's and B3's plain versions (the wrappers on CPU
    tensors) bit for bit the reference's level-stacked and pair-loop int32
    accumulators.  fc6 takes non-negative weights too, so that its sums
    leave int32 and wrap, as the reference's do."""
    rng = np.random.default_rng(k + n)
    a = rng.integers(0, 2048, (1, k)).astype(np.int16)
    b = rng.integers(0 if layer == "fc6" else -2047, 2048,
                     (k, n)).astype(np.int16)
    ref = np.asarray(jg.l2r_matmul_int_stacked(jnp.asarray(a),
                                               jnp.asarray(b), **W12))
    ta_, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tk.l2r_gemm_stacked_planes(t_lhs(ta_, **W12), t_rhs(tb, **W12),
                                     **W12)
    np.testing.assert_array_equal(got.numpy(), ref, err_msg=layer)
    if layer == "fc6":
        exact = a.astype(np.int64) @ b.astype(np.int64)
        assert (exact >= 2 ** 31).all()
    if layer == "fc8":  # the pair loop, as the FC head's B3 runs it
        np.testing.assert_array_equal(
            tk.l2r_gemm_pairs(ta_, tb, **W12).numpy(),
            np.asarray(jg.l2r_matmul_int(jnp.asarray(a), jnp.asarray(b),
                                         **W12)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_at_dh256_matches_reference(dtype):
    """chunked_attention at a smoke hybrid config with recurrentgemma-2b's
    head width (head_dim 256, MQA, local window 16 < S = 40) against the
    reference's, jitted."""
    cfg = dataclasses.replace(J_SMOKE, head_dim=DH)
    q, k, v = _qkv(3, 2, 40, cfg.n_heads, cfg.n_kv, cfg.head_dim)
    kw = dict(window=cfg.window, q_chunk=16, kv_chunk=8)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax.jit(lambda *x: ja.chunked_attention(*x, **kw))(
            *(jnp.asarray(x, jt) for x in (q, k, v)))
    got = ta.chunked_attention(*(torch.from_numpy(x).to(tt)
                                 for x in (q, k, v)), **kw)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    _close(got, ref, dtype)


def _walk_prefixes():
    """(n_bits, log2_radix, levels): n_bits 12 and 16 at radix 4 and 16,
    every level prefix of the walk and full depth."""
    return [(nb, r, lv) for nb, r in ((12, 2), (12, 4), (16, 2), (16, 4))
            for lv in [*range(1, 2 * tq.plane_count(nb, r)), None]]


@pytest.mark.parametrize("n_bits,log2_radix,levels", _walk_prefixes())
def test_byte_split_scores_match_reference(n_bits, log2_radix, levels):
    """B4's int16 byte split (mask each product's operands in their raw
    16 bits, split into an s8 high and a u8 low byte, three byte-pair
    products combined mod 2^32), as ``l2r_byte_split_scores`` computes it,
    bit for bit the port's plane-stack walk (``l2r_score_tile``), the
    reference's level walk (``attn_scores_stacked``) and the reference's
    int32 dot of the masked int16 operands summed over the products; dh
    256, full-range codes with the extremes of the n_bits range."""
    rng = np.random.default_rng(100 * n_bits + log2_radix)
    hi = 1 << (n_bits - 1)
    q = rng.integers(-hi, hi, (8, DH)).astype(np.int16)
    k = rng.integers(-hi, hi, (16, DH)).astype(np.int16)
    q[0], q[1], k[0], k[1] = -hi, hi - 1, -hi, hi - 1
    tq_, tk_ = torch.from_numpy(q), torch.from_numpy(k)
    got = tfk.l2r_byte_split_scores(tq_, tk_, n_bits, log2_radix, levels)
    assert got.dtype == torch.int32 and got.shape == (8, 16)
    tile = tfk.l2r_score_tile(t_lhs(tq_, n_bits, log2_radix),
                              t_rhs(tk_, n_bits, log2_radix, axis=-1),
                              n_bits, log2_radix, levels)
    np.testing.assert_array_equal(got.numpy(), tile.numpy())
    walk = j_scores(jnp.asarray(q)[None, :, None, None],
                    jnp.asarray(k)[None, :, None], n_bits, log2_radix,
                    levels)[0, 0, 0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(walk))
    dot = jnp.zeros((8, 16), jnp.int32)
    for ma, mb in tfk.l2r_masks(n_bits, log2_radix, levels):
        qm = (q.astype(np.int32) & ma).astype(np.int16)
        km = (k.astype(np.int32) & mb).astype(np.int16)
        dot = dot + jax.lax.dot_general(
            jnp.asarray(qm), jnp.asarray(km), (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(dot))
