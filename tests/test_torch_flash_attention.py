"""Port parity: per-vector quantization, the flash attention entry point
and the plain versions of kernels B5 and B4 (repro_torch.kernels.
flash_attention) against repro's, on the same numpy inputs.

Quantized integers, scales and B4's truncated int32 score tiles compare
bit for bit, against the reference's quantization as it runs inside its
jitted kernels: compiled, XLA turns ``amax / qmax`` into a multiply by
f32(1/qmax) (the port's formula), while an eager call divides and may
differ in the last bit of a scale.  Float outputs hold to the JAX suite's tolerances
(tests/test_kernel_flash_attention.py): 3e-5 in f32 (both sides run an
online softmax, in different summation orders) and 3e-2 in bf16 (p is
rounded to bf16 before PV).  The kernels themselves run on the card only
(tests/test_torch_cuda.py, chip_smoke.py); here the Pallas kernels run
in interpret mode on one small case each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import l2r_attention as jla
from repro.core import quant as jq
from repro.kernels import flash_attention as jfa
from repro_torch.core import l2r_attention as tla
from repro_torch.core import quant as tq
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.flash_attention import kernel as tfk

CASES = [
    dict(sq=256, skv=256, h=4, kvh=2, dh=64, causal=True, window=None),
    dict(sq=256, skv=256, h=4, kvh=1, dh=64, causal=True, window=64),
    dict(sq=200, skv=200, h=2, kvh=2, dh=32, causal=True, window=None),
    dict(sq=128, skv=128, h=8, kvh=4, dh=64, causal=False, window=None),
    dict(sq=64, skv=64, h=2, kvh=2, dh=128, causal=True, window=16),
]
F32_TOL, BF16_TOL = 3e-5, 3e-2
# bf16 on the same KV tiles as the reference: one ulp of the output (at
# most 2^-7 |x|) plus 1e-4, the limit chip_smoke.py holds the kernels to
BF16_TILED_REL, BF16_TILED_ABS = 2.0 ** -7, 1e-4
_jquant = jax.jit(jla.quantize_per_vector, static_argnames="cfg")


def _qkv(rng, b, sq, skv, h, kvh, dh):
    return (rng.standard_normal((b, sq, h, dh)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, dh)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, dh)).astype(np.float32))


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _j(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


@pytest.mark.parametrize("n_bits,log2_radix", [(8, 2), (4, 1), (16, 4)])
def test_quantize_per_vector_bit_identical(n_bits, log2_radix):
    rng = np.random.default_rng(n_bits)
    x = (rng.standard_normal((2, 5, 3, 16)) * 2).astype(np.float32)
    x[0, 1, 2] = 0.0  # an all-zero vector: the scale's clamp
    x[1, 2, 0, 3] = 0.5 * np.abs(x[1, 2, 0]).max()  # a tie-prone value
    j_cfg = jq.QuantConfig(n_bits=n_bits, log2_radix=log2_radix)
    t_cfg = tq.QuantConfig(n_bits=n_bits, log2_radix=log2_radix)
    jqv, js = _jquant(jnp.asarray(x), j_cfg)
    tqv, ts = tla.quantize_per_vector(torch.from_numpy(x), t_cfg)
    assert str(tqv.dtype).split(".")[-1] == str(jqv.dtype)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("case", CASES)
def test_flash_plain_vs_oracle(case):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, case["sq"], case["skv"], case["h"], case["kvh"],
                   case["dh"])
    ref = np.asarray(jfa.attention_ref(*_j(q, k, v), causal=case["causal"],
                                       window=case["window"]))
    tq_, tk, tv = _t(q, k, v)
    for got in (tfa.flash_attention_kernel_plain(tq_, tk, tv, case["causal"],
                                                 case["window"]),
                tfa.flash_attention(tq_, tk, tv, case["causal"],
                                    case["window"]),
                tfa.attention_ref(tq_, tk, tv, case["causal"],
                                  case["window"])):
        np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL)


def test_flash_plain_bf16_vs_oracle():
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 1, 128, 128, 4, 2, 64)
    ref = jfa.attention_ref(*_j(q, k, v, dtype=jnp.bfloat16))
    got = tfa.flash_attention(*_t(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=BF16_TOL)


@pytest.mark.parametrize("dtype,window", [("float32", 24), ("bfloat16", 24),
                                          ("float32", 0)])
def test_flash_plain_vs_pallas_interpret(dtype, window):
    """window=0 masks every key: the kernel's rows come out 0 (the
    full-matrix oracle would give the mean of v; ROADMAP Queue C)."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 40, 40, 4, 2, 16)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jfa.flash_attention_pallas(*_j(q, k, v, dtype=jt), causal=True,
                                     window=window, bq=16, bkv=16,
                                     interpret=True)
    got = tfa.flash_attention_kernel_plain(*_t(q, k, v, dtype=tt),
                                           causal=True, window=window,
                                           bkv=16)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=BF16_TILED_REL, atol=BF16_TILED_ABS)


B4_SHAPE = (1, 16, 2, 1, 8)  # b, s, h, kvh, dh of tests/test_l2r_attention.py


@pytest.mark.parametrize("levels", [1, 4, None])
def test_flash_l2r_plain_vs_pallas_interpret(levels):
    b, s, h, kvh, dh = B4_SHAPE
    q, k, v = _qkv(np.random.default_rng(16), b, s, s, h, kvh, dh)
    ref = jfa.flash_attention_l2r_pallas(*_j(q, k, v), levels=levels, bq=8,
                                         bkv=8, interpret=True)
    tq_, tk, tv = _t(q, k, v)
    for got in (tfa.flash_attention_l2r_plain(tq_, tk, tv, levels=levels,
                                              bkv=8),
                tfa.flash_attention_l2r(tq_, tk, tv, levels=levels)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=F32_TOL)


@pytest.mark.parametrize("levels", [0, 1, 4, None])
def test_flash_l2r_score_tile_bit_identical(levels):
    """B4's int32 score tile after ``levels`` levels equals the
    reference's quantized-score walk (attn_scores_stacked)."""
    b, s, h, kvh, dh = B4_SHAPE
    q, k, _ = _qkv(np.random.default_rng(16), b, s, s, h, kvh, dh)
    g = h // kvh
    cfg = jq.QuantConfig()
    qq, _ = _jquant(jnp.asarray(q), cfg)
    kq, _ = _jquant(jnp.asarray(k), cfg)
    ref = jla.attn_scores_stacked(qq.reshape(b, s, kvh, g, dh), kq,
                                  levels=levels)  # (B, Kv, G, Q, S)
    q_stack, _, k_stack, _ = tfk.l2r_operands(*_t(q, k))
    np.testing.assert_array_equal(
        q_stack.numpy(), np.asarray(jq.stack_planes_lhs(qq)))
    np.testing.assert_array_equal(
        k_stack.numpy(), np.asarray(jq.stack_planes_rhs(kq, axis=-1)))
    got = tfk.l2r_score_tile(
        q_stack.reshape(b, s, kvh, g, -1).permute(0, 2, 3, 1, 4),
        k_stack.permute(0, 2, 1, 3).unsqueeze(2), levels=levels)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n_bits,log2_radix", [(8, 2), (4, 2)])
def test_b4_masks_of_raw_operands_equal_the_plane_stacks(n_bits, log2_radix):
    """Kernel B4 gets the raw per-vector-quantized q and k
    (``l2r_kernel_operands``, padded to the kernel's head width): each product's
    byte masks cut out exactly the sum of ``l2r_operands``' pre-shifted
    planes it stands for, and the masked products sum to the level
    walk's score tile at every ``levels``."""
    from repro_torch.core.online import msdf_products

    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 9, 11, 2, 1, 24))
    qq, qs, kq, ks, vp = tfk.l2r_kernel_operands(q, k, v, n_bits, log2_radix)
    # dh = 24 goes to the kernel zero-padded to 32
    for x, ref in ((qq, None), (kq, None), (vp, v)):
        assert x.shape[-1] == 32 and not x[..., 24:].any()
        assert ref is None or torch.equal(x[..., :24], ref)
    qq, kq = qq[..., :24], kq[..., :24]
    q_stack, qs2, k_stack, ks2 = tfk.l2r_operands(q, k, n_bits, log2_radix)
    assert torch.equal(qs, qs2) and torch.equal(ks, ks2)
    d, dh = n_bits // log2_radix, q.shape[-1]
    k_asc = torch.cat([k_stack[..., (d - 1 - j) * dh:(d - j) * dh]
                       for j in range(d)], dim=-1)

    def planes(stack, lo, hi):
        return sum(stack[..., i * dh:(i + 1) * dh].to(torch.int64)
                   for i in range(lo, hi + 1))

    def masked(x, mask):
        return (x.to(torch.int32) & mask).to(torch.uint8).view(
            torch.int8).to(torch.int64)

    qt = q_stack.permute(0, 2, 1, 3)  # (B, H, Sq, D*dh): head 1 meets kv 0
    for lv in [None] + list(range(2 * d)):
        masks = tfk.l2r_masks(n_bits, log2_radix, lv)
        prods = msdf_products(d, lv)
        assert len(masks) == len(prods) <= d
        s = torch.zeros((1, 2, 9, 11), dtype=torch.int64)
        for (ma, mb), (il, ih, jl, jh) in zip(masks, prods):
            assert torch.equal(masked(qq, ma), planes(q_stack, il, ih))
            assert torch.equal(masked(kq, mb), planes(k_asc, jl, jh))
            s += (masked(qq, ma).permute(0, 2, 1, 3)
                  @ masked(kq, mb).permute(0, 2, 3, 1))
        ref = tfk.l2r_score_tile(qt, k_stack.permute(0, 2, 1, 3), n_bits,
                                 log2_radix, lv)
        assert torch.equal(s.to(torch.int32), ref), lv
    assert [tfk.l2r_width(w) for w in (16, 24, 32, 33, 64, 100, 128)] == \
        [32, 32, 32, 64, 64, 128, 128]


# ---- kernel B5's f32 route, emulated in torch.  A test aid (nothing on the
# main path calls it): both products as the tensor cores take them.
def _tf32(x):
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10
    mantissa bits (the sign is its own bit, so adding half an ulp of the
    kept bits to the pattern rounds the magnitude)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def _tf32_matmul(a, b, split: bool):
    """a @ b on TF32 operands: one product of the rounded operands, or the
    3xTF32 split x = big + small, a.b ~ small_a.big_b + big_a.small_b +
    big_a.big_b (each TF32 x TF32 product exact in f32)."""
    ab, bb = _tf32(a), _tf32(b)
    if not split:
        return ab @ bb
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return (as_ @ bb + ab @ bs) + ab @ bb


def _b5_f32_emulated(q, k, v, split: bool, bkv: int = tfk.KV_TILE):
    """Causal attention with the kernel's online softmax over 64-key tiles,
    QK^T and PV through _tf32_matmul; q (B, S, H, dh), k, v (B, S, Kv, dh)."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    qt = q.reshape(b, s, kvh, h // kvh, dh).permute(0, 2, 3, 1, 4)
    kt, vt = (x.permute(0, 2, 1, 3).unsqueeze(2) for x in (k, v))
    m = torch.full(qt.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(qt.shape)
    pos = torch.arange(s)
    for lo in range(0, s, bkv):
        hi = min(lo + bkv, s)
        mask = pos[lo:hi][None, :] <= pos[:, None]
        sc = _tf32_matmul(qt, kt[..., lo:hi, :].transpose(-1, -2), split)
        sc = torch.where(mask, sc / np.sqrt(dh).astype(np.float32), -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(sc - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _tf32_matmul(p, vt[..., lo:hi, :], split)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh)


def test_b5_f32_3xtf32_split_holds_3e_5_and_one_tf32_does_not():
    """On a small SmolLM-shaped input (2 heads over 1 kv head, dh = 64,
    causal, S = 128), attention with both products split three ways stays
    within 3e-5 of the plain version; with one TF32 product each it does
    not, so the limit sees the difference."""
    rng = np.random.default_rng(15)
    q, k, v = _t(*_qkv(rng, 1, 128, 128, 2, 1, 64))
    ref = tfa.flash_attention_kernel_plain(q, k, v, causal=True)
    split = (_b5_f32_emulated(q, k, v, split=True) - ref).abs().max().item()
    single = (_b5_f32_emulated(q, k, v, split=False) - ref).abs().max().item()
    assert split <= F32_TOL < single, (split, single)
    # ties go away from zero (round-to-even would give 1.0), the rest to
    # the nearer of the 10-bit neighbours
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -12),
                      1.0 + 2.0 ** -12])
    assert _tf32(x).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
