"""Port parity for the LM backbone (ROADMAP A9a, A1/A2 leftovers): the
port's quant leftovers, ``l2r_dense``, ``dense`` on the weight cache,
norms, RoPE, attention, KV caches, each transformer layer, ``lm_forward``
and ``logits_from_hidden`` against repro's, at ``get_smoke("smollm-135m")``
(6 layers, d = 96, f32), on the same numpy inputs.  Params are built by
JAX's ``materialize`` and carried across by ``lm_params_from_jax``.

Integer parts compare bit for bit: digit planes, the weight cache's int8
codes, scales and planes, and every ``dense`` on a QuantizedWeights
record (``quantize`` is bit-matched, the int32 accumulators are exact).
Float parts hold to tolerances stated beside each test: XLA:CPU and torch
round ``rsqrt``, ``pow``, ``cos``/``sin``, ``exp`` and their sums in
other orders.  A module fed the reference's own input is held to its own
rounding; with ``l2r`` a last-bit difference ahead of a ``dense`` can move
an int8 activation code by one, which the L2R tolerances cover.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import l2r_gemm as jg
from repro.core import quant as jq
from repro.models import attention as ja
from repro.models import common as jc
from repro.models import transformer as jt
from repro.serve import engine as je
from repro_torch.configs import get_smoke
from repro_torch.core import l2r_gemm as tg
from repro_torch.core import quant as tq
from repro_torch.kernels.l2r_gemm import ops as tops
from repro_torch.models import attention as ta
from repro_torch.models import common as tc
from repro_torch.models import transformer as tt
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.serve import engine as te

ARCH = "smollm-135m"
# f32 attention: both sides walk the same KV chunks; the products and exp
# round in other orders, a few ulps of outputs of magnitude ~1
ATTN_F32 = 2e-6
# bf16 attention, elementwise |got - ref| <= 2^-7 |ref| + 1e-4: one ulp of
# the bf16 output (both sides walk the same chunks, so a last-bit f32
# difference before the output's rounding can round it to the other
# neighbour) plus an absolute floor for outputs near zero; the limit
# tests/test_torch_cuda.py's ATTN_TOL holds kernel B5 to
ATTN_BF16 = (2.0 ** -7, 1e-4)


def _assert_attn(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATTN_F32)
        return
    rel, atol = ATTN_BF16
    excess = np.abs(got - ref) - rel * np.abs(ref)
    assert excess.max() <= atol, excess.max()
# hidden states of the 6-layer smoke model, |h| <= ~4: the float path's
# f32 matmuls sum in other orders, compounded through 6 layers; the L2R
# path rounds only the norms, RoPE, softmax and dequantization
HIDDEN_F32, HIDDEN_L2R = 2e-4, 2e-5
# ... except behind an int8 activation code that rounded to its other
# neighbour: one code step (1/127 of a row's amax), carried through the
# rest of the stack and, through the KV cache, to the sequence's later
# tokens, moves those rows by a few percent of their largest |value|.
# Such rows hold to 5%; over a test at least half of the rows must keep
# the tight bound.
FLIP_L2R = 0.05


def _row_diffs(got, ref):
    """(largest |got - ref|, largest |ref|) of each row (last axis)."""
    got = np.asarray(got, np.float32).reshape(-1, ref.shape[-1])
    ref = np.asarray(ref, np.float32).reshape(-1, ref.shape[-1])
    return np.stack([np.abs(got - ref).max(-1), np.abs(ref).max(-1)], -1)


def _assert_rows(rows, l2r):
    """The float path within HIDDEN_F32 on every row; the L2R path within
    FLIP_L2R of each row's largest |value| on every row and within
    HIDDEN_L2R on at least half."""
    d, mag = np.concatenate(rows).T
    if l2r is None:
        assert d.max() <= HIDDEN_F32, d.max()
        return
    assert (d <= FLIP_L2R * mag).all(), (d / mag).max()
    assert (d <= HIDDEN_L2R).mean() >= 0.5, d


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _cfgs(l2r):
    """(reference cfg, port cfg): the smoke model, float or L2R at
    ``l2r`` levels (``"full"`` = full depth)."""
    jcfg, tcfg = j_get_smoke(ARCH), get_smoke(ARCH)
    if l2r is None:
        return jcfg, tcfg
    levels = None if l2r == "full" else l2r
    return (dataclasses.replace(jcfg, l2r=jq.QuantConfig(), l2r_levels=levels),
            dataclasses.replace(tcfg, l2r=tq.QuantConfig(), l2r_levels=levels))


@pytest.fixture(scope="module")
def params():
    jp = jc.materialize(jt.lm_build(j_get_smoke(ARCH)), jax.random.PRNGKey(0))
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


# ------------------------------------------------------------ quant leftovers
@pytest.mark.parametrize("log2_radix", [1, 2, 4])
def test_max_digit_and_from_digit_planes_bit_identical(log2_radix):
    """tests/test_online_arith.py:30 on both packages: the roundtrip is
    exact and the two inverses agree bit for bit."""
    rng = np.random.default_rng(log2_radix)
    x = np.concatenate([[-128, -1, 0, 1, 127],
                        rng.integers(-128, 128, 200)]).astype(np.int8)
    planes = np.asarray(jq.digit_planes(jnp.asarray(x), 8, log2_radix))
    ref = np.asarray(jq.from_digit_planes(jnp.asarray(planes), log2_radix))
    got = tq.from_digit_planes(torch.from_numpy(planes.copy()), log2_radix)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int32))
    assert tq.max_digit(log2_radix) == jq.max_digit(log2_radix)


# ------------------------------------------------------------------- dense
@pytest.mark.parametrize("cached", [False, True])
def test_l2r_dense_bit_identical(cached):
    """tests/test_kernel_l2r_gemm.py:123's case on both packages: the
    pair-loop L2R dense, with the weight cache and without."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 10)) * 0.2).astype(np.float32)
    j_wq = jq.quantize_weights(_j(w), jq.QuantConfig()) if cached else None
    t_wq = tq.quantize_weights(_t(w), tq.QuantConfig()) if cached else None
    ref = np.asarray(jg.l2r_dense(_j(x), None if cached else _j(w),
                                  jq.QuantConfig(), w_q=j_wq))
    got = tg.l2r_dense(_t(x), None if cached else _t(w), tq.QuantConfig(),
                       w_q=t_wq)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_l2r_dense_float_route():
    """cfg=None: a plain product, f32 sums in another order (<= 1e-6 at
    K = 32 and |x|, |w| ~ 1)."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = rng.standard_normal((32, 10)).astype(np.float32)
    ref = np.asarray(jg.l2r_dense(_j(x), _j(w), None))
    got = tg.l2r_dense(_t(x), _t(w), None).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def _quantized_pair(desc_j, desc_t, w):
    jqw = jc.quantize_tree(desc_j, w[0], jq.QuantConfig(), prestack=True)
    tqw = tc.quantize_tree(desc_t, w[1], tq.QuantConfig(), prestack=True)
    np.testing.assert_array_equal(tqw.q.numpy(), np.asarray(jqw.q))
    np.testing.assert_array_equal(tqw.scale.numpy(), np.asarray(jqw.scale))
    # the port caches B1's operand format; its raw-digit form is the
    # reference's stack
    np.testing.assert_array_equal(
        tqw.planes.with_layout(False).stack.numpy(),
        np.asarray(jqw.planes.stack))
    return jqw, tqw


@pytest.mark.parametrize("l2r", [None, "full", 5])
@pytest.mark.parametrize("which", ["wq", "wi", "flat2d", "flat3d"])
def test_dense_quantized_weights_bit_identical(params, which, l2r):
    """dense() on quantize_tree(prestack=True) records: the stacked
    weights (wq; the fused SwiGLU input wi, 3-D) sliced per layer, and
    unstacked 2-D / 3-D weights; W8A8 (l2r None), full depth and a
    5-level prefix; cache and output bit for bit."""
    jcfg, tcfg = _cfgs(l2r)
    jp, tp = params
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 96)).astype(np.float32)
    if which in ("wq", "wi"):
        sub = "mixer" if which == "wq" else "ffn"
        desc = jt.lm_build(jcfg)["stack"][0][sub][which]
        tdesc = tt.lm_build(tcfg)["stack"][0][sub][which]
        jqw, tqw = _quantized_pair(desc, tdesc, (jp["stack"][0][sub][which],
                                                 tp["stack"][0][sub][which]))
        layer = 4
        jqw = jax.tree.map(lambda a: a[layer], jqw)
        tqw = tt.layer_slice(tqw, layer)
    else:
        shape = (96, 40) if which == "flat2d" else (96, 2, 24)
        axes = ("embed", "qkv") if which == "flat2d" else \
            ("embed", None, "ffn")
        w = rng.standard_normal(shape).astype(np.float32)
        jqw, tqw = _quantized_pair(jc.Param(shape, axes),
                                   tc.Param(shape, axes), (_j(w), _t(w)))
    ref = np.asarray(jc.dense(_j(x), jqw, jcfg.l2r, jcfg.l2r_levels))
    got = tc.dense(_t(x), tqw, tcfg.l2r, tcfg.l2r_levels)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("l2r", [None, "full"])
def test_dense_float_weights(l2r):
    """A float weight: with l2r quantized per call (bit for bit), without
    a plain product (f32, 1e-5 at K = 96)."""
    jcfg, tcfg = _cfgs(l2r)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 2, 16)) / 10).astype(np.float32)
    ref = np.asarray(jc.dense(_j(x), _j(w), jcfg.l2r, jcfg.l2r_levels))
    got = tc.dense(_t(x), _t(w), tcfg.l2r, tcfg.l2r_levels).numpy()
    if l2r is None:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref)


def test_weight_caches_reach_the_gemm_in_place(params, monkeypatch):
    """prepare_params' caches are B1's operand: per-layer slices and the
    window-padded head stack are K-major views that l2r_matmul_f takes as
    they are; no call re-extracts planes from q."""
    _, tcfg = _cfgs("full")
    pp = te.prepare_params(tcfg, params[1])
    head = pp["head_q"].planes
    d, k = tcfg.l2r.planes, tcfg.d_model
    assert head.pad_planes == d - 1 and head.stack.shape == ((2 * d - 1) * k,
                                                              tcfg.vocab)
    assert head.stack.stride(0) == 1  # K-major
    assert head.matches(8, 2, ndim=2, side="rhs")
    wi = tt.layer_slice(pp["stack"][0]["ffn"]["wi"], 3).planes.stack
    assert wi.stride(0) == 1 and wi.reshape(wi.shape[0], -1).stride(0) == 1

    def no_extraction(*a, **k):
        raise AssertionError("a weight plane stack was extracted per call")

    monkeypatch.setattr(tops, "stack_planes_rhs", no_extraction)
    h = torch.randn(2, 1, tcfg.d_model)
    tt.logits_from_hidden(tcfg, pp, h)
    tt.lm_forward(tcfg, pp, tokens=torch.zeros((1, 3), dtype=torch.int32))


# ------------------------------------------------------------------ norms
def test_rms_norm_within_8_ulp():
    """8 f32 ulps of both the reference's eager and jitted forms, which
    themselves differ by more than one ulp here (XLA sums the squares in
    windows of 32, scales by f32(1/d) and fuses otherwise when jitted;
    its rsqrt is not correctly rounded), so no bound of one ulp can hold;
    torch's mean and rsqrt round otherwise again."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((500, 96)) * 2).astype(np.float32)
    g = (rng.standard_normal(96) * 0.1).astype(np.float32)
    got = tc.rms_norm(_t(x), _t(g)).numpy()
    eager = np.asarray(jc.rms_norm(_j(x), _j(g)))
    jitted = np.asarray(jax.jit(jc.rms_norm)(_j(x), _j(g)))

    def ulps(a, ref):
        return (np.abs(a - ref) / np.spacing(np.abs(ref))).max()

    assert ulps(jitted, eager) > 1
    assert ulps(got, eager) <= 8 and ulps(got, jitted) <= 8


def test_layer_norm_within_tolerance():
    """Mean and variance in other summation orders: within 1e-6 at
    |out| <= ~4, a few ulps."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((50, 96)) * 2 + 1).astype(np.float32)
    g, b = (rng.standard_normal((2, 96)) * 0.1).astype(np.float32)
    ref = np.asarray(jc.layer_norm(_j(x), _j(g), _j(b)))
    got = tc.layer_norm(_t(x), _t(g), _t(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ------------------------------------------------------------------- RoPE
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["standard", "mrope", "none"])
def test_apply_rope_within_bound(mode, dtype):
    """Positions up to 4095: torch.pow and XLA's power differ in the last
    bit of a frequency, so angles pos * freq differ by up to ~1e-6 rad and
    cos/sin by as much.  f32: within 2e-5 at |x| <= ~4;
    bf16 (cos and sin rounded to bf16 first, as in the reference): within
    one bf16 step of the largest product, 2^-6 * max|x|."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 50, 3, 64)).astype(np.float32)
    pshape = (3, 2, 50) if mode == "mrope" else (2, 50)
    pos = rng.integers(0, 4096, pshape).astype(np.int32)
    ref = np.asarray(ja.apply_rope(_j(x, getattr(jnp, dtype)), _j(pos, jnp.int32),
                                   10_000.0, mode).astype(jnp.float32))
    got = ta.apply_rope(_t(x, getattr(torch, dtype)), _t(pos, torch.int32),
                        10_000.0, mode).float().numpy()
    tol = 2e-5 if dtype == "float32" else 2.0 ** -6 * np.abs(x).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


# -------------------------------------------------------------- attention
ATTN_CASES = [
    dict(sq=40, h=4, kvh=2, dh=32, causal=True),  # GQA, one chunk
    dict(sq=40, h=4, kvh=1, dh=32, window=9, q_chunk=16, kv_chunk=8),
    dict(sq=40, h=4, kvh=4, dh=16, causal=False),
    dict(sq=40, h=6, kvh=2, dh=32, softcap=5.0, q_chunk=16, kv_chunk=8),
    dict(sq=33, h=3, kvh=1, dh=32, q_chunk=8, kv_chunk=16),  # ragged
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_chunked_attention_within_tolerance(case, dtype):
    rng = np.random.default_rng(3)
    kw = {k: v for k, v in case.items() if k not in ("sq", "h", "kvh", "dh")}
    q = rng.standard_normal((2, case["sq"], case["h"], case["dh"]))
    k, v = rng.standard_normal((2, 2, case["sq"], case["kvh"], case["dh"]))
    ref = jax.jit(lambda *a: ja.chunked_attention(*a, **kw))(
        *(_j(a, getattr(jnp, dtype)) for a in (q, k, v)))
    got = ta.chunked_attention(*(_t(a, getattr(torch, dtype))
                                 for a in (q, k, v)), **kw)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    _assert_attn(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention_ring_cache(window, dtype):
    """A 16-slot ring with empty (-1) slots, one row wrapped past the
    ring's end, another still filling."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 4, 32))
    kc, vc = rng.standard_normal((2, 2, 16, 2, 32))
    pos = np.array([[16, 17, 18, 19, 20, -1, -1, 7, 8, 9, 10, 11, 12, 13, 14,
                     15], [-1] * 10 + [4, 5, 0, 1, 2, 3]], np.int32)
    qp = np.array([20, 5], np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = ja.decode_attention(_j(q, jd), _j(kc, jd), _j(vc, jd),
                              _j(pos, jnp.int32), _j(qp, jnp.int32),
                              window=window)
    got = ta.decode_attention(_t(q, td), _t(kc, td), _t(vc, td),
                              _t(pos, torch.int32), _t(qp, torch.int32),
                              window=window)
    _assert_attn(got, ref, dtype)


@pytest.mark.parametrize("start,s", [(0, 5), (13, 6), (2, 20)])
def test_update_kv_cache_ring_writes_bit_identical(start, s):
    """Writes into an 8-slot ring: inside it, across its end, and one
    write longer than the ring (a slot keeps its last entry); the port
    writes in place and returns the same cache."""
    rng = np.random.default_rng(start)
    k, v = rng.standard_normal((2, 2, s, 2, 4)).astype(np.float32)
    pos = (start + np.arange(s)[None] + np.array([[0], [3]])).astype(np.int32)
    jcache = ja.init_kv_cache(2, 8, 2, 4, jnp.float32)
    tcache = ta.init_kv_cache(2, 8, 2, 4, torch.float32, device="cpu")
    jcache = ja.update_kv_cache(jcache, _j(k), _j(v), _j(pos, jnp.int32))
    out = ta.update_kv_cache(tcache, _t(k), _t(v), _t(pos, torch.int32))
    assert out is tcache
    for name in ("k", "v", "positions"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(jcache, name)))


# ------------------------------------------------------------ transformer
@pytest.fixture(scope="module")
def layer_inputs(params):
    """The reference's input to every layer of the stack (train mode) and
    its final hidden state, float and L2R (weights cached by
    prepare_params)."""
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, (2, 12)).astype(np.int32)
    out = {}
    for l2r in (None, "full"):
        jcfg, tcfg = _cfgs(l2r)
        jp = je.prepare_params(jcfg, params[0])
        x = jp["embed"][_j(tokens, jnp.int32)]
        pos = jnp.broadcast_to(jnp.arange(12, dtype=jnp.int32)[None], (2, 12))
        layer = jax.jit(lambda lp, x: jt.layer_apply(
            jcfg, lp, ("global", "mlp"), x, mode="train", rope_positions=pos,
            positions=pos, cache=None)[0])
        xs = [x]
        for i in range(jcfg.n_layers):
            x = layer(jax.tree.map(lambda a: a[i], jp["stack"][0]), x)
            xs.append(x)
        out[l2r] = (tokens, [np.asarray(a) for a in xs])
    return out


@pytest.mark.parametrize("layer", [0, 2, 5])
@pytest.mark.parametrize("l2r", [None, "full"])
def test_each_layer_fed_the_reference_input(params, layer_inputs, layer, l2r):
    """One layer (norm, attention, SwiGLU MLP) on the reference's own
    input, within 2e-5 of the largest |output| (the residual stream of
    random weights grows to ~1e2 by the last layer): f32 sums and rsqrt
    round otherwise; on the L2R path only the norm, RoPE, softmax and
    dequantization round, around exact integer products."""
    _, tcfg = _cfgs(l2r)
    tp = te.prepare_params(tcfg, params[1])
    _, xs = layer_inputs[l2r]
    pos = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    got, cache, aux = tt.layer_apply(
        tcfg, tt.layer_slice(tp["stack"][0], layer), ("global", "mlp"),
        _t(xs[layer]), mode="train", rope_positions=pos, positions=pos,
        cache=None)
    assert cache is None and aux == 0.0
    ref = xs[layer + 1]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("l2r", [None, "full"])
def test_lm_forward_train(params, l2r):
    jcfg, tcfg = _cfgs(l2r)
    jp, tp = je.prepare_params(jcfg, params[0]), te.prepare_params(tcfg,
                                                                   params[1])
    tokens = np.random.default_rng(8).integers(0, 512, (2, 12)).astype(
        np.int32)
    ref, _, _ = jt.lm_forward(jcfg, jp, tokens=_j(tokens, jnp.int32))
    got, state, _ = tt.lm_forward(tcfg, tp, tokens=_t(tokens, torch.int32))
    assert state is None
    _assert_rows([_row_diffs(got.numpy(), ref)], l2r)


@pytest.mark.parametrize("l2r", [None, "full"])
def test_lm_forward_prefill_then_decode(params, l2r):
    """Prefill 9 tokens into a 16-slot state, then two decode steps: the
    hidden states and the caches' k, v within the hidden-state bounds,
    the caches' positions and ``pos`` bit for bit."""
    jcfg, tcfg = _cfgs(l2r)
    jp, tp = je.prepare_params(jcfg, params[0]), te.prepare_params(tcfg,
                                                                   params[1])
    tokens = np.random.default_rng(9).integers(0, 512, (2, 11)).astype(
        np.int32)
    jst = jt.init_lm_state(jcfg, 2, 16, jnp.float32)
    tst = tt.init_lm_state(tcfg, 2, 16, torch.float32, device="cpu")
    spans = [("prefill", 0, 9), ("decode", 9, 10), ("decode", 10, 11)]
    rows = []
    steps = {m: jax.jit(lambda p, t, st, m=m: jt.lm_forward(
        jcfg, p, tokens=t, mode=m, state=st)) for m in ("prefill", "decode")}
    for mode, a, b in spans:
        ref, jst, _ = steps[mode](jp, _j(tokens[:, a:b], jnp.int32), jst)
        got, tst, _ = tt.lm_forward(tcfg, tp, tokens=_t(tokens[:, a:b],
                                                        torch.int32),
                                    mode=mode, state=tst)
        _assert_rows([_row_diffs(got.numpy(), ref)], l2r)
        np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    jc0, tc0 = jst.stack[0], tst.stack[0]
    np.testing.assert_array_equal(tc0.positions.numpy(),
                                  np.asarray(jc0.positions))
    for name in ("k", "v"):  # one row per (layer, batch, slot, kv head)
        rows.append(_row_diffs(getattr(tc0, name).numpy(),
                               getattr(jc0, name)))
    _assert_rows(rows, l2r)


@pytest.mark.parametrize("head", ["float", "l2r", "head_q"])
def test_logits_from_hidden(params, head):
    """The tied head on the same hidden states: the float product within
    1e-6, the L2R head (quantized per call, or from prepare_params'
    window-padded ``head_q`` cache) bit for bit."""
    jcfg, tcfg = _cfgs(None if head == "float" else "full")
    jp, tp = params
    if head == "head_q":
        jp, tp = je.prepare_params(jcfg, jp), te.prepare_params(tcfg, tp)
        assert "head_q" in tp
    h = np.random.default_rng(10).standard_normal((2, 3, 96)).astype(
        np.float32)
    ref = np.asarray(jt.logits_from_hidden(jcfg, jp, _j(h)))
    got = tt.logits_from_hidden(tcfg, tp, _t(h)).numpy()
    if head == "float":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)
