"""Port parity: the progressive-precision slice (repro_torch.core.progressive,
the progressive ops, the plain versions of kernels B2 and B3, the
prototype head and vgg16_classify_progressive) against repro's, on the
same numpy inputs.

Integer prefixes, tail bounds, committed classes and exit levels compare
bit for bit.  Float logits compare bit for bit where both sides run the
same dequantization (the streaming head against the one-shot fc8 layer
of the same package); across the packages the VGG-16 trunk's float
activations may differ by an f32 ulp in the dequantize and bias steps,
so the logits there hold to max|d| <= 1e-5 * max|logit| (the tolerance
of tests/test_torch_vgg16.py).  Kernels B2 and B3 themselves run on the
card only (tests/test_torch_cuda.py, chip_smoke.py); here their plain
versions are held against the Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import progressive as jp
from repro.core import quant as jq
from repro.kernels.l2r_gemm import kernel as jk
from repro.kernels.l2r_gemm import ops as jops
from repro_torch.core import progressive as tp
from repro_torch.core import quant as tq
from repro_torch.kernels.l2r_gemm import kernel as tk
from repro_torch.kernels.l2r_gemm import ops as tops
from test_torch_train import _one_torch_thread  # noqa: F401

CONFIGS = [(4, 1), (4, 2), (8, 1), (8, 2), (8, 4)]
RAGGED = [(13, 37, 11), (1, 64, 16)]


def _ints(rng, n_bits, shape):
    hi = 1 << (n_bits - 1)
    return rng.integers(-hi, hi, shape).astype(np.int8)


def _levels(n_bits, log2_radix):
    return [None] + list(range(2 * (n_bits // log2_radix)))


def _eq(t, ref, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref), err_msg=msg)


# ----------------------------------------------------- the prefix stream
@pytest.mark.parametrize("m,k,n", RAGGED)
@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
def test_prefix_stream_bit_identical(n_bits, log2_radix, m, k, n):
    """streaming_matmul_scan(emit=True), progressive_matmul and
    l2r_gemm_progressive: every prefix, bound and decision level."""
    rng = np.random.default_rng(n_bits * 10 + log2_radix + m)
    a, b = _ints(rng, n_bits, (m, k)), _ints(rng, n_bits, (k, n))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for lv in _levels(n_bits, log2_radix):
        msg = f"levels={lv}"
        j_acc, _, j_st = jp.streaming_matmul_scan(ja, jb, None, None, n_bits,
                                                  log2_radix, lv, emit=True)
        t_acc, _, t_st = tp.streaming_matmul_scan(ta, tb, None, None, n_bits,
                                                  log2_radix, lv, emit=True)
        _eq(t_st, j_st, msg)
        _eq(t_acc, j_acc, msg)
        ref = jp.progressive_matmul(ja, jb, n_bits, log2_radix, lv)
        for got in (tp.progressive_matmul(ta, tb, n_bits, log2_radix, lv),
                    tops.l2r_gemm_progressive(ta, tb, n_bits, log2_radix,
                                              lv)):
            for g, r in zip(got, ref):
                _eq(g, r, msg)
        if lv != 0:
            _eq(tp.earliest_decision_level(got),
                jp.earliest_decision_level(ref), msg)


def test_prefix_stream_from_prestacked_operands():
    """Window-padded and pre-shifted PlaneOperands feed the same stream."""
    rng = np.random.default_rng(3)
    a, b = _ints(rng, 8, (6, 20)), _ints(rng, 8, (20, 9))
    ref = np.asarray(jp.progressive_matmul(jnp.asarray(a), jnp.asarray(b))
                     .partial)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for pad in (False, True):
        for shifted in (False, True):
            pa = tq.PlaneOperands.prepare_lhs(ta, shifted=shifted,
                                              window_pad=pad)
            pb = tq.PlaneOperands.prepare_rhs(tb, shifted=shifted,
                                              window_pad=pad)
            _eq(tp.progressive_matmul(pa, pb).partial, ref,
                f"pad={pad} shifted={shifted}")
    with pytest.raises(ValueError, match="re-prepare"):
        tp.streaming_matmul_scan(ta, tq.PlaneOperands.prepare_rhs(tb, 8, 4))


@pytest.mark.parametrize("n_bits,log2_radix", [(8, 2), (8, 4), (4, 2)])
def test_cuda_walk_matches_reference_through_plain_versions(n_bits,
                                                            log2_radix):
    """ops.CUDA_WALK, the route CUDA operands take (one B2 stream, or one
    B1 level slab per while step), on CPU tensors, where its kernel
    wrappers take their plain versions: the reference's prefixes, with a
    (2, 5) LHS lead and a raw or pre-stacked RHS."""
    rng = np.random.default_rng(7 + n_bits + log2_radix)
    a, b = _ints(rng, n_bits, (2, 5, 19)), _ints(rng, n_bits, (19, 6))
    ref = np.asarray(jp.progressive_matmul(jnp.asarray(a), jnp.asarray(b),
                                           n_bits, log2_radix).partial)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for rhs in (tb, tq.PlaneOperands.prepare_rhs(tb, n_bits, log2_radix)):
        _eq(tops.CUDA_WALK.stream(ta, rhs, n_bits, log2_radix, None), ref)
        advance = tops.CUDA_WALK.stepper(ta, rhs, n_bits, log2_radix, None)
        acc = torch.zeros(ref.shape[1:], dtype=torch.int32)
        for t in range(ref.shape[0]):
            acc = advance(acc, t)
            _eq(acc, ref[t], f"level {t}")


@pytest.mark.parametrize("side", ["lhs", "rhs"])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_layout_matches_reference(side, shifted):
    """PlaneOperands(window_pad=) stacks, their window and core stacks,
    and quantize_weights(window_pad=) equal the reference's."""
    rng = np.random.default_rng(4)
    x = _ints(rng, 8, (5, 12))
    jprep = getattr(jq.PlaneOperands, f"prepare_{side}")
    tprep = getattr(tq.PlaneOperands, f"prepare_{side}")
    j = jprep(jnp.asarray(x), 8, 2, shifted=shifted, window_pad=True)
    t = tprep(torch.from_numpy(x), 8, 2, shifted=shifted, window_pad=True)
    assert (t.pad_planes, t.k, t.axis) == (j.pad_planes, j.k, j.axis)
    _eq(t.stack, j.stack)
    _eq(t.window_stack(), j.window_stack())
    for sh in (False, True):
        _eq(t.core_stack(sh), j.core_stack(sh))
        _eq(t.with_layout(sh).stack, j.with_layout(sh).stack)
    w = np.random.default_rng(5).standard_normal((3, 3, 4, 6)) \
        .astype(np.float32)
    jw = jq.quantize_weights(jnp.asarray(w), jq.QuantConfig(), prestack=True,
                             plane_axis=-2, window_pad=True,
                             plane_shifted=shifted)
    tw = tq.quantize_weights(torch.from_numpy(w), tq.QuantConfig(),
                             prestack=True, plane_axis=-2, window_pad=True,
                             plane_shifted=shifted)
    _eq(tw.planes.stack, jw.planes.stack)
    _eq(tw.planes.window_stack(), jw.planes.window_stack())


def test_level_bounds_and_guard():
    """The three bound forms, including levels whose bound leaves the
    int32 decision range (undecidable, never compared lossily)."""
    for d, lr, k, lv in ((4, 2, 37, None), (8, 1, 300, 5), (4, 2, 1 << 20,
                                                            None)):
        ref = jp.level_bounds(d, lr, k, lv)
        got = tp.level_bounds(d, lr, k, lv)
        assert got.exact == ref.exact
        for name in ("f32", "i32", "decidable"):
            _eq(getattr(got, name), getattr(ref, name), name)
    bounds = tp.level_bounds(4, 2, 1 << 20)
    assert not bool(bounds.decidable.all()) and bool(bounds.decidable.any())
    n = len(bounds.exact)
    partial = torch.zeros((n, 1, 2), dtype=torch.int32)
    partial[:, 0, 0] = 2**31 - 1
    res = tp.ProgressiveResult(partial, bounds.f32, bounds.i32,
                               bounds.decidable)
    jres = jp.ProgressiveResult(jnp.asarray(partial.numpy()),
                                *jp.level_bounds(4, 2, 1 << 20)[:3])
    _eq(tp.earliest_decision_level(res), jp.earliest_decision_level(jres))


# --------------------------------------------------- the early-exit loop
@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
def test_while_full_run_and_fold_stop(n_bits, log2_radix):
    """A full while run equals the scan; a fold that declares itself
    done after `stop` levels halts there with the scan's prefix."""
    rng = np.random.default_rng(n_bits + 7 * log2_radix)
    a, b = _ints(rng, n_bits, (9, 21)), _ints(rng, n_bits, (21, 7))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    d = n_bits // log2_radix
    acc, _, t = tp.streaming_matmul_while(ta, tb, n_bits=n_bits,
                                          log2_radix=log2_radix)
    assert t == 2 * d - 1
    _, _, stack = tp.streaming_matmul_scan(ta, tb, n_bits=n_bits,
                                           log2_radix=log2_radix, emit=True)
    torch.testing.assert_close(acc, stack[-1], rtol=0, atol=0)
    for stop in (1, d, 2 * d - 1):
        j_acc, j_cnt, j_t = jp.streaming_matmul_while(
            jnp.asarray(a), jnp.asarray(b), lambda c, p, i: c + 1,
            jnp.int32(0), lambda c: c >= stop, n_bits, log2_radix)
        acc, cnt, t = tp.streaming_matmul_while(
            ta, tb, lambda c, p, i: c + 1, 0, lambda c: c >= stop, n_bits,
            log2_radix)
        assert t == cnt == int(j_t) == int(j_cnt) == stop
        _eq(acc, j_acc, f"stop={stop}")
        _eq(acc, stack[stop - 1].numpy())


@pytest.mark.parametrize("levels", [0, 3, None])
def test_while_levels_truncation(levels):
    rng = np.random.default_rng(0)
    a, b = _ints(rng, 8, (6, 18)), _ints(rng, 8, (18, 5))
    j_acc, _, j_t = jp.streaming_matmul_while(jnp.asarray(a), jnp.asarray(b),
                                              levels=levels)
    acc, _, t = tp.streaming_matmul_while(torch.from_numpy(a),
                                          torch.from_numpy(b), levels=levels)
    assert t == int(j_t) == (7 if levels is None else levels)
    _eq(acc, j_acc)
    _eq(tp.l2r_matmul_int_streaming(torch.from_numpy(a), torch.from_numpy(b),
                                    levels=levels, early_exit=True), j_acc)


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("levels", [None, 3, 0])
def test_streaming_schedule_dispatch(levels, early_exit):
    rng = np.random.default_rng(5)
    a, b = _ints(rng, 8, (20, 40)), _ints(rng, 8, (40, 12))
    ref = jops.l2r_gemm(jnp.asarray(a), jnp.asarray(b), levels=levels,
                        schedule="streaming", backend="jnp",
                        early_exit=early_exit)
    got = tops.l2r_gemm(torch.from_numpy(a), torch.from_numpy(b),
                        levels=levels, schedule="streaming",
                        early_exit=early_exit)
    _eq(got, ref)


@pytest.mark.parametrize("bias_on", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_streaming_argmax_matches_reference(seed, bias_on):
    """Logits, committed tokens and exit levels, scan and while, bit for
    bit; the while logits' argmax is the committed token."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 10)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(10).astype(np.float32) if bias_on else None
    jx, jxs = jq.quantize(jnp.asarray(x), jq.QuantConfig(), axis=0)
    jw = jq.quantize_weights(jnp.asarray(w), jq.QuantConfig())
    tx, txs = tq.quantize(torch.from_numpy(x), tq.QuantConfig(), axis=0)
    tw = tq.quantize_weights(torch.from_numpy(w), tq.QuantConfig())
    for early_exit in (False, True):
        ref = jp.streaming_argmax(
            jx, jw.q, jxs, jw.scale, early_exit=early_exit,
            bias=None if bias is None else jnp.asarray(bias))
        got = tp.streaming_argmax(
            tx, tw.q, txs, tw.scale, early_exit=early_exit,
            bias=None if bias is None else torch.from_numpy(bias))
        for g, r in zip(got, ref):
            _eq(g, r, f"early_exit={early_exit}")
    _eq(got[0].argmax(-1).to(torch.int32), got[1].numpy())


def test_all_rows_undecidable_runs_every_level():
    """Tied weight columns: margin 0 forever, every level runs, and even
    the while loop's logits equal the scan's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    w = rng.standard_normal((32, 8)).astype(np.float32) * 0.3
    w[:] = w[:, :1]
    tx, txs = tq.quantize(torch.from_numpy(x), tq.QuantConfig(), axis=0)
    tw = tq.quantize_weights(torch.from_numpy(w), tq.QuantConfig())
    scan = tp.streaming_argmax(tx, tw.q, txs, tw.scale)
    early = tp.streaming_argmax(tx, tw.q, txs, tw.scale, early_exit=True)
    assert bool((early[2] == 6).all())
    for s, e in zip(scan, early):
        torch.testing.assert_close(e, s, rtol=0, atol=0)


# ------------------------------------------- plain versions of B2 and B3
@pytest.mark.parametrize("level_count", [1, 3, 7])
def test_b2_plain_matches_pallas_interpret(level_count):
    """B2's plain version against the TPU kernel it replaces, in
    interpret mode, on one block (128, 256, 128); planes below the
    dynamic level count equal the full run."""
    rng = np.random.default_rng(6)
    a, b = _ints(rng, 8, (128, 256)), _ints(rng, 8, (256, 128))
    ref = np.asarray(jk.l2r_gemm_pallas_streaming_planes(
        jq.stack_planes_lhs(jnp.asarray(a)), jq.stack_planes_rhs(
            jnp.asarray(b)), interpret=True,
        level_count=jnp.int32(level_count)))
    sa = tq.stack_planes_lhs(torch.from_numpy(a))
    sb = tq.stack_planes_rhs(torch.from_numpy(b))
    for fn in (tk.l2r_gemm_streaming_planes_plain,
               tk.l2r_gemm_streaming_planes):
        got = fn(sa, sb, level_count=level_count)
        _eq(got[:level_count], ref[:level_count], fn.__name__)


def test_b2_plain_accumulates_and_truncates():
    rng = np.random.default_rng(7)
    a, b = _ints(rng, 8, (7, 19)), _ints(rng, 8, (19, 5))
    sa = tq.stack_planes_lhs(torch.from_numpy(a))
    sb = tq.stack_planes_rhs(torch.from_numpy(b))
    for lv in _levels(8, 2):
        ref = jp.progressive_matmul(jnp.asarray(a), jnp.asarray(b),
                                    levels=lv).partial
        out = torch.full(tuple(ref.shape), 9, dtype=torch.int32)
        assert tk.l2r_gemm_streaming_planes(sa, sb, levels=lv,
                                            out=out) is out
        _eq(out, np.asarray(ref) + 9, f"levels={lv}")
    t = tk.streaming_schedule(4, 3, None)
    for g, r in zip(t, jk.streaming_schedule(4, 3, None)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("levels", [None, 3])
def test_b3_plain_matches_pallas_interpret(levels):
    """B3's plain version against the TPU pair-loop kernel in interpret
    mode, on one block (128, 256, 128)."""
    rng = np.random.default_rng(8)
    a, b = _ints(rng, 8, (128, 256)), _ints(rng, 8, (256, 128))
    ref = np.asarray(jk.l2r_gemm_pallas(jnp.asarray(a), jnp.asarray(b),
                                        levels=levels, interpret=True))
    for fn in (tk.l2r_gemm_pairs_plain, tk.l2r_gemm_pairs):
        _eq(fn(torch.from_numpy(a), torch.from_numpy(b), levels=levels), ref,
            fn.__name__)


# ------------------------------------------------------- progressive conv
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_progressive_matches_reference(stride):
    """l2r_conv2d_progressive and _while against the reference's jnp
    backend on a (1, 8, 8, 8) -> 16 conv: prefixes, bounds, scales, and
    a fold-stopped while run."""
    rng = np.random.default_rng(9 + stride)
    x = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, 16)) * 0.2).astype(np.float32)
    jc, tc = jq.QuantConfig(), tq.QuantConfig()
    j_res, j_scale = jops.l2r_conv2d_progressive(
        jnp.asarray(x), jnp.asarray(w), jc, backend="jnp", stride=stride)
    tw = tq.quantize_weights(torch.from_numpy(w), tc, prestack=True,
                             plane_axis=-2, plane_shifted=True)
    for w_kw in ({"w": torch.from_numpy(w)}, {"w_q": tw}):
        t_res, t_scale = tops.l2r_conv2d_progressive(
            torch.from_numpy(x), cfg=tc, stride=stride, **w_kw)
        for g, r in zip(t_res, j_res):
            _eq(g, r)
        _eq(t_scale, j_scale)
    for lv in (3, 0):
        j_int = jops._l2r_conv2d_progressive_int(
            jnp.asarray(tq.quantize(torch.from_numpy(x), tc, axis=0)[0]
                        .numpy()), jq.quantize_weights(jnp.asarray(w), jc).q,
            8, 2, lv, "jnp", (stride, stride))
        t_int = tops._l2r_conv2d_progressive_int(
            tq.quantize(torch.from_numpy(x), tc, axis=0)[0], tw.planes, 8, 2,
            lv, (stride, stride))
        _eq(t_int, j_int, f"levels={lv}")
    for stop in (None, 3):
        done = None if stop is None else (lambda c: c >= stop)
        j_acc, j_c, j_t, j_sc = jops.l2r_conv2d_progressive_while(
            jnp.asarray(x), jnp.asarray(w), jc, lambda c, p, i: c + 1,
            jnp.int32(0), done, backend="jnp", stride=stride)
        t_acc, t_c, t_t, t_sc = tops.l2r_conv2d_progressive_while(
            torch.from_numpy(x), None, tc, lambda c, p, i: c + 1, 0, done,
            w_q=tw, stride=stride)
        assert t_t == t_c == int(j_t) == int(j_c)
        _eq(t_acc, j_acc, f"stop={stop}")
        _eq(t_sc, j_sc)


def test_prototype_head_operands_match_reference():
    from repro.models.protohead import prototype_head as j_head
    from repro_torch.models.protohead import prototype_head as t_head

    jx, jxs, jw, jl = j_head(np.random.default_rng(44), 64, 12, 9)
    tx, txs, tw, tl = t_head(np.random.default_rng(44), 64, 12, 9,
                             device="cpu")
    np.testing.assert_array_equal(tl, jl)
    for g, r in ((tx, jx), (txs, jxs), (tw.q, jw.q), (tw.scale, jw.scale)):
        _eq(g, r)
    for early_exit in (False, True):
        ref = jp.streaming_argmax(jx, jw.q, jxs, jw.scale,
                                  early_exit=early_exit)
        got = tp.streaming_argmax(tx, tw.q, txs, tw.scale,
                                  early_exit=early_exit)
        for g, r in zip(got, ref):
            _eq(g, r)
    assert int(got[2].max()) < 6  # decisive margins exit early


# ------------------------------------------------------------ end to end
@pytest.fixture(scope="module")
def classify():
    """Full-width VGG-16 (10 classes) at 32x32, batch 2: the reference's
    one-shot and progressive forwards, and the port's on params crossed
    by value; each package's weight cache is built once."""
    from repro.models.cnn import vgg16_apply as j_apply
    from repro.models.cnn import vgg16_build as j_build
    from repro.models.cnn import vgg16_classify_progressive as j_classify
    from repro.models.cnn import vgg16_quantize_weights as j_cache
    from repro.models.common import materialize
    from repro_torch.models.cnn import (vgg16_apply, vgg16_classify_progressive,
                                        vgg16_quantize_weights)
    from repro_torch.models.convert import params_from_jax

    params = materialize(j_build(n_classes=10), jax.random.PRNGKey(0))
    img = np.random.default_rng(0).standard_normal((2, 32, 32, 3)) \
        .astype(np.float32)
    jc, tc = jq.QuantConfig(), tq.QuantConfig()
    jwq = j_cache(params, jc)
    ref = {"apply": np.asarray(j_apply(params, jnp.asarray(img), l2r=jc,
                                       weights_q=jwq))}
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    twq = vgg16_quantize_weights(tparams, tc)
    timg = torch.from_numpy(img)
    got = {"apply": vgg16_apply(tparams, timg, l2r=tc, weights_q=twq,
                                device="cpu").numpy()}
    for early_exit in (False, True):
        ref[early_exit] = [np.asarray(v) for v in j_classify(
            params, jnp.asarray(img), jc, weights_q=jwq,
            early_exit=early_exit)]
        got[early_exit] = [v.numpy() for v in vgg16_classify_progressive(
            tparams, timg, tc, twq, early_exit=early_exit, device="cpu")]
    return ref, got


@pytest.mark.parametrize("early_exit", [False, True])
def test_vgg16_classify_progressive_matches_reference(classify, early_exit):
    ref, got = classify
    pred, lv, logits = got[early_exit]
    r_pred, r_lv, r_logits = ref[early_exit]
    np.testing.assert_array_equal(pred, r_pred)
    np.testing.assert_array_equal(lv, r_lv)
    assert pred.dtype == lv.dtype == np.int32
    assert logits.shape == (2, 10) and np.isfinite(logits).all()
    # the committed class is the one-shot forward's argmax
    np.testing.assert_array_equal(pred, got["apply"].argmax(-1))
    np.testing.assert_array_equal(logits.argmax(-1), pred)
    assert np.abs(logits - r_logits).max() <= 1e-5 * np.abs(r_logits).max()
    if not early_exit:  # the scan's logits ARE the one-shot fc8 logits
        np.testing.assert_array_equal(logits, got["apply"])
        np.testing.assert_array_equal(r_logits, ref["apply"])


def test_vgg16_classify_flows_agree(classify):
    _, got = classify
    for a, b in zip(got[False][:2], got[True][:2]):
        np.testing.assert_array_equal(a, b)
