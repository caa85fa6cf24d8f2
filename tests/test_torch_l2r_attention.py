"""Port parity for digit-serial attention (ROADMAP A9b): the score walks,
the plane-stacked KV cache, decode on it, the margin-bounded progressive
decode walk and its precision policies, ``l2r_attn_scores`` and
``chunked_attention(l2r=)``, against repro's on the same numpy inputs.
Mirrors tests/test_l2r_attention.py and the attention cases of
tests/test_policy.py at their small shapes.

Integer parts compare bit for bit: the three score walks at every
``levels`` prefix, the cache's ``k_planes``/``k_scale``, the exit levels
and the levels run.  The reference's ``quantize_per_vector`` is taken
under ``jax.jit``: called eagerly, JAX divides by qmax and a scale can
differ in its last bit (ROADMAP Queue C), so the reference's decode walk
is reached through a jitted copy of its early-exit branch built from its
own functions (``_j_walk``), not through eager calls.  Float outputs hold
to the tolerances stated beside each test (torch and XLA round exp and
their sums in other orders).

The reference's ``attn_exit_tap`` raises under ``jit`` (exit levels are
tracers there); the port runs eagerly and always records, so that case
has no counterpart here.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import l2r_attention as jla
from repro.core import policy as jpol
from repro.core import progressive as jprog
from repro.core import quant as jq
from repro.kernels.l2r_gemm import ops as jops
from repro.models import attention as ja
from repro_torch.core import l2r_attention as tla
from repro_torch.core import quant as tq
from repro_torch.core.policy import LevelPolicy, PrecisionClass
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.l2r_gemm import kernel as tkernel
from repro_torch.kernels.l2r_gemm import ops as tops
from repro_torch.models import attention as ta

CONFIGS = [(8, 2), (8, 4), (4, 2), (4, 1)]
# f32 attention: the same chunks on both sides; exp and the sums round in
# other orders, a few ulps of outputs of magnitude ~1
ATTN_F32 = 2e-6
# bf16: |got - ref| <= 2^-7 |ref| + 1e-4 elementwise, one ulp of the bf16
# output (a last-bit f32 difference before its rounding can round it to
# the other neighbour) plus an absolute floor near zero
ATTN_BF16 = (2.0 ** -7, 1e-4)

_j_quant = jax.jit(jla.quantize_per_vector, static_argnums=1)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _rand_qk(rng, b=2, q=3, kv=2, g=2, s=7, dh=16, n_bits=8, log2_radix=2):
    """Quantized (q, k) from seeded normals, by JAX's jitted quantizer:
    (jax q, jax k, torch q, torch k)."""
    cfg = jq.QuantConfig(n_bits=n_bits, log2_radix=log2_radix)
    qf = rng.standard_normal((b, q, kv, g, dh)).astype(np.float32)
    kf = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    qq, _ = _j_quant(jnp.asarray(qf), cfg)
    kq, _ = _j_quant(jnp.asarray(kf), cfg)
    return qq, kq, _t(qq, torch.int8), _t(kq, torch.int8)


def _close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATTN_F32)
        return
    rel, atol = ATTN_BF16
    excess = np.abs(got - ref) - rel * np.abs(ref)
    assert excess.max() <= atol, excess.max()


# ------------------------------------------------------------- score walks
def test_quantize_per_vector_bit_identical_to_jitted_reference():
    x = np.random.default_rng(20).standard_normal((2, 5, 3, 16)).astype(
        np.float32)
    x[0, 0, 0] = 0.0  # a zero vector: the 1e-30 floor
    jqq, jqs = _j_quant(jnp.asarray(x), jq.QuantConfig())
    tqq, tqs = tla.quantize_per_vector(_t(x), tq.QuantConfig())
    np.testing.assert_array_equal(tqq.numpy(), np.asarray(jqq))
    np.testing.assert_array_equal(tqs.numpy(), np.asarray(jqs))


@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
def test_stacked_scores_equal_int_einsum(n_bits, log2_radix):
    """Full depth: the reference's stacked scores == the port's == the
    exact int32 GQA einsum, every digit config."""
    jqq, jkq, tqq, tkq = _rand_qk(np.random.default_rng(0), n_bits=n_bits,
                                  log2_radix=log2_radix)
    ref = np.asarray(jla.attn_scores_stacked(jqq, jkq, n_bits, log2_radix))
    got = tla.attn_scores_stacked(tqq, tkq, n_bits, log2_radix)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    exact = torch.einsum("bqkgd,bskd->bkgqs", tqq.long(), tkq.long())
    np.testing.assert_array_equal(got.numpy(), exact.numpy())


@pytest.mark.parametrize("n_bits,log2_radix", CONFIGS)
def test_three_walks_bit_identical_at_every_levels_prefix(n_bits,
                                                          log2_radix):
    """The stacked schedule, every prefix of the streaming scan and the
    while walk's result, each truncated at every ``levels`` (0 too), equal
    the reference's stacked schedule bit for bit."""
    jqq, jkq, tqq, tkq = _rand_qk(np.random.default_rng(1), n_bits=n_bits,
                                  log2_radix=log2_radix)
    n_levels = 2 * (n_bits // log2_radix) - 1
    _, _, stack = tla.attn_scores_streaming_scan(
        tqq, tkq, n_bits=n_bits, log2_radix=log2_radix, emit=True)
    assert stack.shape[0] == n_levels
    for lv in range(n_levels + 1):
        ref = np.asarray(jla.attn_scores_stacked(jqq, jkq, n_bits,
                                                 log2_radix, levels=lv))
        got = tla.attn_scores_stacked(tqq, tkq, n_bits, log2_radix, lv)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{lv}")
        if lv:
            np.testing.assert_array_equal(stack[lv - 1].numpy(), ref)
        acc, _, t = tla.attn_scores_streaming_while(
            tqq, tkq, n_bits=n_bits, log2_radix=log2_radix, levels=lv)
        assert t == lv
        np.testing.assert_array_equal(acc.numpy(), ref)


def test_scan_folds_every_prefix_and_matches_reference_scan():
    jqq, jkq, tqq, tkq = _rand_qk(np.random.default_rng(2))
    _, _, jstack = jla.attn_scores_streaming_scan(jqq, jkq, emit=True)

    def fold(carry, partial, idx):
        return carry + [(idx, partial.clone())]

    acc, seen, stack = tla.attn_scores_streaming_scan(tqq, tkq, fold, [],
                                                      emit=True)
    assert [i for i, _ in seen] == list(range(7))
    np.testing.assert_array_equal(stack.numpy(), np.asarray(jstack))
    for i, p in seen:
        assert torch.equal(p, stack[i])
    assert torch.equal(acc, stack[-1])


def test_while_walk_matches_scan_and_counts_levels():
    _, _, tqq, tkq = _rand_qk(np.random.default_rng(2))
    acc_s, _, _ = tla.attn_scores_streaming_scan(tqq, tkq)
    acc_w, _, t = tla.attn_scores_streaming_while(tqq, tkq)
    assert torch.equal(acc_s, acc_w)
    assert t == 2 * tq.QuantConfig().planes - 1


def test_while_walk_stops_when_done():
    """done_fn read before each level: a fold that is done after level 2
    stops the walk with the level-3 prefix of the stacked schedule."""
    _, _, tqq, tkq = _rand_qk(np.random.default_rng(21))

    def fold(carry, partial, idx):
        return idx + 1

    acc, n, t = tla.attn_scores_streaming_while(
        tqq, tkq, fold, 0, lambda c: torch.tensor(c >= 3))
    assert t == 3 and n == 3
    assert torch.equal(acc, tla.attn_scores_stacked(tqq, tkq, levels=3))


def test_prestacked_operands_bit_identical():
    """Prepared PlaneOperands (the cache's window-padded RHS among them)
    feed the walks bit-identically to inline extraction."""
    jqq, jkq, tqq, tkq = _rand_qk(np.random.default_rng(3))
    ref = np.asarray(jla.attn_scores_stacked(jqq, jkq))
    q_po = tq.PlaneOperands.prepare_lhs(tqq, 8, 2)
    k_po = tq.PlaneOperands.prepare_rhs(tkq, 8, 2, axis=-1, window_pad=True)
    np.testing.assert_array_equal(
        tla.attn_scores_stacked(q_po, k_po).numpy(), ref)
    acc, _, _ = tla.attn_scores_streaming_scan(q_po, k_po)
    np.testing.assert_array_equal(acc.numpy(), ref)
    acc, _, _ = tla.attn_scores_streaming_while(q_po, k_po, levels=4)
    np.testing.assert_array_equal(
        acc.numpy(), np.asarray(jla.attn_scores_stacked(jqq, jkq, levels=4)))


def test_levels_zero_is_empty_prefix():
    _, _, tqq, tkq = _rand_qk(np.random.default_rng(4))
    assert not tla.attn_scores_stacked(tqq, tkq, levels=0).any()
    acc, _, stack = tla.attn_scores_streaming_scan(tqq, tkq, levels=0,
                                                   emit=True)
    assert not acc.any() and stack.shape == (0, *acc.shape)
    acc, _, t = tla.attn_scores_streaming_while(tqq, tkq, levels=0)
    assert t == 0 and not acc.any() and acc.shape == (2, 2, 2, 3, 7)


def test_mismatched_operand_raises_with_both_layouts():
    _, _, tqq, tkq = _rand_qk(np.random.default_rng(5))
    q_po = tq.PlaneOperands.prepare_lhs(tqq, 8, 4)  # wrong radix
    for walk in (tla.attn_scores_stacked, tla.attn_scores_streaming_scan,
                 tla.attn_scores_streaming_while):
        with pytest.raises(ValueError) as ei:
            walk(q_po, tkq, n_bits=8, log2_radix=2)
        msg = str(ei.value)
        assert "PlaneOperands(side='lhs'" in msg and "log2_radix=4" in msg
        assert "other operand" in msg and "tensor(shape=" in msg


def test_walks_past_the_f32_guard_take_int64_dots_on_the_cpu():
    """Radix 256 at dh = 300 fails the f32 exactness guard (300 * 255^2 >=
    2^24): on the CPU the level dots run in int64 narrowed to int32 and
    stay exact (the card raises, tests/test_torch_cuda.py)."""
    jqq, jkq, tqq, tkq = _rand_qk(np.random.default_rng(26), dh=300,
                                  n_bits=8, log2_radix=8)
    ref = np.asarray(jla.attn_scores_stacked(jqq, jkq, 8, 8))
    np.testing.assert_array_equal(
        tla.attn_scores_stacked(tqq, tkq, 8, 8).numpy(), ref)
    acc, _, t = tla.attn_scores_streaming_while(tqq, tkq, n_bits=8,
                                                log2_radix=8)
    assert t == 1
    np.testing.assert_array_equal(acc.numpy(), ref)


# -------------------------------------------- incrementally stacked KV cache
def _fill(rng, b, length, kvh, dh, steps, cfgs):
    """The same ``steps`` one-token appends into a reference and a port
    plane-stacked cache."""
    jcache = ja.init_kv_cache(b, length, kvh, dh, jnp.float32,
                              quant=cfgs[0])
    tcache = ta.init_kv_cache(b, length, kvh, dh, torch.float32,
                              quant=cfgs[1], device="cpu")
    for t in range(steps):
        kn, vn = rng.standard_normal((2, b, 1, kvh, dh)).astype(np.float32)
        pos = np.full((b, 1), t, np.int32)
        jcache = jax.jit(ja.update_kv_cache, static_argnums=4)(
            jcache, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos),
            cfgs[0])
        ta.update_kv_cache(tcache, _t(kn), _t(vn), _t(pos, torch.int32),
                           quant=cfgs[1])
    return jcache, tcache


def test_incremental_plane_cache_bit_identical_to_reference_and_reextraction():
    cfgs = (jq.QuantConfig(), tq.QuantConfig())
    jcache, tcache = _fill(np.random.default_rng(6), 2, 12, 2, 16, 9, cfgs)
    for name in ("k", "v", "positions", "k_planes", "k_scale"):
        np.testing.assert_array_equal(getattr(tcache, name).numpy(),
                                      np.asarray(getattr(jcache, name)),
                                      err_msg=name)
    kq, ks = tla.quantize_per_vector(tcache.k, cfgs[1])
    restack = torch.nn.functional.pad(
        tq.stack_planes_rhs(kq, 8, 2, axis=-1, shifted=False), (0, 3 * 16))
    assert torch.equal(tcache.k_planes, restack)
    assert torch.equal(tcache.k_scale, ks[..., 0])
    po = ta.kv_plane_operands(tcache, cfgs[1])
    assert po.matches(8, 2, side="rhs") and po.pad_planes == 3
    assert po.stack is tcache.k_planes


def test_incremental_cache_chunk_independent():
    """One 9-token prefill append == nine 1-token decode appends."""
    rng = np.random.default_rng(7)
    cfg = tq.QuantConfig()
    b, length, kvh, dh = 1, 12, 2, 8
    ks, vs = (_t(rng.standard_normal((b, 9, kvh, dh))) for _ in range(2))
    pos = torch.arange(9, dtype=torch.int32)[None]
    c_all = ta.update_kv_cache(ta.init_kv_cache(b, length, kvh, dh,
                                                torch.float32, quant=cfg,
                                                device="cpu"),
                               ks, vs, pos, quant=cfg)
    c_one = ta.init_kv_cache(b, length, kvh, dh, torch.float32, quant=cfg,
                             device="cpu")
    for t in range(9):
        ta.update_kv_cache(c_one, ks[:, t:t + 1], vs[:, t:t + 1],
                           pos[:, t:t + 1], quant=cfg)
    assert torch.equal(c_all.k_planes, c_one.k_planes)
    assert torch.equal(c_all.k_scale, c_one.k_scale)


@pytest.mark.parametrize("start,s", [(0, 5), (13, 6), (2, 20)])
def test_plane_cache_ring_writes_bit_identical(start, s):
    """Into an 8-slot ring in a bf16 cache (the key is quantized as
    stored): inside it, across its end, and one write longer than the
    ring; every field equals the reference's."""
    rng = np.random.default_rng(start)
    k, v = rng.standard_normal((2, 2, s, 2, 4)).astype(np.float32)
    pos = (start + np.arange(s)[None] + np.array([[0], [3]])).astype(np.int32)
    jc = ja.init_kv_cache(2, 8, 2, 4, jnp.bfloat16, quant=jq.QuantConfig())
    tc = ta.init_kv_cache(2, 8, 2, 4, torch.bfloat16, quant=tq.QuantConfig(),
                          device="cpu")
    jc = jax.jit(ja.update_kv_cache, static_argnums=4)(
        jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jq.QuantConfig())
    out = ta.update_kv_cache(tc, _t(k), _t(v), _t(pos, torch.int32),
                             quant=tq.QuantConfig())
    assert out is tc
    for name in ("k", "v", "positions", "k_planes", "k_scale"):
        np.testing.assert_array_equal(
            getattr(out, name).float().numpy() if name in ("k", "v")
            else getattr(out, name).numpy(),
            np.asarray(getattr(jc, name).astype(jnp.float32))
            if name in ("k", "v") else np.asarray(getattr(jc, name)),
            err_msg=name)


def test_plane_cache_asks_for_its_quant_config():
    cache = ta.init_kv_cache(1, 4, 1, 8, torch.float32,
                             quant=tq.QuantConfig(), device="cpu")
    z = torch.zeros(1, 1, 1, 8)
    with pytest.raises(ValueError, match="QuantConfig"):
        ta.update_kv_cache(cache, z, z, torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="plane stack"):
        ta.kv_plane_operands(ta.init_kv_cache(1, 4, 1, 8, device="cpu"),
                             tq.QuantConfig())


# ---------------------------------------------------- decode on the cache
def _filled(seed, g=2, b=2, length=12, kvh=2, dh=16, steps=9):
    """A plane-stacked cache of ``steps`` tokens (both packages) and a
    query at the last position: (jcache, tcache, q)."""
    rng = np.random.default_rng(seed)
    jc, tc = _fill(rng, b, length, kvh, dh, steps,
                   (jq.QuantConfig(), tq.QuantConfig()))
    q = rng.standard_normal((b, 1, kvh * g, dh)).astype(np.float32)
    return jc, tc, q


@pytest.mark.parametrize("window,g", [(None, 2), (4, 2), (None, 1)])
def test_decode_plane_cache_bit_identical_to_inline_quant(window, g):
    """decode_attention on the plane cache == the same call quantizing the
    float cache, bit for bit; within ATTN_F32 of the reference's jitted
    call; and within W8A8 noise of the float path."""
    jc, tc, q = _filled(8, g)
    cfg = tq.QuantConfig()
    qpos = torch.full((2,), 8, dtype=torch.int32)
    args = (_t(q), tc.k, tc.v, tc.positions, qpos)
    inline = ta.decode_attention(*args, window=window, l2r=cfg)
    planes = ta.decode_attention(*args, window=window, l2r=cfg,
                                 k_planes=tc.k_planes, k_scale=tc.k_scale)
    assert torch.equal(inline, planes)
    ref = jax.jit(lambda q, c: ja.decode_attention(
        q, c.k, c.v, c.positions, jnp.full((2,), 8, jnp.int32),
        window=window, l2r=jq.QuantConfig(), k_planes=c.k_planes,
        k_scale=c.k_scale))(jnp.asarray(q), jc)
    _close(planes, ref, "float32")
    out_f = ta.decode_attention(*args, window=window)
    assert (planes - out_f).abs().max() < 0.1


@pytest.mark.parametrize("levels", [1, 4])
def test_decode_truncated_levels_within_tolerance(levels):
    jc, tc, q = _filled(22)
    cfg = tq.QuantConfig()
    got = ta.decode_attention(_t(q), tc.k, tc.v, tc.positions,
                              torch.full((2,), 8, dtype=torch.int32),
                              l2r=cfg, levels=levels, k_planes=tc.k_planes,
                              k_scale=tc.k_scale)
    ref = jax.jit(lambda q, c: ja.decode_attention(
        q, c.k, c.v, c.positions, jnp.full((2,), 8, jnp.int32),
        l2r=jq.QuantConfig(), levels=levels, k_planes=c.k_planes,
        k_scale=c.k_scale))(jnp.asarray(q), jc)
    _close(got, ref, "float32")


# ------------------------------------------------ progressive decode (exit)
def _j_walk(q, k, kv_pos, q_pos, exit_tol=1e-4, policy=None, levels=None):
    """The reference's progressive decode walk, its own functions in the
    order of repro/models/attention.py:decode_attention's early-exit
    branch, under jax.jit: (int32 scores at the exit, exit levels, levels
    run)."""
    cfg = jq.QuantConfig()

    @jax.jit
    def walk(q, k, kv_pos, q_pos, pol):
        b, _, h, dh = q.shape
        kvh = k.shape[2]
        g = h // kvh
        qg = q.reshape(b, 1, kvh, g, dh)
        valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
        valid_b = valid[:, None, None, None, :]
        qq, qs = jla.quantize_per_vector(qg, cfg)
        qs_t = qs.transpose(0, 2, 3, 1, 4)
        kq, ks3 = jla.quantize_per_vector(k, cfg)
        ks_t = ks3[..., 0].transpose(0, 2, 1)[:, :, None, None, :]
        sf = jnp.float32(1.0 / math.sqrt(dh))
        bounds = jprog.level_bounds(cfg.planes, cfg.log2_radix, dh, levels)
        fold, init, done_fn = jpol.attn_walk_machinery(
            bounds.f32, lambda acc: acc.astype(jnp.float32) * qs_t * ks_t * sf,
            valid_b, qs_t[:, :, :, 0, :] * ks_t[:, :, :, 0, :] * sf,
            rows_shape=(b, kvh, g), n_levels=int(bounds.f32.shape[0]),
            exit_tol=exit_tol, policy=pol,
            score_shape=(b, kvh, g, 1, k.shape[1]))
        acc, carry, t = jla.attn_scores_streaming_while(
            qq, kq, fold, init, done_fn, cfg.n_bits, cfg.log2_radix, levels)
        return acc, carry[1], t

    acc, lv, t = walk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(kv_pos),
                      jnp.asarray(q_pos), policy)
    return np.asarray(acc), np.asarray(lv), int(t)


def test_early_exit_decode_bit_identical_at_tight_tol():
    """A tight tolerance gives the full-depth output bit for bit; the exit
    levels and levels run equal the reference's walk; a loose tolerance
    decides rows earlier, never later."""
    _, tc, q = _filled(9, g=3)
    cfg = tq.QuantConfig()
    qpos = torch.full((2,), 8, dtype=torch.int32)
    args = (_t(q), tc.k, tc.v, tc.positions, qpos)
    kw = dict(l2r=cfg, k_planes=tc.k_planes, k_scale=tc.k_scale)
    full = ta.decode_attention(*args, **kw)
    with ta.attn_exit_tap() as rec:
        exited = ta.decode_attention(*args, **kw, early_exit=True,
                                     exit_tol=1e-4)
    assert torch.equal(full, exited)
    assert len(rec) == 1 and rec[0]["exit_levels"].shape == (2, 2, 3)
    _, lv, t = _j_walk(q, tc.k.numpy(), tc.positions.numpy(),
                       qpos.numpy(), 1e-4)
    np.testing.assert_array_equal(rec[0]["exit_levels"], lv)
    assert rec[0]["levels_run"] == t
    with ta.attn_exit_tap() as rec2:
        ta.decode_attention(*args, **kw, early_exit=True, exit_tol=10.0)
    _, lv2, t2 = _j_walk(q, tc.k.numpy(), tc.positions.numpy(),
                         qpos.numpy(), 10.0)
    np.testing.assert_array_equal(rec2[0]["exit_levels"], lv2)
    assert rec2[0]["levels_run"] == t2
    assert (rec2[0]["exit_levels"] <= rec[0]["exit_levels"]).all()
    assert (rec2[0]["exit_levels"] < 6).any()  # the loose walk does exit


def test_early_exit_scores_equal_the_reference_walk():
    """The int32 prefix the walk stops on equals the reference's."""
    _, tc, q = _filled(23, g=2)
    cfg = tq.QuantConfig()
    qpos = torch.full((2,), 8, dtype=torch.int32)
    qg = _t(q).reshape(2, 1, 2, 2, 16)
    qq, qs = tla.quantize_per_vector(qg, cfg)
    acc_j, _, t_j = _j_walk(q, tc.k.numpy(), tc.positions.numpy(),
                            qpos.numpy(), 10.0)
    got = tla.attn_scores_stacked(qq, ta.kv_plane_operands(tc, cfg),
                                  levels=t_j)
    np.testing.assert_array_equal(got.numpy(), acc_j)


def test_early_exit_rejects_softcap():
    cfg = tq.QuantConfig()
    cache = ta.init_kv_cache(1, 4, 1, 8, torch.float32, quant=cfg,
                             device="cpu")
    q = _t(np.random.default_rng(10).standard_normal((1, 1, 1, 8)))
    with pytest.raises(ValueError, match="softcap"):
        ta.decode_attention(q, cache.k, cache.v, cache.positions,
                            torch.zeros((1,), dtype=torch.int32),
                            softcap=30.0, l2r=cfg, early_exit=True)


def test_exit_tap_records_every_call_in_order():
    """The port always records (it runs eagerly); nothing is recorded
    outside the tap, and taps nest."""
    _, tc, q = _filled(24)
    kw = dict(l2r=tq.QuantConfig(), early_exit=True)
    args = (_t(q), tc.k, tc.v, tc.positions,
            torch.full((2,), 8, dtype=torch.int32))
    ta.decode_attention(*args, **kw)
    with ta.attn_exit_tap() as outer:
        ta.decode_attention(*args, **kw)
        with ta.attn_exit_tap() as inner:
            ta.decode_attention(*args, **kw, exit_tol=10.0)
        ta.decode_attention(*args, **kw)
    assert len(outer) == 2 and len(inner) == 1
    assert all(isinstance(r["levels_run"], int) for r in outer + inner)


# ------------------------------------------------------ precision policies
@pytest.fixture(scope="module")
def attn_inputs():
    """tests/test_policy.py's decode-attention inputs."""
    rng = np.random.default_rng(0)
    B, L, H, Kv, dh = 3, 16, 4, 2, 8
    q = rng.normal(size=(B, 1, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, L, Kv, dh)).astype(np.float32)
    v = rng.normal(size=(B, L, Kv, dh)).astype(np.float32)
    kv_pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    q_pos = np.full((B,), L - 1, np.int32)
    return q, k, v, kv_pos, q_pos


def _attn(inputs, **kw):
    q, k, v, kv_pos, q_pos = inputs
    return ta.decode_attention(_t(q), _t(k), _t(v), _t(kv_pos, torch.int32),
                               _t(q_pos, torch.int32),
                               l2r=tq.QuantConfig(), **kw)


def _j_attn(inputs, **kw):
    return jax.jit(lambda *a: ja.decode_attention(
        *a, l2r=jq.QuantConfig(), **kw))(*(jnp.asarray(x) for x in inputs))


def test_attn_exact_policy_matches_full_depth(attn_inputs):
    out = _attn(attn_inputs, policy=LevelPolicy.exact(3))
    assert torch.equal(out, _attn(attn_inputs))
    _close(out, _j_attn(attn_inputs, policy=jpol.LevelPolicy.exact(3)),
           "float32")


def test_attn_budget_policy_matches_truncated_levels(attn_inputs):
    for lvl in range(1, 2 * tq.QuantConfig().planes):
        with ta.attn_exit_tap() as rec:
            out = _attn(attn_inputs, policy=LevelPolicy.budget(lvl, 3))
        assert torch.equal(out, _attn(attn_inputs, levels=lvl)), lvl
        assert (rec[0]["exit_levels"] <= lvl - 1).all()
        _close(out, _j_attn(attn_inputs, levels=lvl), "float32")


def test_attn_bounded_policy_matches_legacy_early_exit(attn_inputs):
    with ta.attn_exit_tap() as rec:
        out = _attn(attn_inputs, policy=LevelPolicy.bounded(3, tol=1e-4))
        legacy = _attn(attn_inputs, early_exit=True, exit_tol=1e-4)
    assert torch.equal(out, legacy)
    np.testing.assert_array_equal(rec[0]["exit_levels"],
                                  rec[1]["exit_levels"])
    _, lv, t = _j_walk(*(attn_inputs[i] for i in (0, 1, 3, 4)), 1e-4,
                       policy=jpol.LevelPolicy.bounded(3, tol=1e-4))
    np.testing.assert_array_equal(rec[0]["exit_levels"], lv)
    assert rec[0]["levels_run"] == t


def test_attn_mixed_budget_rows_snapshot_their_prefix(attn_inputs):
    """Budget rows in a mixed batch serve softmax from their snapshotted
    levels=L prefix: bit-identical to a solo run although an exact
    batch-mate walks the loop to full depth; exit levels equal the
    reference's."""
    q, k, v, kv_pos, q_pos = attn_inputs
    classes = [PrecisionClass.exact(), PrecisionClass.budget(3),
               PrecisionClass.budget(5)]
    with ta.attn_exit_tap() as rec:
        mix = _attn(attn_inputs, policy=LevelPolicy.from_classes(classes))
    for i, c in enumerate(classes):
        solo = _attn(tuple(x[i:i + 1] for x in attn_inputs),
                     policy=LevelPolicy.from_classes([c]))
        assert torch.equal(mix[i], solo[0]), (i, c.label())
    jclasses = [jpol.PrecisionClass.exact(), jpol.PrecisionClass.budget(3),
                jpol.PrecisionClass.budget(5)]
    _, lv, t = _j_walk(q, k, kv_pos, q_pos,
                       policy=jpol.LevelPolicy.from_classes(jclasses))
    np.testing.assert_array_equal(rec[0]["exit_levels"], lv)
    assert rec[0]["levels_run"] == t == 7


def test_attn_policy_rejects_softcap(attn_inputs):
    assert _attn(attn_inputs).shape == attn_inputs[0].shape
    with pytest.raises(ValueError, match="softcap"):
        _attn(attn_inputs, softcap=30.0, policy=LevelPolicy.exact(3))


def test_level_policy_reshape_keeps_rows():
    pol = LevelPolicy.from_classes([PrecisionClass.budget(2),
                                    PrecisionClass.bounded(0.5)])
    r = pol.reshape((-1, 1, 1))
    assert r.mode.shape == r.clamp.shape == r.tol.shape == (2, 1, 1)
    assert r.clamp.flatten().tolist() == [2, jpol.NO_CLAMP]
    np.testing.assert_array_equal(r.tol.flatten().numpy(),
                                  np.asarray(jpol.LevelPolicy.from_classes(
                                      [jpol.PrecisionClass.budget(2),
                                       jpol.PrecisionClass.bounded(0.5)]
                                  ).reshape((-1, 1, 1)).tol).flatten())


# --------------------------------------------------------------- dispatcher
def test_dispatcher_schedules_bit_identical_on_the_cpu():
    """CPU tensors take the walks: every schedule (and early_exit) equals
    the reference's jnp dispatcher, at full depth and truncated; no
    kernel launches."""
    jqq, jkq, tqq, tkq = _rand_qk(np.random.default_rng(12))
    before = dict(tkernel.LAUNCHES)
    for levels in (None, 3):
        ref = np.asarray(jops.l2r_attn_scores(jqq, jkq, levels=levels,
                                              backend="jnp"))
        for kw in (dict(), dict(schedule="streaming"),
                   dict(schedule="streaming", early_exit=True)):
            got = tops.l2r_attn_scores(tqq, tkq, levels=levels, **kw)
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(kw))
    k_po = tq.PlaneOperands.prepare_rhs(tkq, 8, 2, axis=-1,
                                        window_pad=True)  # the cache's
    np.testing.assert_array_equal(tops.l2r_attn_scores(tqq, k_po).numpy(),
                                  np.asarray(jla.attn_scores_stacked(jqq,
                                                                     jkq)))
    assert tkernel.LAUNCHES == before


def test_dispatcher_b1_route_plain_version_bit_identical():
    """The card's route (one B1 call per (batch, kv head) over pre-shifted
    slices) run on B1's plain version equals the stacked walk."""
    _, _, tqq, tkq = _rand_qk(np.random.default_rng(25), q=5, g=3)
    q_po = tq.PlaneOperands.prepare_lhs(tqq, 8, 2)
    k_po = tq.PlaneOperands.prepare_rhs(tkq, 8, 2, axis=-1, window_pad=True)
    for levels in (None, 0, 2, 5):
        got = tops._attn_b1_scores(q_po, k_po, 8, 2, levels)
        assert torch.equal(got, tla.attn_scores_stacked(tqq, tkq,
                                                        levels=levels))


def test_dispatcher_rejections():
    _, _, tqq, tkq = _rand_qk(np.random.default_rng(13))
    with pytest.raises(ValueError, match="streaming"):
        tops.l2r_attn_scores(tqq, tkq, early_exit=True)
    with pytest.raises(ValueError, match="schedule"):
        tops.l2r_attn_scores(tqq, tkq, schedule="pairs")
    with pytest.raises(ValueError, match="other operand"):
        tops.l2r_attn_scores(tq.PlaneOperands.prepare_lhs(tqq, 8, 4), tkq)


def test_gemm_mismatch_error_names_both_operands():
    rng = np.random.default_rng(14)
    a = torch.from_numpy(rng.integers(-8, 8, (4, 8)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-8, 8, (8, 4)).astype(np.int8))
    with pytest.raises(ValueError) as ei:
        tops.l2r_gemm(tq.PlaneOperands.prepare_lhs(a, 8, 4), b, 8, 2)
    msg = str(ei.value)
    assert "log2_radix=4" in msg and "other operand" in msg


# ------------------------------------------------ chunked attention (l2r=)
L2R_CASES = [
    dict(sq=40, h=4, kvh=2, dh=32),  # GQA, one chunk
    dict(sq=40, h=4, kvh=1, dh=32, window=9, q_chunk=16, kv_chunk=8),
    dict(sq=33, h=3, kvh=1, dh=16, causal=False, q_chunk=8, kv_chunk=16),
    dict(sq=40, h=6, kvh=2, dh=32, softcap=5.0, q_chunk=16, kv_chunk=8),
    dict(sq=40, h=4, kvh=2, dh=32, levels=3, q_chunk=16, kv_chunk=8),
    dict(sq=24, skv=56, h=4, kvh=4, dh=16, q_offset=32, q_chunk=16,
         kv_chunk=16),  # prefill continuation
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", L2R_CASES)
def test_chunked_attention_l2r_within_tolerance(case, dtype):
    """chunked_attention(l2r=) on the CPU (the reference's chunk loop, no
    kernel) against the reference's, jitted: within ATTN_F32 (f32) or one
    bf16 ulp + 1e-4 (bf16); the quantized q and k and their scores bit
    for bit."""
    rng = np.random.default_rng(3)
    kw = {k: v for k, v in case.items()
          if k not in ("sq", "skv", "h", "kvh", "dh")}
    q = rng.standard_normal((2, case["sq"], case["h"], case["dh"]))
    k, v = rng.standard_normal((2, 2, case.get("skv", case["sq"]),
                                case["kvh"], case["dh"]))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax.jit(lambda *a: ja.chunked_attention(
        *a, l2r=jq.QuantConfig(), **kw))(*(jnp.asarray(x, jd)
                                           for x in (q, k, v)))
    before = fa.LAUNCHES["flash_attention_l2r"]
    got = ta.chunked_attention(*(_t(x, td) for x in (q, k, v)),
                               l2r=tq.QuantConfig(), **kw)
    assert fa.LAUNCHES["flash_attention_l2r"] == before
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    _close(got, ref, dtype)
    g = case["h"] // case["kvh"]
    qg = q.reshape(2, case["sq"], case["kvh"], g, case["dh"])
    (jqq, _), (jkq, _) = (_j_quant(jnp.asarray(x, jd), jq.QuantConfig())
                          for x in (qg, k))
    (tqq, _), (tkq, _) = (tla.quantize_per_vector(_t(x, td),
                                                  tq.QuantConfig())
                          for x in (qg, k))
    np.testing.assert_array_equal(tqq.numpy(), np.asarray(jqq))
    np.testing.assert_array_equal(tkq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(
        tla.attn_scores_stacked(tqq, tkq, levels=kw.get("levels")).numpy(),
        np.asarray(jla.attn_scores_stacked(jqq, jkq,
                                           levels=kw.get("levels"))))


def test_chunked_l2r_tracks_float_and_is_chunking_independent():
    """tests/test_attention.py's quantized case on the port: W8A8 scores
    track the float attention to quantization noise (0.12, the
    reference's bound), and the result does not depend on the chunking
    (per-vector scales commute with the KV split; 3e-5, the reference's
    bound)."""
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((2, 96, 4, 16)))
    k, v = (_t(rng.standard_normal((2, 96, 2, 16))) for _ in range(2))
    kw = dict(window=40, l2r=tq.QuantConfig())
    out = ta.chunked_attention(q, k, v, q_chunk=32, kv_chunk=16, **kw)
    ref = ta.chunked_attention(q, k, v, window=40)
    assert (out - ref).abs().max() <= 0.12
    out2 = ta.chunked_attention(q, k, v, q_chunk=16, kv_chunk=64, **kw)
    assert (out - out2).abs().max() <= 3e-5


def test_b4_fits_by_the_arguments():
    """b4_fits takes B4 only on a CUDA tensor with no softcap, no q
    offset and v f32/bf16, at any head width and plane type (a stand-in
    object with ``is_cuda`` set plays the card's tensor here)."""
    from types import SimpleNamespace

    cfg = tq.QuantConfig()
    assert not ta.b4_fits(torch.zeros(1, 4, 2, 64), None, torch.zeros(1),
                          None, 0, cfg)  # CPU tensors: the loop

    def card(dh=64, dtype=torch.bfloat16):
        return SimpleNamespace(is_cuda=True, shape=(1, 4, 2, dh), dtype=dtype)

    assert ta.b4_fits(card(), card(), card(), None, 0, cfg)
    assert ta.b4_fits(card(), card(), card(dtype=torch.float32), None, 0, cfg)
    assert ta.b4_fits(card(dh=192), card(dh=192), card(dh=192), None, 0, cfg)
    assert ta.b4_fits(card(dh=256), card(dh=256), card(dh=256), None, 0,
                      tq.QuantConfig(n_bits=16, log2_radix=4))
    for q, v, softcap, off, c in (
            (card(), card(), 30.0, 0, cfg),
            (card(), card(), None, 3, cfg),
            (card(), card(dtype=torch.float16), None, 0, cfg)):
        assert not ta.b4_fits(q, q, v, softcap, off, c)
