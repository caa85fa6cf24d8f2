"""Port parity for the encoder-decoder backbone (models/encdec.py) and its
serving steps against repro's, at ``get_smoke("whisper-base")`` (2
encoder and 2 decoder layers, d 64, 4 heads of 16, 24 frames, f32),
params built by JAX's ``materialize`` and carried across by value,
frames and tokens from one numpy seed.

Results hold to a share of their largest |value|.  Float: ENC_F32 (the
encoder output) and ENCDEC_F32 (the decoder's hidden states, caches and
logits): LayerNorm, GELU, softmax and the f32 matmuls round apart,
compounded through the layers and amplified by the LayerNorms (the
decoder's input, embedding plus position table, has |x| ~ 0.03);
measured 1.2e-5 (the encoder) and 6.6e-5 (the hidden states).  With an
L2R config (each dense quantizing its input, weights quantized per call)
they hold to ENCDEC_L2R: the integer products are exact and no int8
activation code rounds apart on these inputs (measured 3.5e-7; a code
one step apart moves a row by a few percent, tests/test_torch_lm.py).
Greedy tokens must equal the reference's where its top-1/top-2 margin is
wide.  Then the three specs of the reference's
tests/test_encdec_serve.py, on the port alone, and the
``prepare_params`` caveat: both packages turn ``enc_pos`` and
``dec_pos`` into weight records and then fail in the forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import quant as jq
from repro.models import common as jc
from repro.models import encdec as je
from repro.serve import engine as jeng
from repro_torch.configs import get_smoke
from repro_torch.core import quant as tq
from repro_torch.models import encdec as te
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.serve import engine as teng

ARCH = "whisper-base"
ENC_F32 = 5e-5
ENCDEC_F32 = 2e-4
ENCDEC_L2R = 2e-6
STEPS = 4


def _cfgs(l2r=False):
    jcfg, tcfg = j_get_smoke(ARCH), get_smoke(ARCH)
    if l2r:
        jcfg = dataclasses.replace(jcfg, l2r=jq.QuantConfig())
        tcfg = dataclasses.replace(tcfg, l2r=tq.QuantConfig())
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jc.materialize(je.encdec_build(jcfg), jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, tcfg.encoder_seq, tcfg.d_model)) \
        .astype(np.float32)
    toks = rng.integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    return jp, tp, frames, toks


def _close(got, ref, tol):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def _t(x):
    return torch.from_numpy(np.array(x))


def test_encode(model):
    jp, tp, frames, _ = model
    jcfg, tcfg = _cfgs()
    _close(te.encode(tcfg, tp, _t(frames)),
           je.encode(jcfg, jp, jnp.asarray(frames)), ENC_F32)


@pytest.mark.parametrize("l2r", [False, True])
def test_encdec_forward_train_prefill_decode(model, l2r):
    """Train over 12 tokens, prefill over 10 (the state's self cache,
    cross K/V and pos), then two decode steps, against the reference."""
    jp, tp, frames, toks = model
    jcfg, tcfg = _cfgs(l2r)
    tol = ENCDEC_L2R if l2r else ENCDEC_F32
    jh, _, jaux = je.encdec_forward(jcfg, jp, tokens=jnp.asarray(toks),
                                    frames=jnp.asarray(frames))
    th, _, taux = te.encdec_forward(tcfg, tp, tokens=_t(toks),
                                    frames=_t(frames))
    _close(th, jh, tol)
    assert float(taux) == float(jaux) == 0.0
    jst = je.init_encdec_state(jcfg, 2, 16, jnp.float32)
    tst = te.init_encdec_state(tcfg, 2, 16, torch.float32, device="cpu")
    jh, jst, _ = je.encdec_forward(jcfg, jp, tokens=jnp.asarray(toks[:, :10]),
                                   frames=jnp.asarray(frames),
                                   mode="prefill", state=jst)
    th, tst2, _ = te.encdec_forward(tcfg, tp, tokens=_t(toks[:, :10]),
                                    frames=_t(frames), mode="prefill",
                                    state=tst)
    _close(th, jh, tol)
    assert tst2.cross_k is tst.cross_k  # written in place
    _close(tst2.cross_k, jst.cross_k, tol)
    _close(tst2.cross_v, jst.cross_v, tol)
    _close(tst2.self_cache.k, jst.self_cache.k, tol)
    np.testing.assert_array_equal(tst2.self_cache.positions.numpy(),
                                  np.asarray(jst.self_cache.positions))
    np.testing.assert_array_equal(tst2.pos.numpy(), np.asarray(jst.pos))
    tst = tst2
    for pos in (10, 11):
        jh, jst, _ = je.encdec_forward(
            jcfg, jp, tokens=jnp.asarray(toks[:, pos:pos + 1]),
            mode="decode", state=jst)
        th, tst, _ = te.encdec_forward(
            tcfg, tp, tokens=_t(toks[:, pos:pos + 1]), mode="decode",
            state=tst)
        _close(th, jh, tol)
        np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))


@pytest.mark.parametrize("l2r", [False, True])
def test_serving_steps_follow_the_reference(model, l2r):
    """``make_prefill_step`` on ``{"tokens", "frames"}`` and
    ``make_decode_step`` (raw params: with an L2R config each dense
    quantizes its weight per call), fed the reference's greedy tokens:
    logits within tolerance, equal tokens where the margin is wide."""
    jp, tp, frames, toks = model
    jcfg, tcfg = _cfgs(l2r)
    tol = ENCDEC_L2R if l2r else ENCDEC_F32
    prompt = toks[:, :8]
    prefill = jax.jit(jeng.make_prefill_step(jcfg, 8 + STEPS, jnp.float32))
    decode = jax.jit(jeng.make_decode_step(jcfg))
    jst, jl = prefill(jp, {"tokens": jnp.asarray(prompt),
                           "frames": jnp.asarray(frames)})
    tprefill = teng.make_prefill_step(tcfg, 8 + STEPS, torch.float32)
    tdecode = teng.make_decode_step(tcfg)
    tst, tl = tprefill(tp, {"tokens": _t(prompt), "frames": _t(frames)})
    wide = 0
    for step in range(STEPS):
        _close(tl, jl, tol)
        r = np.asarray(jl)[:, 0]
        top2 = np.sort(r, -1)[:, -2:]
        ok = top2[:, 1] - top2[:, 0] > 2 * tol * np.abs(r).max()
        np.testing.assert_array_equal(tl[:, 0].argmax(-1).numpy()[ok],
                                      r.argmax(-1)[ok])
        wide += ok.sum()
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jst, _, jl = decode(jp, jst, tok)
        tst, ttok, tl = tdecode(tp, tst, _t(np.asarray(tok)))
        assert ttok.dtype == torch.int32 and ttok.shape == (2, 1)
    assert wide > 0


# ------------------------------------------ tests/test_encdec_serve.py, port
def test_decode_matches_train(model):
    _, tp, frames, toks = model
    _, cfg = _cfgs()
    h, _, _ = te.encdec_forward(cfg, tp, tokens=_t(toks), frames=_t(frames),
                                mode="train")
    st = te.init_encdec_state(cfg, 2, 16, torch.float32, device="cpu")
    _, st, _ = te.encdec_forward(cfg, tp, tokens=_t(toks[:, :11]),
                                 frames=_t(frames), mode="prefill", state=st)
    h_dec, st, _ = te.encdec_forward(cfg, tp, tokens=_t(toks[:, 11:12]),
                                     mode="decode", state=st)
    np.testing.assert_allclose(h[:, 11:12].numpy(), h_dec.numpy(), atol=1e-4)


def test_multi_step_decode_consistent(model):
    """Two successive decode steps == the train forward at those positions."""
    _, tp, frames, toks = model
    _, cfg = _cfgs()
    h, _, _ = te.encdec_forward(cfg, tp, tokens=_t(toks), frames=_t(frames),
                                mode="train")
    st = te.init_encdec_state(cfg, 2, 16, torch.float32, device="cpu")
    _, st, _ = te.encdec_forward(cfg, tp, tokens=_t(toks[:, :10]),
                                 frames=_t(frames), mode="prefill", state=st)
    for pos in (10, 11):
        h_dec, st, _ = te.encdec_forward(cfg, tp,
                                         tokens=_t(toks[:, pos:pos + 1]),
                                         mode="decode", state=st)
        np.testing.assert_allclose(h[:, pos:pos + 1].numpy(), h_dec.numpy(),
                                   atol=1e-4)


def test_cross_attention_cache_reused(model):
    """Decode must not need encoder frames (cross-KV cached at prefill)."""
    _, tp, frames, toks = model
    _, cfg = _cfgs()
    st = te.init_encdec_state(cfg, 2, 16, torch.float32, device="cpu")
    _, st, _ = te.encdec_forward(cfg, tp, tokens=_t(toks[:, :11]),
                                 frames=_t(frames), mode="prefill", state=st)
    h_dec, _, _ = te.encdec_forward(cfg, tp, tokens=_t(toks[:, 11:12]),
                                    mode="decode", state=st)
    assert torch.isfinite(h_dec).all()


# ------------------------------------------------- the prepare_params caveat
def test_both_packages_refuse_prepared_encdec_params(model):
    """``prepare_params(cfg, params, desc=encdec_build(cfg))`` makes the
    position tables weight records (2-D normal-init leaves), and the
    prefill then fails on them, in the reference and in the port alike;
    without ``desc`` both assert."""
    jp, tp, frames, toks = model
    jcfg, tcfg = _cfgs(True)
    jprep = jeng.prepare_params(jcfg, jp, desc=je.encdec_build(jcfg))
    tprep = teng.prepare_params(tcfg, tp, desc=te.encdec_build(tcfg))
    for prep in (jprep, tprep):
        assert type(prep["enc_pos"]).__name__ == "QuantizedWeights"
        assert type(prep["dec_pos"]).__name__ == "QuantizedWeights"
    batch = {"tokens": toks[:, :8], "frames": frames}
    with pytest.raises(TypeError, match="not subscriptable"):
        jeng.make_prefill_step(jcfg, 12, jnp.float32)(
            jprep, jax.tree.map(jnp.asarray, batch))
    with pytest.raises(TypeError, match="not subscriptable"):
        teng.make_prefill_step(tcfg, 12, torch.float32)(
            tprep, {k: _t(v) for k, v in batch.items()})
    with pytest.raises(AssertionError, match="encdec desc"):
        jeng.prepare_params(jcfg, jp)
    with pytest.raises(AssertionError, match="encdec desc"):
        teng.prepare_params(tcfg, tp)


def test_progressive_and_bucketed_steps_refuse_encdec():
    _, tcfg = _cfgs(True)
    with pytest.raises(AssertionError, match="LM families only"):
        teng.make_prefill_step(tcfg, 16, progressive=True)
    with pytest.raises(AssertionError, match="LM families only"):
        teng.make_decode_step(tcfg, progressive=True)
    with pytest.raises(AssertionError, match="attention-mixer"):
        teng.make_bucket_prefill_step(tcfg, 16)
