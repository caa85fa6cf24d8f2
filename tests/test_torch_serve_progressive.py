"""Port parity for the progressive LM head and the progressive step
factories (serve/engine.py): ``progressive_logits_from_hidden``,
``make_prefill_step``/``make_decode_step``/``make_bucket_prefill_step``
with ``progressive``, ``early_exit`` and ``policy``, against repro's at
``get_smoke("smollm-135m")`` with ``l2r=QuantConfig()`` (6 layers,
d = 96, vocab 512, f32), params built by JAX's ``materialize`` and
carried across by value.

The head is an integer stream plus a float decision fold in the
reference's order, so on the SAME hidden states logits, tokens and exit
levels are bit-identical: with and without the ``head_q`` cache, at full
depth and at 5 levels, scan and early exit, under a mixed policy.  The
whole steps run the float backbone, whose last bits differ from JAX's
(tests/test_torch_serve.py), so there tokens and exit levels must equal
the reference's wherever its top-1/top-2 margin is wide, and the test
requires such positions to exist.  The port's own contracts (the
streamed head equals the one-shot head, early exit equals the scan,
decode keeps the state's storage) hold bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import policy as jpol
from repro.core import quant as jq
from repro.models import common as jc
from repro.models import transformer as jt
from repro.serve import engine as je
from repro_torch.configs import get_smoke
from repro_torch.core import policy as tpol
from repro_torch.core import quant as tq
from repro_torch.models import transformer as tt
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.serve import engine as te
from test_torch_train import _one_torch_thread  # noqa: F401

ARCH = "smollm-135m"
STEPS = 3
LOGIT_F32 = 1e-4  # tests/test_torch_serve.py's bound on the float stack
CLASSES = [("exact", None, 0.0), ("budget", 3, 0.0), ("bounded", None, 0.0),
           ("bounded", None, 0.01)]


def _cfgs(levels=None):
    return (dataclasses.replace(j_get_smoke(ARCH), l2r=jq.QuantConfig(),
                                l2r_levels=levels),
            dataclasses.replace(get_smoke(ARCH), l2r=tq.QuantConfig(),
                                l2r_levels=levels))


def _policies(rows):
    spec = [CLASSES[i % len(CLASSES)] for i in range(rows)]
    return (jpol.LevelPolicy.from_classes(
                [jpol.PrecisionClass(*c) for c in spec]),
            tpol.LevelPolicy.from_classes(
                [tpol.PrecisionClass(*c) for c in spec]))


@pytest.fixture(scope="module")
def params():
    """(reference params, reference prepared, port params, port prepared)."""
    jcfg, tcfg = _cfgs()
    jp = jc.materialize(jt.lm_build(jcfg), jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, je.prepare_params(jcfg, jp), tp, te.prepare_params(tcfg, tp)


def _eq(got, ref, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=msg)


@pytest.mark.parametrize("policy", [False, True])
@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("levels", [None, 5])
@pytest.mark.parametrize("head_q", [True, False])
def test_progressive_head_matches_reference_bit_for_bit(
        params, head_q, levels, early_exit, policy):
    jcfg, tcfg = _cfgs(levels)
    jparams, jprep, tparams, tprep = params
    jsrc, tsrc = (jprep, tprep) if head_q else (jparams, tparams)
    rng = np.random.default_rng(7 + (levels or 0))
    # spread the rows' scales so some decide early and some do not
    hidden = (rng.standard_normal((8, 1, 96))
              * rng.uniform(0.2, 4.0, (8, 1, 1))).astype(np.float32)
    jpolicy, tpolicy = _policies(8) if policy else (None, None)
    ref = je.progressive_logits_from_hidden(
        jcfg, jsrc, jnp.asarray(hidden), early_exit=early_exit,
        policy=jpolicy)
    got = te.progressive_logits_from_hidden(
        tcfg, tsrc, torch.from_numpy(hidden), early_exit=early_exit,
        policy=tpolicy)
    for g, r, name in zip(got, ref, ("logits", "tok", "exit_level")):
        assert g.shape == r.shape, name
        _eq(g, r, name)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32
    if not early_exit:  # the scan's logits are the one-shot head's
        _eq(got[0], tt.logits_from_hidden(tcfg, tsrc,
                                          torch.from_numpy(hidden)))


def test_head_q_exit_levels_are_not_all_full_depth(params):
    """The parity above is not vacuous: some rows commit early."""
    _, tcfg = _cfgs()
    rng = np.random.default_rng(7)
    hidden = (rng.standard_normal((8, 1, 96))
              * rng.uniform(0.2, 4.0, (8, 1, 1))).astype(np.float32)
    _, _, lv = te.progressive_logits_from_hidden(
        tcfg, params[3], torch.from_numpy(hidden), early_exit=True)
    assert int(lv.min()) < 6


def test_step_factories_reject_contradictory_flags():
    """The ValueError texts are the reference's, word for word."""
    jcfg, tcfg = _cfgs()
    pairs = [(lambda **k: je.make_decode_step(jcfg, **k),
              lambda **k: te.make_decode_step(tcfg, **k)),
             (lambda **k: je.make_prefill_step(jcfg, 16, **k),
              lambda **k: te.make_prefill_step(tcfg, 16, **k)),
             (lambda **k: je.make_bucket_prefill_step(jcfg, 16, **k),
              lambda **k: te.make_bucket_prefill_step(tcfg, 16, **k))]
    for jfac, tfac in pairs:
        for kw, tkw in (({"early_exit": True}, {"early_exit": True}),
                        ({"policy": jpol.LevelPolicy.exact(2)},
                         {"policy": tpol.LevelPolicy.exact(2)})):
            with pytest.raises(ValueError) as ref:
                jfac(progressive=False, **kw)
            with pytest.raises(ValueError) as got:
                tfac(progressive=False, **tkw)
            assert str(got.value) == str(ref.value)
            word = "early_exit" if "early_exit" in kw else "policy"
            assert word in str(got.value) and "progressive" in str(got.value)


PROMPT = np.random.default_rng(3).integers(0, 512, (3, 8)).astype(np.int32)


@pytest.fixture(scope="module")
def reference_steps(params):
    """The reference's progressive prefill and decode steps (jitted, as it
    serves) along its own tokens: per early_exit, (tokens (B, STEPS+1),
    exit levels (B, STEPS+1), scan logits per step (B, V))."""
    jcfg, _ = _cfgs()
    jprep = params[1]
    out = {}
    b, s = PROMPT.shape
    for early_exit in (False, True):
        prefill = jax.jit(je.make_prefill_step(
            jcfg, s + STEPS + 1, jnp.float32, progressive=True,
            early_exit=early_exit))
        decode = jax.jit(je.make_decode_step(jcfg, progressive=True,
                                             early_exit=early_exit))
        state, logits, tok, lv = prefill(jprep, {"tokens": jnp.asarray(PROMPT)})
        toks, lvs, lgs = [tok], [lv], [logits[:, 0]]
        for _ in range(STEPS):
            state, tok, logits, lv = decode(jprep, state, tok)
            toks.append(tok)
            lvs.append(lv)
            lgs.append(logits[:, 0])
        out[early_exit] = (np.asarray(jnp.concatenate(toks, 1)),
                           np.asarray(jnp.concatenate(lvs, 1)),
                           [np.asarray(x) for x in lgs])
    return out


@pytest.mark.parametrize("early_exit", [False, True])
def test_progressive_steps_follow_the_reference(params, reference_steps,
                                                early_exit):
    """The port's progressive prefill and decode steps fed the reference's
    tokens: tokens and exit levels equal wherever the reference's scan
    margin is wide; the scan's logits within LOGIT_F32 of the
    reference's at every step."""
    _, tcfg = _cfgs()
    tprep = params[3]
    ref_tok, ref_lv, _ = reference_steps[early_exit]
    _, _, scan_logits = reference_steps[False]
    b, s = PROMPT.shape
    prefill = te.make_prefill_step(tcfg, s + STEPS + 1, torch.float32,
                                   progressive=True, early_exit=early_exit)
    decode = te.make_decode_step(tcfg, progressive=True,
                                 early_exit=early_exit)
    state, logits, tok, lv = prefill(tprep, {"tokens": torch.from_numpy(PROMPT)})
    toks, lvs, lgs = [tok], [lv], [logits[:, 0]]
    for i in range(STEPS):
        fed = torch.from_numpy(ref_tok[:, i:i + 1].copy())
        state, tok, logits, lv = decode(tprep, state, fed)
        assert tok.dtype == torch.int32 and tok.shape == (b, 1)
        assert lv.dtype == torch.int32 and lv.shape == (b, 1)
        toks.append(tok)
        lvs.append(lv)
        lgs.append(logits[:, 0])
    got_tok = torch.cat(toks, 1).numpy()
    got_lv = torch.cat(lvs, 1).numpy()
    top2 = np.sort(np.stack(scan_logits, 1), -1)[..., -2:]  # (B, T, 2)
    wide = top2[..., 1] - top2[..., 0] > 2 * LOGIT_F32
    assert wide.any()
    np.testing.assert_array_equal(got_tok[wide], ref_tok[wide])
    np.testing.assert_array_equal(got_lv[wide], ref_lv[wide])
    if not early_exit:
        for g, r in zip(lgs, scan_logits):
            assert np.abs(g.numpy() - r).max() <= LOGIT_F32


@pytest.mark.parametrize("levels", [None, 5])
def test_progressive_steps_equal_the_one_shot_steps(params, levels):
    """On the port alone, bit for bit: the streamed head commits the
    one-shot head's argmax with its logits at every step (prefill and
    decode); early exit commits the same tokens at the same levels; the
    prefill's exit levels are reported (test_early_exit.py)."""
    _, tcfg = _cfgs(levels)
    tprep = te.prepare_params(tcfg, params[2])
    b, s = PROMPT.shape
    prompt = {"tokens": torch.from_numpy(PROMPT)}
    p_one = te.make_prefill_step(tcfg, s + STEPS, torch.float32)
    p_scan = te.make_prefill_step(tcfg, s + STEPS, torch.float32,
                                  progressive=True)
    p_exit = te.make_prefill_step(tcfg, s + STEPS, torch.float32,
                                  progressive=True, early_exit=True)
    d_one = te.make_decode_step(tcfg)
    d_scan = te.make_decode_step(tcfg, progressive=True)
    d_exit = te.make_decode_step(tcfg, progressive=True, early_exit=True)
    st_o, lg_o = p_one(tprep, prompt)
    st_s, lg_s, tok_s, lv_s = p_scan(tprep, prompt)
    st_e, _, tok_e, lv_e = p_exit(tprep, prompt)
    for _ in range(STEPS):
        _eq(lg_s, lg_o.numpy())
        _eq(tok_s, torch.argmax(lg_o, -1).int().numpy())
        _eq(tok_e, tok_s.numpy())
        _eq(lv_e, lv_s.numpy())
        assert ((lv_s >= 0) & (lv_s <= 6)).all()
        tok = tok_s
        st_o, _, lg_o = d_one(tprep, st_o, tok)
        st_s, tok_s, lg_s, lv_s = d_scan(tprep, st_s, tok)
        st_e, tok_e, _, lv_e = d_exit(tprep, st_e, tok)


def test_per_call_policy_overrides_the_factory_default(params):
    """The trailing policy argument replaces the factory default: a
    budget(1) call commits the one-level argmax at level 0, the default
    (exact) runs every level."""
    _, tcfg = _cfgs()
    tprep = params[3]
    b, s = PROMPT.shape
    prefill = te.make_prefill_step(tcfg, s + 1, torch.float32,
                                   progressive=True,
                                   policy=tpol.LevelPolicy.exact(b))
    _, _, _, lv = prefill(tprep, {"tokens": torch.from_numpy(PROMPT)})
    assert (lv == 6).all()
    _, _, _, lv = prefill(tprep, {"tokens": torch.from_numpy(PROMPT)},
                          tpol.LevelPolicy.budget(1, b))
    assert (lv == 0).all()


def test_decode_updates_the_state_in_place(params):
    """The reference donates its decode state; the port's decode step
    writes the caches and ``pos`` into the tensors it was given."""
    _, tcfg = _cfgs()
    tprep = params[3]
    b, s = PROMPT.shape
    state, _, tok, _ = te.make_prefill_step(
        tcfg, s + STEPS, torch.float32, progressive=True)(
        tprep, {"tokens": torch.from_numpy(PROMPT)})
    tensors = [state.pos, *state.stack[0]]
    ptrs = [t.data_ptr() for t in tensors if t is not None]
    decode = te.make_decode_step(tcfg, progressive=True)
    new, _, _, _ = decode(tprep, state, tok)
    assert [t.data_ptr() for t in (new.pos, *new.stack[0])
            if t is not None] == ptrs
    assert (state.pos == s + 1).all() and new.pos is state.pos
