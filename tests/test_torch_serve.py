"""Port parity for serving (the non-progressive core of ROADMAP A11):
``prepare_params``, the prefill and decode step factories,
``greedy_generate`` and the launcher, against repro's at
``get_smoke("smollm-135m")`` (6 layers, d = 96, f32), params built by
JAX's ``materialize`` and carried across by value.

Logits hold to LOGIT_F32 on every row, on the float path and on the L2R
path at full depth and at 5 levels.  (Each L2R dense re-quantizes its
input, so a last-bit difference upstream could round an int8 activation
code the other way, as it does on a few rows of tests/test_torch_lm.py;
on this prompt no code of the serving run does, and the bound allows
none.)  Greedy tokens must equal the reference's wherever the
reference's top-1/top-2 margin exceeds twice the tolerance, and the
test requires such positions to exist.
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
from repro.models import transformer as jt
from repro.serve import engine as je
from repro_torch.configs import get_smoke
from repro_torch.core import quant as tq
from repro_torch.launch import serve as launch
from repro_torch.models import transformer as tt
from repro_torch.models.common import materialize
from repro_torch.models.encdec import encdec_build
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.serve import engine as te
from test_torch_train import _one_torch_thread  # noqa: F401

ARCH = "smollm-135m"
STEPS = 4  # the prefill's token, then three decode steps
# |logits| <= ~1 here: f32 sums in other orders through the float stack;
# the prefill's logits at 5 levels and at full depth differ by ~0.7
LOGIT_F32 = 1e-4


def _cfgs(l2r):
    """(reference cfg, port cfg): float (None), L2R at full depth
    ("full") or at ``l2r`` levels."""
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


PROMPT = np.random.default_rng(3).integers(0, 512, (2, 8)).astype(np.int32)


@pytest.fixture(scope="module")
def reference(params):
    """The reference's prefill and decode steps (the loop of its
    ``greedy_generate``) along its own greedy tokens, per config, made
    once: (tokens (B, STEPS), logits per step (B, V))."""
    runs = {}

    def run(l2r):
        if l2r not in runs:
            jcfg, _ = _cfgs(l2r)
            jp = je.prepare_params(jcfg, params[0])
            b, s = PROMPT.shape
            prefill = jax.jit(je.make_prefill_step(jcfg, s + STEPS,
                                                   jnp.float32))
            decode = jax.jit(je.make_decode_step(jcfg))
            state, logits = prefill(jp, {"tokens": jnp.asarray(PROMPT)})
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks, lgs = [tok], [logits]
            for _ in range(STEPS - 1):
                state, tok, logits = decode(jp, state, tok)
                toks.append(tok)
                lgs.append(logits)
            runs[l2r] = (np.asarray(jnp.concatenate(toks, 1)),
                         [np.asarray(lg)[:, 0] for lg in lgs])
        return runs[l2r]

    return run


@pytest.mark.parametrize("l2r", [None, "full", 5])
def test_steps_and_greedy_generate_follow_the_reference(params, reference,
                                                        l2r):
    """The port's prefill and decode steps fed the reference's tokens:
    logits within LOGIT_F32 at every step, the same greedy token
    wherever the reference's margin exceeds twice LOGIT_F32.  Then
    ``greedy_generate`` (the prefill plus three decode steps): the
    reference's tokens up to the first position whose margin does not
    (after it the two may part)."""
    _, tcfg = _cfgs(l2r)
    tp = te.prepare_params(tcfg, params[1])
    ref_toks, ref_logits = reference(l2r)
    prefill = te.make_prefill_step(tcfg, 8 + STEPS, torch.float32)
    decode = te.make_decode_step(tcfg)
    state, logits = prefill(tp, {"tokens": torch.from_numpy(PROMPT)})
    got = [logits[:, 0]]
    for i in range(STEPS - 1):
        fed = torch.from_numpy(ref_toks[:, i:i + 1].copy())
        state, tok, logits = decode(tp, state, fed)
        assert tok.dtype == torch.int32 and tok.shape == (2, 1)
        assert torch.equal(tok[:, 0], torch.argmax(logits[:, 0], -1).int())
        got.append(logits[:, 0])
    wide = []
    for g, r in zip(got, ref_logits):
        g = g.numpy()
        d = np.abs(g - r).max(-1)
        assert (d <= LOGIT_F32).all(), d
        top2 = np.sort(r, -1)[:, -2:]
        wide.append(top2[:, 1] - top2[:, 0] > 2 * LOGIT_F32)
        np.testing.assert_array_equal(g.argmax(-1)[wide[-1]],
                                      r.argmax(-1)[wide[-1]])
    wide = np.stack(wide, 1)  # (B, STEPS)
    assert wide.any()
    gen = te.greedy_generate(tcfg, tp, torch.from_numpy(PROMPT), STEPS)
    assert gen.shape == (2, STEPS) and gen.dtype == torch.int32
    for row in range(2):
        n = STEPS if wide[row].all() else int(np.argmin(wide[row]))
        np.testing.assert_array_equal(gen[row, :n].numpy(),
                                      ref_toks[row, :n])


def test_prepare_params_is_the_identity_without_l2r(params):
    _, tcfg = _cfgs(None)
    assert te.prepare_params(tcfg, params[1]) is params[1]


def test_unported_options_raise_naming_their_slice():
    """Every slice named here is ported now: the options that used to
    raise run, and what the reference refuses the port refuses alike."""
    cfg = get_smoke(ARCH)
    # the rest of serving (A11) is ported: progressive steps need only an
    # L2R config, as the reference's assert it
    with pytest.raises(AssertionError, match="cfg.l2r"):
        te.make_prefill_step(cfg, 16, progressive=True)
    with pytest.raises(AssertionError, match="cfg.l2r"):
        te.make_decode_step(cfg, progressive=True)
    # the other mixers (A10) are ported: a MoE model builds
    moe = tt.lm_build(get_smoke("deepseek-moe-16b"))
    assert set(moe["stack"][0]["ffn"]) >= {"router", "wi", "wo", "shared_wi"}
    # digit-serial attention (A9b) is ported: attn_l2r runs
    attn_l2r = dataclasses.replace(cfg, attn_l2r=tq.QuantConfig())
    tp = {"wq": torch.zeros(96, 96), "wk": torch.zeros(96, 32),
          "wv": torch.zeros(96, 32), "wo": torch.zeros(96, 96)}
    pos = torch.arange(2, dtype=torch.int32)[None]
    out, _ = tt.attn_apply(attn_l2r, tp, torch.zeros(1, 2, 96), mode="train",
                           rope_positions=pos, positions=pos, cache=None,
                           window=None)
    assert out.shape == (1, 2, 96) and not out.any()
    # encoder-decoder serving (A10) runs: a prefill step on the CPU
    wcfg = get_smoke("whisper-base")
    wp = materialize(encdec_build(wcfg), torch.Generator().manual_seed(0),
                     device="cpu")
    state, logits = te.make_prefill_step(wcfg, 16, torch.float32)(
        wp, {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "frames": torch.zeros((1, wcfg.encoder_seq, wcfg.d_model))})
    assert logits.shape == (1, 1, wcfg.vocab) and state.pos.tolist() == [4]
    # ... and the launcher refuses it, as the reference's does
    with pytest.raises(AssertionError, match="use examples for enc-dec"):
        launch.main(["--arch", "whisper-base", "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("flags", [
    ["--l2r"], ["--l2r-levels", "5"], [], ["--wq"], ["--gateway"],
    ["--l2r", "--gateway"], ["--wq", "--gateway"]])
def test_launcher_serves_on_the_cpu(flags, capsys):
    seqs = launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "8", "--steps", "4",
                        *flags])
    assert seqs.shape == (2, 4)
    assert ((seqs >= 0) & (seqs < get_smoke(ARCH).vocab)).all()
    out = capsys.readouterr().out
    assert ("tok/s" if "--gateway" in flags else "ms/token") in out
    assert "seq1:" in out


def test_launcher_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--arch", ARCH, "--smoke", "--batch", "2",
                     "--prompt-len", "8", "--steps", "4", "--l2r"])
