"""Port parity for the other mixers inside the LM stack (ROADMAP A10):
the descriptor trees of all ten architectures, ``lm_forward`` with
``ssd``, ``rec`` and ``moe`` layers against repro's at the smoke configs
(mamba2, recurrentgemma, deepseek, llama4; f32), serving (the reference's
prefill-decode spec on the port, greedy tokens, the batcher), the
``prepare_params`` caveat, and the new trees crossing from the reference
by value and as its ``.npz`` checkpoints.  Params are built by JAX's
``materialize`` and carried across by ``lm_params_from_jax``.

Hidden states of the float path hold to HIDDEN_F32 of each row's largest
|value| (f32 sums in other orders through 4-5 layers; measured up to
4e-5, deepseek).  With an L2R
config a last-bit difference ahead of a ``dense`` can move an int8
activation code by one, which carries to the rest of the row's sequence
(through the recurrent state too): every row holds to FLIP_L2R of its
largest |value| and at least half of the rows to HIDDEN_L2R, as in
tests/test_torch_lm.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmgr
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.core import quant as jq
from repro.models import common as jc
from repro.models import encdec as je
from repro.models import transformer as jt
from repro.serve import engine as jeng
from repro_torch.checkpoint import load_pytree
from repro_torch.checkpoint.manager import _leaves
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.core import quant as tq
from repro_torch.models import common as tc
from repro_torch.models import encdec as te
from repro_torch.models import transformer as tt
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve import engine as teng
from test_torch_train import _one_torch_thread  # noqa: F401

MIXERS = ["mamba2-130m", "recurrentgemma-2b", "deepseek-moe-16b",
          "llama4-maverick-400b-a17b"]
HIDDEN_F32, HIDDEN_L2R, FLIP_L2R = 1e-4, 2e-5, 0.05


def _cfgs(arch, l2r=False):
    jcfg, tcfg = j_get_smoke(arch), get_smoke(arch)
    if l2r:
        jcfg = dataclasses.replace(jcfg, l2r=jq.QuantConfig())
        tcfg = dataclasses.replace(tcfg, l2r=tq.QuantConfig())
    return jcfg, tcfg


_PARAMS: dict = {}


def _params(arch):
    """(reference params, port params) of the smoke config, made once."""
    if arch not in _PARAMS:
        jcfg = j_get_smoke(arch)
        build = je.encdec_build if jcfg.family == "encdec" else jt.lm_build
        jp = jc.materialize(build(jcfg), jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                                device="cpu"))
    return _PARAMS[arch]


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


def _row_rel(got, ref):
    """|got - ref| / |ref| per row: the largest of each (last axis)."""
    got = np.asarray(got, np.float32).reshape(-1, ref.shape[-1])
    ref = np.asarray(ref, np.float32).reshape(-1, ref.shape[-1])
    return np.abs(got - ref).max(-1) / np.abs(ref).max(-1)


def _assert_rows(got, ref, l2r):
    rel = _row_rel(got, ref)
    if not l2r:
        assert rel.max() <= HIDDEN_F32, rel.max()
        return
    assert rel.max() <= FLIP_L2R, rel.max()
    assert (rel <= HIDDEN_L2R).mean() >= 0.5, rel


# ----------------------------------------------------- descriptor trees
def _j_desc_leaves(tree):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), p)
            for path, p in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jc.Param))[0]]


def _t_desc_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _t_desc_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [leaf for i, v in enumerate(tree)
                for leaf in _t_desc_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_desc_trees_match_the_reference(arch):
    """Full configs: every leaf's key, shape, axes, init and scale (no
    tensor is made)."""
    assert tuple(J_ARCHS) == tuple(ARCHS)
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    if tcfg.family == "encdec":
        jd, td = je.encdec_build(jcfg), te.encdec_build(tcfg)
    else:
        jd, td = jt.lm_build(jcfg), tt.lm_build(tcfg)
    jl, tl = _j_desc_leaves(jd), _t_desc_leaves(td)
    assert [k for k, _ in tl] == [k for k, _ in jl]
    for (k, t), (_, j) in zip(tl, jl):
        assert (t.shape, t.axes, t.init, t.scale) == \
            (j.shape, j.axes, j.init, j.scale), k
    assert tc.count_params(td) == jc.count_params(jd)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward(arch):
    """The reference's test_models_smoke.py::test_smoke_forward on the
    port: every architecture builds and runs a train forward on the CPU,
    finite, of the expected shapes (aux an f32 scalar)."""
    cfg = get_smoke(arch)
    rng = np.random.default_rng(1)
    b, s = 2, 16
    build = te.encdec_build if cfg.family == "encdec" else tt.lm_build
    params = tc.materialize(build(cfg), torch.Generator().manual_seed(0),
                            device="cpu")
    if cfg.family == "encdec":
        frames = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        hidden, _, aux = te.encdec_forward(
            cfg, params, tokens=torch.from_numpy(_tokens(cfg, b, s, 1)),
            frames=frames)
    else:
        kw = {}
        if cfg.embeds_input:
            kw["embeds"] = torch.from_numpy(
                rng.standard_normal((b, s, cfg.d_model)).astype(np.float32))
            if cfg.rope_mode == "mrope":
                pos = torch.arange(s, dtype=torch.int32).expand(b, s)
                kw["rope_positions"] = torch.stack([pos, pos * 0, pos * 0])
        else:
            kw["tokens"] = torch.from_numpy(_tokens(cfg, b, s, 1))
        hidden, _, aux = tt.lm_forward(cfg, params, **kw)
        logits = tt.logits_from_hidden(cfg, params, hidden)
        assert logits.shape == (b, s, cfg.vocab)
        assert torch.isfinite(logits).all()
    assert hidden.shape == (b, s, cfg.d_model)
    assert torch.isfinite(hidden).all()
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert (float(aux) > 0) == (cfg.family == "moe")


# ------------------------------------------------------------ lm_forward
@pytest.mark.parametrize("arch", MIXERS)
@pytest.mark.parametrize("l2r", [False, True])
def test_lm_forward_train(arch, l2r):
    jcfg, tcfg = _cfgs(arch, l2r)
    jp, tp = _params(arch)
    toks = _tokens(tcfg, 2, 12, 2)
    jh, _, jaux = jax.jit(lambda p, t: jt.lm_forward(jcfg, p, tokens=t))(
        jp, jnp.asarray(toks))
    th, _, taux = tt.lm_forward(tcfg, tp, tokens=torch.from_numpy(toks))
    _assert_rows(th, np.asarray(jh), l2r)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", MIXERS[:2])
@pytest.mark.parametrize("l2r", [False, True])
def test_lm_prefill_then_decode(arch, l2r):
    """Prefill 10 tokens and decode 2 against the reference, with the
    recurrent states written in place (the state's tensors keep their
    storage)."""
    jcfg, tcfg = _cfgs(arch, l2r)
    jp, tp = _params(arch)
    toks = _tokens(tcfg, 2, 12, 3)
    jst = jt.init_lm_state(jcfg, 2, 16, jnp.float32)
    tst = tt.init_lm_state(tcfg, 2, 16, torch.float32, device="cpu")
    ptrs = [t.data_ptr() for _, t in _leaves(tst.stack)]
    fwd = {mode: jax.jit(lambda p, t, st, mode=mode: jt.lm_forward(
        jcfg, p, tokens=t, mode=mode, state=st)) for mode in ("prefill",
                                                            "decode")}
    jh, jst, _ = fwd["prefill"](jp, jnp.asarray(toks[:, :10]), jst)
    th, tst, _ = tt.lm_forward(tcfg, tp, tokens=torch.from_numpy(toks[:, :10]),
                               mode="prefill", state=tst)
    _assert_rows(th, np.asarray(jh), l2r)
    for pos in (10, 11):
        jh, jst, _ = fwd["decode"](jp, jnp.asarray(toks[:, pos:pos + 1]),
                                   jst)
        th, tst, _ = tt.lm_forward(
            tcfg, tp, tokens=torch.from_numpy(toks[:, pos:pos + 1]),
            mode="decode", state=tst)
        _assert_rows(th, np.asarray(jh), l2r)
    assert [t.data_ptr() for _, t in _leaves(tst.stack)] == ptrs
    # the states themselves: the reference's, stacked and unrolled alike
    for (k, t), r in zip(_leaves(tst.stack), jax.tree.leaves(jst.stack)):
        r = np.asarray(r, np.float32)
        assert tuple(t.shape) == r.shape, k
        if "positions" not in k:
            tol = FLIP_L2R if l2r else 1e-4
            assert np.abs(t.numpy() - r).max() <= tol * np.abs(r).max(), k


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-27b",
                                  "mamba2-130m", "recurrentgemma-2b"])
def test_prefill_decode_matches_train_forward(arch):
    """tests/test_serve.py's spec, on the port alone (its atol)."""
    cfg = get_smoke(arch)
    _, params = _params(arch)
    toks = torch.from_numpy(_tokens(cfg, 2, 12, 2))
    h, _, _ = tt.lm_forward(cfg, params, tokens=toks, mode="train")
    st = tt.init_lm_state(cfg, 2, max_len=16, dtype=torch.float32,
                          device="cpu")
    _, st, _ = tt.lm_forward(cfg, params, tokens=toks[:, :11], mode="prefill",
                             state=st)
    h_dec, _, _ = tt.lm_forward(cfg, params, tokens=toks[:, 11:12],
                                mode="decode", state=st)
    np.testing.assert_allclose(h[:, 11:12].numpy(), h_dec.numpy(), atol=5e-2)


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", MIXERS[:3])
def test_greedy_generate_follows_the_reference(arch):
    """The reference's prefill and decode steps along its own greedy
    tokens; the port's ``greedy_generate`` equals them up to the first
    position whose top-1/top-2 margin is within 2 x 1e-4 (after it the
    two may part), and such wide positions exist."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    prompt, steps = _tokens(tcfg, 2, 8, 4), 4
    prefill = jax.jit(jeng.make_prefill_step(jcfg, 8 + steps, jnp.float32))
    decode = jax.jit(jeng.make_decode_step(jcfg))
    st, lg = prefill(jp, {"tokens": jnp.asarray(prompt)})
    toks, wide = [], []
    for _ in range(steps):
        r = np.asarray(lg)[:, 0]
        top2 = np.sort(r, -1)[:, -2:]
        wide.append(top2[:, 1] - top2[:, 0] > 2e-4)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        st, _, lg = decode(jp, st, tok)
    ref, wide = np.concatenate(toks, 1), np.stack(wide, 1)
    assert wide.any()
    gen = teng.greedy_generate(tcfg, tp, torch.from_numpy(prompt), steps)
    assert gen.dtype == torch.int32 and gen.shape == (2, steps)
    for row in range(2):
        n = steps if wide[row].all() else int(np.argmin(wide[row]))
        np.testing.assert_array_equal(gen[row, :n].numpy(), ref[row, :n])


def test_batcher_serves_mamba2_like_greedy_generate():
    """``ContinuousBatcher`` on an SSD model (exact-length prefill; the
    recurrent states spliced into slots and written in place by decode):
    each request's tokens equal its own ``greedy_generate``."""
    cfg = get_smoke("mamba2-130m")
    _, params = _params("mamba2-130m")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (8, 5, 11)]
    refs = [teng.greedy_generate(cfg, params, torch.from_numpy(p[None]),
                                 steps=6, max_len=32)[0].tolist()
            for p in prompts]
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=32, device="cpu")
    assert not eng.bucketed
    reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=100)
    for r, ref in zip(reqs, refs):
        assert r.done and r.output == ref, (r.uid, r.output, ref)


@pytest.mark.parametrize("arch", MIXERS[:2])
def test_both_packages_refuse_prepared_recurrent_params(arch):
    """``prepare_params`` makes the depthwise ``conv_w`` (a 2-D normal-init
    leaf) a weight record, and the prefill then fails on it, in the
    reference and in the port alike (ROADMAP, "Caveats on the
    reference"); raw params serve (each dense quantizing per call)."""
    jcfg, tcfg = _cfgs(arch, True)
    jp, tp = _params(arch)
    jprep, tprep = jeng.prepare_params(jcfg, jp), teng.prepare_params(tcfg, tp)
    prompt = _tokens(tcfg, 2, 8, 6)
    with pytest.raises(TypeError, match="not subscriptable"):
        jeng.make_prefill_step(jcfg, 12, jnp.float32)(
            jprep, {"tokens": jnp.asarray(prompt)})
    with pytest.raises(TypeError, match="not subscriptable"):
        teng.make_prefill_step(tcfg, 12, torch.float32)(
            tprep, {"tokens": torch.from_numpy(prompt)})
    _, lg = teng.make_prefill_step(tcfg, 12, torch.float32)(
        tp, {"tokens": torch.from_numpy(prompt)})
    assert torch.isfinite(lg).all()


def test_prepared_deepseek_serves_as_the_reference():
    """deepseek serves prepared params: the router and shared experts
    become weight records (bit for bit the reference's), the expert
    stacks stay float; the prefill's and decode steps' logits follow the
    reference's."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b", True)
    jp, tp = _params("deepseek-moe-16b")
    jprep, tprep = jeng.prepare_params(jcfg, jp), teng.prepare_params(tcfg, tp)
    moe = tprep["stack"][0]["ffn"]
    assert all(isinstance(moe[k], tq.QuantizedWeights)
               for k in ("router", "shared_wi", "shared_wo"))
    assert isinstance(moe["wi"], torch.Tensor)
    jr = jprep["stack"][0]["ffn"]["router"]
    np.testing.assert_array_equal(moe["router"].q.numpy(), np.asarray(jr.q))
    np.testing.assert_array_equal(moe["router"].scale.numpy(),
                                  np.asarray(jr.scale))
    prompt = _tokens(tcfg, 2, 8, 7)
    jst, jl = jax.jit(jeng.make_prefill_step(jcfg, 12, jnp.float32))(
        jprep, {"tokens": jnp.asarray(prompt)})
    tst, tl = teng.make_prefill_step(tcfg, 12, torch.float32)(
        tprep, {"tokens": torch.from_numpy(prompt)})
    decode = jax.jit(jeng.make_decode_step(jcfg))
    tdecode = teng.make_decode_step(tcfg)
    for _ in range(3):
        _assert_rows(tl, np.asarray(jl), True)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jst, _, jl = decode(jprep, jst, tok)
        tst, _, tl = tdecode(tprep, tst, torch.from_numpy(np.asarray(tok)))


# ------------------------------------------------ trees and checkpoints
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-130m",
                                  "recurrentgemma-2b", "whisper-base"])
def test_new_trees_cross_by_value_and_as_checkpoints(arch, tmp_path):
    """``lm_params_from_jax`` carries the expert stacks (E, d, 2, f), the
    SSM and RG-LRU leaves and the encdec tree (``enc_stack``,
    ``dec_stack``) key for key, bit for bit; ``load_pytree`` reads the
    reference's ``.npz`` of the same tree into a port template (the
    port's own materialized tree) bit for bit."""
    jp, tp = _params(arch)
    jflat = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path), np.asarray(leaf))
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]]
    tflat = [(k, v.numpy()) for k, v in _leaves(tp)]
    assert len(tflat) == len(jflat)
    for (k, t), (_, j) in zip(tflat, jflat):
        assert t.dtype == j.dtype and t.shape == j.shape, k
        np.testing.assert_array_equal(t, j, err_msg=k)
    tcfg = get_smoke(arch)
    build = te.encdec_build if tcfg.family == "encdec" else tt.lm_build
    template = tc.materialize(build(tcfg), torch.Generator().manual_seed(9),
                              device="cpu")
    path = str(tmp_path / "ref.npz")
    jmgr.save_pytree(jp, path)
    loaded = load_pytree(template, path, device="cpu")
    for (k, a), (_, b) in zip(_leaves(loaded), _leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    if arch == "deepseek-moe-16b":
        wi = tp["stack"][0]["ffn"]["wi"]
        assert tuple(wi.shape) == (3, 8, 64, 2, 48)  # (layers, E, d, 2, f)
