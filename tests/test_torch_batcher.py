"""The continuous batcher of the port (serve/batching.py): its own
contracts bit for bit on the port alone, mirroring the reference's
tests/test_serving_batcher.py and the serving parts of test_policy.py,
test_early_exit.py and test_streaming.py, plus the pure functions
against repro's on the same inputs (``_pad_value``, the batch-axis tree,
``latency_percentiles``, ``progressive_stats``).

Everything runs at ``get_smoke("smollm-135m")`` on the CPU, params from
JAX's ``materialize`` carried across by value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import common as jc
from repro.models import transformer as jt
from repro.serve import batching as jb
from repro_torch.configs import get_smoke
from repro_torch.core import quant as tq
from repro_torch.core.policy import PrecisionClass
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.models.transformer import lm_build
from repro_torch.serve import engine as te
from repro_torch.serve.batching import (ContinuousBatcher, Request,
                                        _pad_value, _splice,
                                        infer_batch_axes,
                                        latency_percentiles,
                                        progressive_stats, state_batch_axes)
from test_torch_train import _one_torch_thread  # noqa: F401

ARCH = "smollm-135m"


def _port(jp):
    return lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke(ARCH)
    return cfg, _port(jc.materialize(jt.lm_build(j_get_smoke(ARCH)),
                                     jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def l2r_model(model):
    cfg = dataclasses.replace(model[0], l2r=tq.QuantConfig())
    return cfg, te.prepare_params(cfg, model[1])


def _greedy(cfg, params, prompt, steps):
    return te.greedy_generate(cfg, params, torch.from_numpy(prompt[None]),
                              steps=steps, max_len=32)[0].tolist()


def _serve(eng, reqs, max_steps=1000):
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=max_steps)
    return reqs


def test_batcher_matches_straightline_greedy(model):
    """Requests served through slot splicing give exactly the tokens of
    an isolated greedy decode of the same prompt."""
    cfg, params = model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (8, 5, 11)]
    refs = [_greedy(cfg, params, p, 6) for p in prompts]
    reqs = _serve(ContinuousBatcher(cfg, params, n_slots=2, max_len=32,
                                    device="cpu"),
                  [Request(uid=i, prompt=p, max_new_tokens=6)
                   for i, p in enumerate(prompts)])
    for r, ref in zip(reqs, refs):
        assert r.done and r.output[:6] == ref, (r.uid, r.output, ref)


def test_batcher_more_requests_than_slots(model):
    cfg, params = model
    rng = np.random.default_rng(1)
    reqs = _serve(ContinuousBatcher(cfg, params, n_slots=2, max_len=32,
                                    device="cpu"),
                  [Request(uid=i, prompt=rng.integers(0, cfg.vocab, (6,))
                           .astype(np.int32), max_new_tokens=4)
                   for i in range(5)])
    assert all(r.done and len(r.output) == 4 for r in reqs)


def test_batcher_eos_retires_early(model):
    cfg, params = model
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, (8,)) \
        .astype(np.int32)
    ref = _greedy(cfg, params, prompt, 3)
    req = Request(uid=0, prompt=prompt, max_new_tokens=10, eos_id=ref[1])
    _serve(ContinuousBatcher(cfg, params, n_slots=1, max_len=32,
                             device="cpu"), [req])
    assert req.done and req.output == ref[:2]


def test_batcher_single_layer_model_matches_greedy():
    """A stacked cache with a leading axis of size 1 splices on its batch
    axis (axis 1), never on the layer axis."""
    jcfg = dataclasses.replace(j_get_smoke(ARCH), n_layers=1)
    cfg = dataclasses.replace(get_smoke(ARCH), n_layers=1)
    params = _port(jc.materialize(jt.lm_build(jcfg), jax.random.PRNGKey(1)))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (7, 4, 9)]
    refs = [_greedy(cfg, params, p, 5) for p in prompts]
    reqs = _serve(ContinuousBatcher(cfg, params, n_slots=2, max_len=32,
                                    device="cpu"),
                  [Request(uid=i, prompt=p, max_new_tokens=5)
                   for i, p in enumerate(prompts)])
    for r, ref in zip(reqs, refs):
        assert r.done and r.output[:5] == ref


# --------------------------------------------------- slot splice surgery
def _axes_for(batch_tree, single_tree):
    two = jax.tree.map(lambda b, s: torch.empty(
        tuple(2 if bd != sd else sd for bd, sd in zip(b.shape, s.shape)),
        device="meta"), batch_tree, single_tree)
    return infer_batch_axes(single_tree, two)


def test_splice_stacked_leaf_with_single_layer():
    n_slots, n_layers, length, dh = 4, 1, 6, 3
    b = {"cache": torch.zeros((n_layers, n_slots, length, dh)),
         "pos": torch.zeros((n_slots,), dtype=torch.int32)}
    s = {"cache": torch.ones((n_layers, 1, length, dh)),
         "pos": torch.full((1,), 5, dtype=torch.int32)}
    axes = _axes_for(b, s)
    assert axes == {"cache": 1, "pos": 0}
    out = _splice(b, s, 2, axes)
    assert out is b  # in place
    assert (b["cache"][0, 2] == 1).all()
    for slot in (0, 1, 3):
        assert (b["cache"][0, slot] == 0).all()
    assert int(b["pos"][2]) == 5 and int(b["pos"][0]) == 0


def test_splice_ignores_batch_independent_nslots_sized_leaf():
    n_slots = 4
    b = {"per_layer": torch.arange(n_slots, dtype=torch.float32),
         "kv": torch.zeros((1, n_slots, 6, n_slots)),
         "pos": torch.zeros((n_slots,), dtype=torch.int32)}
    s = {"per_layer": torch.arange(n_slots, dtype=torch.float32),
         "kv": torch.ones((1, 1, 6, n_slots)),
         "pos": torch.full((1,), 3, dtype=torch.int32)}
    axes = _axes_for(b, s)
    assert axes["per_layer"] == -1 and axes["kv"] == 1
    _splice(b, s, 1, axes)
    assert torch.equal(b["per_layer"], torch.arange(n_slots,
                                                    dtype=torch.float32))
    assert (b["kv"][0, 1] == 1).all() and (b["kv"][0, 0] == 0).all()


def test_pad_value_matches_the_reference_for_every_dtype():
    """The empty sentinel covers every integer dtype (the int8 key planes
    of attn_l2r included), as the reference pads."""
    for tdt, jdt in ((torch.int32, jnp.int32), (torch.int8, jnp.int8),
                     (torch.int16, jnp.int16), (torch.int64, jnp.int32),
                     (torch.uint8, jnp.uint8), (torch.uint32, jnp.uint32),
                     (torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        assert _pad_value(torch.zeros((1,), dtype=tdt)) == \
            jb._pad_value(jnp.zeros((1,), jdt)), tdt
    b = {"positions": torch.zeros((4, 8), dtype=torch.int8)}
    s = {"positions": torch.arange(1, 6, dtype=torch.int8).reshape(1, 5)}
    _splice(b, s, 2, {"positions": 0})
    assert torch.equal(b["positions"][2, :5],
                       torch.arange(1, 6, dtype=torch.int8))
    assert (b["positions"][2, 5:] == -1).all()
    assert (b["positions"][:2] == 0).all()


@pytest.mark.parametrize("attn_l2r", [False, True])
def test_state_batch_axes_match_the_reference(attn_l2r):
    extra = {"attn_l2r": tq.QuantConfig()} if attn_l2r else {}
    cfg = dataclasses.replace(get_smoke(ARCH), **extra)
    from repro.core import quant as jq
    jcfg = dataclasses.replace(
        j_get_smoke(ARCH), **({"attn_l2r": jq.QuantConfig()} if attn_l2r
                              else {}))
    got = state_batch_axes(cfg, 16)
    ref = jb.state_batch_axes(jcfg, 16)
    assert got.pos == ref.pos == 0
    assert got.prefix == ref.prefix == [] and got.suffix == ref.suffix == []
    assert [tuple(c) for c in got.stack] == [tuple(c) for c in ref.stack]
    assert all(v == 1 for c in got.stack for v in c if v is not None)


# ------------------------------------------- in place / buckets / latency
def test_batcher_decode_keeps_the_state_storage(model):
    """The reference donates its state to the decode step; here every state
    tensor keeps its storage across a step (the batcher asserts it), and
    ``donate_state=False`` leaves the previous state intact."""
    cfg, params = model
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (6,)) \
        .astype(np.int32)
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=32,
                            device="cpu")
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=8))
    k0 = eng.state.stack[0].k
    eng.step()
    eng.step()
    assert eng.state.stack[0].k.data_ptr() == k0.data_ptr()

    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=32,
                            donate_state=False, device="cpu")
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=8))
    eng.step()
    k0 = eng.state.stack[0].k
    snap = k0.clone()
    eng.step()
    assert eng.state.stack[0].k.data_ptr() != k0.data_ptr()
    assert torch.equal(k0, snap)  # the old state was not written


def test_batcher_bucketed_matches_unbucketed(model):
    """The bucket pad is bit-invisible: same tokens with bucketing off."""
    cfg, params = model
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (5, 11, 3)]

    def run(bucketed):
        eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=32,
                                bucketed=bucketed, device="cpu")
        assert eng.bucketed == bucketed
        return [r.output for r in _serve(
            eng, [Request(uid=i, prompt=p, max_new_tokens=5)
                  for i, p in enumerate(prompts)])]

    assert run(True) == run(False)


def test_batcher_latency_stats_opt_in(model):
    cfg, params = model
    rng = np.random.default_rng(8)
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=32,
                            device="cpu")
    reqs = _serve(eng, [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, (5,)).astype(np.int32), max_new_tokens=3)
        for i in range(3)])
    plain = eng.stats()
    for k in ("completed", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
              "tpot_p99_s"):
        assert k not in plain
    lat = eng.stats(latency=True)
    assert lat["completed"] == 3
    assert lat["ttft_p99_s"] >= lat["ttft_p50_s"] > 0
    assert lat["tpot_p99_s"] >= lat["tpot_p50_s"] > 0
    for r in reqs:
        assert r.t_arrival <= r.t_first_token <= r.t_complete


def test_stats_helpers_match_the_reference():
    rng = np.random.default_rng(9)
    ttft, tpot = list(rng.uniform(0, 1, 7)), list(rng.uniform(0, 1, 5))
    assert latency_percentiles(ttft, tpot) == \
        jb.latency_percentiles(ttft, tpot)
    assert latency_percentiles([], []) == jb.latency_percentiles([], [])
    hist = rng.integers(0, 9, 7)
    phist = rng.integers(0, 3, 7)
    by = {"exact": rng.integers(0, 4, 7), "budget(3)": rng.integers(0, 4, 7)}
    pby = {"bounded(0)": rng.integers(0, 2, 7)}
    assert progressive_stats(7, hist, phist, by, pby) == \
        jb.progressive_stats(7, hist, phist, by, pby)
    z = np.zeros(1, np.int64)
    assert progressive_stats(1, z, z, {}, {}) == \
        jb.progressive_stats(1, z, z, {}, {})


# ------------------------------------------------------- progressive mode
def test_batcher_progressive_stats(model, l2r_model):
    """Progressive mode: the non-progressive engine's tokens, one exit
    level per decoded token, the histogram in stats()
    (test_streaming.py)."""
    cfg, params = l2r_model
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, (6,)).astype(np.int32)
               for _ in range(3)]

    def run(progressive):
        eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=32,
                                progressive=progressive, device="cpu")
        return eng, _serve(eng, [Request(uid=i, prompt=p, max_new_tokens=4)
                                 for i, p in enumerate(prompts)])

    eng_p, reqs_p = run(True)
    eng_r, reqs_r = run(False)
    for rp, rr in zip(reqs_p, reqs_r):
        assert rp.output == rr.output
        assert len(rp.exit_levels) == len(rp.output) - 1
    st = eng_p.stats()
    assert st["progressive"] and st["n_levels"] == 7
    assert st["tokens"] == sum(len(r.exit_levels) for r in reqs_p)
    assert sum(st["exit_level_hist"]) == st["tokens"]
    assert 0.0 <= st["mean_exit_level"] <= 6.0
    assert not eng_r.stats().get("exit_level_hist")


def test_batcher_records_prefill_exit_levels(l2r_model):
    """Prefill exit levels land on the requests and in stats(); scan,
    early exit and the non-progressive engine emit the same tokens
    (test_early_exit.py)."""
    cfg, params = l2r_model
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab, (5,)).astype(np.int32)
               for _ in range(3)]

    def run(progressive, early_exit=False):
        eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=32,
                                progressive=progressive,
                                early_exit=early_exit, device="cpu")
        return eng, _serve(eng, [Request(uid=i, prompt=p, max_new_tokens=3)
                                 for i, p in enumerate(prompts)])

    eng_p, reqs_p = run(True)
    _, reqs_e = run(True, early_exit=True)
    _, reqs_r = run(False)
    for rp, re_, rr in zip(reqs_p, reqs_e, reqs_r):
        assert rp.output == rr.output == re_.output
        assert rp.prefill_exit_level is not None
        assert rp.prefill_exit_level == re_.prefill_exit_level
        assert rp.exit_levels == re_.exit_levels
        assert rr.prefill_exit_level is None
    st = eng_p.stats()
    assert st["prefills"] == len(prompts)
    assert sum(st["prefill_exit_level_hist"]) == st["prefills"]
    assert 0.0 <= st["mean_prefill_exit_level"] <= st["n_levels"] - 1


CLASSES = [PrecisionClass.exact(), PrecisionClass.budget(3),
           PrecisionClass.bounded()]


def _class_requests(prompts, classes):
    return [Request(uid=i, prompt=p, max_new_tokens=4, precision=c)
            for i, (p, c) in enumerate(zip(prompts, classes))]


def test_mixed_class_batcher_matches_solo(l2r_model):
    """Each request of a mixed exact / budget(3) / bounded batch gets the
    tokens and exit levels of its solo run (test_policy.py)."""
    cfg, params = l2r_model
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (5, 7, 6)]

    def run(prompts_, classes_, n_slots):
        eng = ContinuousBatcher(cfg, params, n_slots=n_slots, max_len=32,
                                progressive=True, early_exit=True,
                                device="cpu")
        return _serve(eng, _class_requests(prompts_, classes_)), eng

    mixed, eng = run(prompts, CLASSES, 3)
    for i, c in enumerate(CLASSES):
        solo, _ = run(prompts[i:i + 1], [c], 1)
        assert mixed[i].output == solo[0].output, c.label()
        assert mixed[i].exit_levels == solo[0].exit_levels, c.label()
        assert mixed[i].prefill_exit_level == solo[0].prefill_exit_level
    st = eng.stats()
    assert set(st["exit_level_hist_by_class"]) == \
        {"exact", "budget(3)", "bounded(0)"}
    assert all(lv == 6 for lv in mixed[0].exit_levels)  # exact: full depth
    assert all(lv <= 2 for lv in mixed[1].exit_levels)  # budget(3)
    total = np.zeros(st["n_levels"], np.int64)
    for h in st["exit_level_hist_by_class"].values():
        total += np.asarray(h)
    np.testing.assert_array_equal(total, np.asarray(st["exit_level_hist"]))


def test_request_precision_requires_progressive(model):
    cfg, params = model
    eng = ContinuousBatcher(cfg, params, n_slots=1, max_len=32,
                            device="cpu")
    with pytest.raises(ValueError, match="progressive"):
        eng.submit(Request(uid=0, prompt=np.zeros(3, np.int32),
                           max_new_tokens=2,
                           precision=PrecisionClass.exact()))
    with pytest.raises(ValueError, match="progressive"):
        ContinuousBatcher(cfg, params, n_slots=1, max_len=32,
                          default_class=PrecisionClass.exact(),
                          device="cpu")


def test_batcher_refuses_params_on_another_device(model):
    cfg, params = model
    with pytest.raises(ValueError, match="on cpu"):
        ContinuousBatcher(cfg, params, n_slots=1, max_len=16, device="meta")
    assert lm_build(cfg)  # the descriptor tree still builds
