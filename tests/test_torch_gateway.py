"""The serving gateway of the port (serve/gateway.py) and bucketed
prefill (serve/engine.py): the bucket functions against repro's on the
same inputs, and the port's own contracts bit for bit, mirroring the
reference's tests/test_gateway.py and the gateway parts of
test_policy.py: bucketed == unbucketed prefill, gateway == batcher for
mixed buckets, slot churn, EOS and async-emit order, warmup over every
bucket, mixed-class gateway == batcher.

Everything runs at ``get_smoke("smollm-135m")`` on the CPU, params from
JAX's ``materialize`` carried across by value.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import common as jc
from repro.models import transformer as jt
from repro.serve import engine as je
from repro_torch.configs import get_smoke
from repro_torch.core import quant as tq
from repro_torch.core.policy import PrecisionClass
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.serve import (ContinuousBatcher, Request, ServingGateway,
                               bucket_for, greedy_generate, prefill_buckets,
                               supports_bucketed_prefill)
from repro_torch.serve import engine as te
from test_torch_train import _one_torch_thread  # noqa: F401

ARCH = "smollm-135m"


@pytest.fixture(scope="module")
def model():
    jp = jc.materialize(jt.lm_build(j_get_smoke(ARCH)), jax.random.PRNGKey(0))
    return get_smoke(ARCH), lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                               device="cpu")


@pytest.fixture(scope="module")
def prog_model(model):
    cfg = dataclasses.replace(model[0], l2r=tq.QuantConfig())
    return cfg, te.prepare_params(cfg, model[1])


def _requests(cfg, lengths, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, (n,))
                    .astype(np.int32), max_new_tokens=max_new)
            for i, n in enumerate(lengths)]


def _gateway(cfg, params, **kw):
    return ServingGateway(cfg, params, device="cpu", **kw)


# ------------------------------------------------------------- buckets
@pytest.mark.parametrize("max_len", [128, 100, 8, 5, 2080, 1])
def test_prefill_buckets_match_the_reference(max_len):
    assert prefill_buckets(max_len) == je.prefill_buckets(max_len)
    assert prefill_buckets(max_len, 4) == je.prefill_buckets(max_len, 4)
    bk = prefill_buckets(max_len)
    for n in range(1, max_len + 1, max(1, max_len // 37)):
        assert bucket_for(n, bk) == je.bucket_for(n, bk)
    with pytest.raises(ValueError) as got:
        bucket_for(max_len + 1, bk)
    with pytest.raises(ValueError) as ref:
        je.bucket_for(max_len + 1, bk)
    assert str(got.value) == str(ref.value)


def test_supports_bucketed_prefill_matches_the_reference():
    from repro.configs import ARCHS as J_ARCHS
    from repro_torch.configs import ARCHS

    assert set(ARCHS) == set(J_ARCHS)
    for arch in ARCHS:
        assert supports_bucketed_prefill(get_smoke(arch)) == \
            je.supports_bucketed_prefill(j_get_smoke(arch)), arch
    assert supports_bucketed_prefill(get_smoke(ARCH))


# the CPU's float attention sums PV over the keys in another order when
# their count changes (11 keys against a bucket's 16: the masked 5 add
# exact zeros, but the vector remainder differs), so from layer 1 on a
# real row can move by a few ulps; the card's kernels walk fixed 64-key
# tiles and are held bit for bit (tests/test_torch_cuda.py,
# chip_smoke.py phase 15d)
HIDDEN_TOL = 1e-5


@pytest.mark.parametrize("attn_l2r", [False, True])
def test_bucketed_prefill_equals_unbucketed(prog_model, attn_l2r):
    """A right-padded prompt in its bucket gives the unpadded prefill's
    cache: positions and ``pos`` exact, the slots past the prompt empty,
    layer 0's k, v (and key planes) bit for bit, every layer within
    HIDDEN_TOL, and the same first token and exit level; the dummy row
    of a packed call changes nothing."""
    cfg, params = prog_model
    if attn_l2r:
        cfg = dataclasses.replace(cfg, attn_l2r=tq.QuantConfig())
    rng = np.random.default_rng(3)
    lengths = (5, 11)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in lengths]
    lb = 16
    tokens = np.zeros((3, lb), np.int32)  # a packed call with a dummy row
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    true_len = torch.tensor([*lengths, 1], dtype=torch.int32)
    bucket = te.make_bucket_prefill_step(cfg, 32, torch.float32,
                                         progressive=True)
    st_b, lg_b, tok_b, lv_b = bucket(params, torch.from_numpy(tokens),
                                     true_len)
    assert torch.equal(st_b.pos, true_len)
    plain = te.make_prefill_step(cfg, 32, torch.float32, progressive=True)
    for i, p in enumerate(prompts):
        st_u, lg_u, tok_u, lv_u = plain(
            params, {"tokens": torch.from_numpy(p[None])})
        n = len(p)
        assert int(tok_b[i, 0]) == int(tok_u[0, 0])
        assert int(lv_b[i, 0]) == int(lv_u[0, 0])
        assert (lg_b[i] - lg_u[0]).abs().max() <= HIDDEN_TOL
        cb, cu = st_b.stack[0], st_u.stack[0]
        for name in ("k", "v", "k_planes", "k_scale"):
            a, b = getattr(cb, name), getattr(cu, name)
            if a is None:
                continue
            assert torch.equal(a[0, i, :n], b[0, 0, :n]), name
            if a.is_floating_point():
                assert (a[:, i, :n] - b[:, 0, :n]).abs().max() \
                    <= HIDDEN_TOL, name
        assert torch.equal(cb.positions[:, i], cu.positions[:, 0])
        assert (cb.positions[:, i, n:] == -1).all()
        assert torch.equal(cu.positions[:, 0, n:],
                           cb.positions[:, i, n:])


def test_bucket_prefill_asserts_the_local_window(model):
    cfg, params = model
    local = dataclasses.replace(cfg, layer_pattern=("local",), window=8)
    step = te.make_bucket_prefill_step(local, 32, torch.float32)
    with pytest.raises(AssertionError, match="window"):
        step(params, torch.zeros((1, 16), dtype=torch.int32),
             torch.ones((1,), dtype=torch.int32))


# --------------------------------------------------- gateway bit-parity
def test_gateway_matches_plain_batcher_mixed_buckets(model):
    cfg, params = model
    lengths = (3, 8, 5, 11, 17, 23, 9, 31)  # buckets 8, 16, 32
    ref = _requests(cfg, lengths)
    eng = ContinuousBatcher(cfg, params, n_slots=3, max_len=32, device="cpu")
    for r in ref:
        eng.submit(r)
    eng.run(max_steps=1000)
    served = _requests(cfg, lengths)
    gw = _gateway(cfg, params, n_slots=4, max_len=32, prefill_group=3)
    gw.run(served)
    gw.close()
    for a, b in zip(ref, served):
        assert b.done and a.output == b.output, (a.uid, a.output, b.output)
    assert gw.prefill_shapes <= {(3, lb) for lb in gw.buckets}


def test_gateway_matches_straightline_greedy(model):
    cfg, params = model
    reqs = _requests(cfg, (8, 5, 11))
    refs = [greedy_generate(cfg, params, torch.from_numpy(r.prompt[None]),
                            steps=6, max_len=32)[0].tolist() for r in reqs]
    gw = _gateway(cfg, params, n_slots=2, max_len=32, prefill_group=2)
    gw.run(reqs)
    gw.close()
    for r, ref in zip(reqs, refs):
        assert r.done and r.output[:6] == ref, (r.uid, r.output, ref)


def test_gateway_progressive_exit_level_parity(prog_model):
    """Progressive early exit: tokens, exit levels and prefill exit levels
    equal the plain batcher's."""
    cfg, params = prog_model
    lengths = (4, 9, 6, 13)
    ref = _requests(cfg, lengths)
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=32,
                            progressive=True, early_exit=True, device="cpu")
    for r in ref:
        eng.submit(r)
    eng.run(max_steps=1000)
    served = _requests(cfg, lengths)
    gw = _gateway(cfg, params, n_slots=3, max_len=32, prefill_group=2,
                  progressive=True, early_exit=True)
    gw.run(served)
    gw.close()
    for a, b in zip(ref, served):
        assert a.output == b.output
        assert a.exit_levels == b.exit_levels
        assert a.prefill_exit_level == b.prefill_exit_level
    st = gw.stats()
    assert st["tokens"] == sum(len(r.output) for r in served)
    assert sum(st["exit_level_hist"]) == sum(len(r.exit_levels)
                                             for r in served)


# ------------------------------------------------------------ slot churn
def test_gateway_slot_churn_under_full_queue(model):
    cfg, params = model
    reqs = _requests(cfg, (6, 4, 7, 5, 9, 3, 8, 6, 5, 4, 7, 6), max_new=4,
                     seed=1)
    gw = _gateway(cfg, params, n_slots=2, max_len=32, prefill_group=2)
    gw.run(reqs)
    gw.close()
    assert all(r.done and len(r.output) == 4 for r in reqs)
    st = gw.stats()
    assert st["completed"] == len(reqs) and st["tokens"] == 4 * len(reqs)


def test_gateway_eos_retires_early(model):
    cfg, params = model
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, (8,)) \
        .astype(np.int32)
    ref = greedy_generate(cfg, params, torch.from_numpy(prompt[None]),
                          steps=3, max_len=32)[0].tolist()
    req = Request(uid=0, prompt=prompt, max_new_tokens=10, eos_id=ref[1])
    filler = _requests(cfg, (5, 6, 7), max_new=8, seed=3)
    gw = _gateway(cfg, params, n_slots=2, max_len=32, prefill_group=2)
    gw.run([req] + filler)
    gw.close()
    assert req.done and req.output == ref[:2]
    assert all(r.done and len(r.output) == 8 for r in filler)


# ------------------------------------------------------------ async emit
def test_gateway_async_emit_ordering_matches_sync(model):
    cfg, params = model
    lengths = (5, 9, 4, 12, 7)
    sync = _requests(cfg, lengths)
    gw_s = _gateway(cfg, params, n_slots=2, max_len=32, prefill_group=2,
                    async_emit=False)
    gw_s.run(sync)
    gw_s.close()
    async_ = _requests(cfg, lengths)
    gw_a = _gateway(cfg, params, n_slots=2, max_len=32, prefill_group=2,
                    async_emit=True, emit_queue_depth=2)
    gw_a.run(async_)
    gw_a.close()
    for a, b in zip(sync, async_):
        assert a.output == b.output, (a.uid, a.output, b.output)
        assert b.t_arrival <= b.t_first_token <= b.t_complete


def test_gateway_emit_thread_error_propagates(model):
    cfg, params = model
    gw = _gateway(cfg, params, n_slots=2, max_len=32, prefill_group=2,
                  aot_warmup=False)
    gw._emit.put(("bogus-kind-causes-unpack-error",))
    with pytest.raises(ValueError):
        gw._emit.flush()
    gw.close()


# --------------------------------------------------------------- warmup
def test_gateway_warmup_covers_every_bucket(model):
    """Warmup runs each bucket's prefill at the group shape and the decode
    step once; serving afterwards calls only warmed shapes."""
    cfg, params = model
    gw = _gateway(cfg, params, n_slots=2, max_len=32, prefill_group=2)
    assert set(gw.warmup_s) == {8, 16, 32, "decode"}
    assert all(s >= 0 for s in gw.warmup_s.values())
    assert not gw.state.pos.any()  # warmup decoded a scratch state
    reqs = _requests(cfg, (3, 9, 20), max_new=3)
    gw.run(reqs)
    gw.close()
    assert all(r.done for r in reqs)
    assert gw.prefill_shapes == {(2, 8), (2, 16), (2, 32)}
    assert set(gw.warmup_s) == {8, 16, 32, "decode"}  # nothing new
    cold = _gateway(cfg, params, n_slots=2, max_len=32, aot_warmup=False)
    assert cold.warmup_s == {}
    cold.close()


def test_gateway_realtime_honors_arrival_stamps(model):
    cfg, params = model
    lengths = (5, 7, 4)
    offline = _requests(cfg, lengths, max_new=3)
    gw1 = _gateway(cfg, params, n_slots=2, max_len=32, prefill_group=2)
    gw1.run(offline)
    gw1.close()
    online = _requests(cfg, lengths, max_new=3)
    gw2 = _gateway(cfg, params, n_slots=2, max_len=32, prefill_group=2)
    t0 = time.perf_counter()
    for i, r in enumerate(online):
        r.t_arrival = t0 + 0.02 * i
        gw2.submit(r)
    gw2.run(realtime=True)
    gw2.close()
    for a, b in zip(offline, online):
        assert a.output == b.output and b.t_first_token >= b.t_arrival


# --------------------------------------------------------- precision
_CLASSES = [PrecisionClass.exact(), PrecisionClass.budget(3),
            PrecisionClass.bounded()]


def _class_requests(prompts):
    return [Request(uid=i, prompt=p, max_new_tokens=4, precision=c)
            for i, (p, c) in enumerate(zip(prompts, _CLASSES))]


def test_mixed_class_gateway_matches_batcher(prog_model):
    cfg, params = prog_model
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (5, 7, 6)]
    breqs = _class_requests(prompts)
    eng = ContinuousBatcher(cfg, params, n_slots=3, max_len=32,
                            progressive=True, early_exit=True, device="cpu")
    for r in breqs:
        eng.submit(r)
    eng.run(max_steps=200)
    greqs = _class_requests(prompts)
    gw = _gateway(cfg, params, n_slots=3, max_len=32, progressive=True,
                  early_exit=True)
    gw.run(greqs)
    gw.close()
    for b, g in zip(breqs, greqs):
        assert b.output == g.output and b.exit_levels == g.exit_levels
        assert b.prefill_exit_level == g.prefill_exit_level
    bst, gst = eng.stats(), gw.stats(latency=False)
    assert bst["exit_level_hist_by_class"] == gst["exit_level_hist_by_class"]
    assert bst["prefill_exit_level_hist_by_class"] == \
        gst["prefill_exit_level_hist_by_class"]


def test_progressive_stats_schema_shared_and_normalized(prog_model):
    from repro_torch.serve.batching import progressive_stats

    cfg, params = prog_model
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=32,
                            progressive=True, early_exit=True, device="cpu")
    gw = _gateway(cfg, params, n_slots=2, max_len=32, progressive=True,
                  early_exit=True, aot_warmup=False)
    bst, gst = eng.stats(), gw.stats(latency=False)
    gw.close()
    shared = set(progressive_stats(1, np.zeros(1), np.zeros(1), {}, {}))
    assert shared <= set(bst) and shared <= set(gst)
    for st in (bst, gst):
        assert isinstance(st["exit_level_hist"], list)
        for key, hist in st["exit_level_hist_by_class"].items():
            assert isinstance(key, str) and isinstance(hist, list)
        assert list(st["exit_level_hist_by_class"]) == ["bounded(0)"]


def test_gateway_refuses_params_on_another_device(model):
    cfg, params = model
    with pytest.raises(ValueError, match="on cpu"):
        ServingGateway(cfg, params, n_slots=1, max_len=16, device="meta")
