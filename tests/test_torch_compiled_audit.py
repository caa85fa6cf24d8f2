"""The serving-engine audits (analysis/compiled.py) on the smoke SmolLM.

The port's gateway and batcher, serving a few requests on the CPU,
audit green: every bucket and the decode step warmed, the decode state
written in place, no prefill past the buckets.  The faults the audits
exist for are caught: ``donate_state=False`` (the batcher clones its
state every step) and a prefill at a length that is not a bucket.  The
gateway's buckets equal the reference gateway's for the same
``max_len``.  Every comparison is exact.  One intra-op thread.
"""

import dataclasses

import pytest
import torch

from repro_torch.analysis import compiled as C
from repro_torch.analysis.lint import smoke_model, smoke_requests
from repro_torch.serve import ContinuousBatcher, ServingGateway


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return smoke_model("cpu")


@pytest.fixture(scope="module")
def served_gateway(model):
    cfg, params = model
    gw = ServingGateway(cfg, params, n_slots=2, max_len=32, device="cpu")
    gw.run(smoke_requests(cfg))
    yield gw
    gw.close()


def test_gateway_audit_green(served_gateway):
    rep = C.audit_gateway(served_gateway)
    assert rep["ok"], rep["violations"]
    assert rep["warmed_buckets"] == rep["buckets"] == [8, 16, 32]
    assert rep["warmed_decode"]
    assert rep["prefill_shapes"]  # requests ran


@pytest.mark.parametrize("max_len", [32, 48, 128, 2048])
def test_gateway_buckets_equal_the_reference(model, max_len):
    from repro.configs import get_smoke as ref_get_smoke
    from repro.serve import ServingGateway as RefGateway

    cfg, params = model
    gw = ServingGateway(cfg, params, n_slots=1, max_len=max_len,
                        device="cpu", aot_warmup=False, async_emit=False)
    ref = RefGateway(ref_get_smoke("smollm-135m"), {}, n_slots=1,
                     max_len=max_len, aot_warmup=False, async_emit=False)
    assert gw.buckets == ref.buckets


def test_gateway_warmup_hole_is_caught(model):
    cfg, params = model
    gw = ServingGateway(cfg, params, n_slots=2, max_len=32, device="cpu",
                        async_emit=False)
    del gw.warmup_s[16]
    rep = C.audit_gateway(gw)
    assert not rep["ok"]
    assert "missing=[16]" in rep["violations"][0]["detail"]


def _batcher(model, **kw):
    cfg, params = model
    b = ContinuousBatcher(cfg, params, n_slots=2, max_len=32, device="cpu",
                          **kw)
    for r in smoke_requests(cfg, 2, seed=1):
        b.submit(r)
    b.step()  # prefill + first decode; the audited step is the next
    return b


def test_batcher_audit_green(model):
    rep = C.audit_batcher(_batcher(model))
    assert rep["ok"], rep["violations"]
    assert rep["in_place"] == {"checked": True, "n_leaves": 4, "n_kept": 4}
    assert rep["bucketed"]


def test_batcher_audit_catches_a_copied_state(model):
    """``donate_state=False`` clones the state before each step: every
    state tensor moves to new storage."""
    rep = C.audit_batcher(_batcher(model, donate_state=False))
    assert not rep["ok"]
    assert any("NOT updated in place" in v["reason"]
               for v in rep["violations"])
    assert rep["in_place"]["n_kept"] == 0


def test_batcher_audit_catches_a_prefill_past_the_buckets(model):
    """A prompt routed around the buckets prefills at its own length."""
    cfg, params = model
    b = ContinuousBatcher(cfg, params, n_slots=2, max_len=32, device="cpu")
    first, second = smoke_requests(cfg, 2, seed=2)
    b.submit(first)
    b.step()
    b.bucketed = False  # a route that bypasses the bucket pad
    b.submit(dataclasses.replace(second, prompt=second.prompt[:5]))
    rep = C.audit_batcher(b)  # admits the second request, then decodes
    assert not rep["ok"]
    assert (1, 5) in rep["prefill_shapes"]
    assert "[(1, 5)]" in rep["violations"][0]["reason"]


def test_batcher_audit_needs_a_request_in_flight(model):
    cfg, params = model
    b = ContinuousBatcher(cfg, params, n_slots=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="no request in flight"):
        C.audit_batcher(b)
