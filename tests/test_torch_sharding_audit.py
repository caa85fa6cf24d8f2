"""The collective-schedule audit (analysis/sharding.py) and the
sync-cost certificate (analysis/collective_cost.py).

* positive — the registered split entries verify on a 2 x 2 mesh of four
  gloo CPU ranks: the CLI (``python -m repro_torch.analysis.lint
  --device cpu --sharding --allow-skips``) runs once for the module, in
  this process, and its one spawn runs every split entry;
* negative — the faults of the reference's tests/test_sharding_audit.py
  :158-303, on hand-made record lists and tiny torch functions (the
  collectives' process-group calls stubbed, so no spawn): an undeclared
  all-gather, a float SUM on a dequantized value (an int SUM on the
  quantized one passes), an untagged reduce, a budget overrun, a count
  mismatch; a skipped entry fails without ``allow_skips``;
* the port's declared schedule against the reference's (they differ,
  and the test says how) and against
  ``core/progressive.py:sharded_walk_collectives``;
* ``sync_cost_certificate``'s counts and wire bytes equal the
  reference's on the same records, over axes of size 1 and 2.

Every comparison is exact.  One intra-op thread.
"""

import json

import pytest
import torch

from repro_torch.analysis import lint, registry
from repro_torch.analysis.collective_cost import (CollectiveRecord,
                                                  ring_wire_bytes,
                                                  sync_cost_certificate)
from repro_torch.analysis.exactness import ExactnessContract
from repro_torch.analysis.registry import ExactEntry, consensus_contract
from repro_torch.analysis.sharding import (ReductionSpec, ShardingContract,
                                           audit_records,
                                           audit_sharded_registry,
                                           audit_sharding)
from repro_torch.core.progressive import sharded_walk_collectives
from repro_torch.sharding import collectives
from repro_torch.sharding.collectives import (TAG_MAX, TAG_MIN,
                                              TAG_SUM_INT, Record)

SPLIT = ["head/sharded-consensus", "head/sharded-consensus-while",
         "cache/sharded-weights", "serve/sharded-decode-backbone"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The lint CLI on the CPU with the sharding pass: one spawn of four
    gloo ranks for every split entry."""
    path = tmp_path_factory.mktemp("lint") / "report.json"
    rc = lint.main(["--device", "cpu", "--sharding", "--allow-skips",
                    "--json", str(path)])
    return rc, json.loads(path.read_text())


# ------------------------------------------------ positive: the registry
def test_cli_writes_its_json(cli):
    rc, report = cli
    assert rc == 0
    assert report["n_violations"] == 0
    assert set(report) == {"exactness", "overflow", "compiled", "sharding",
                           "n_violations"}
    skipped = sorted(r["entry"] for r in report["exactness"]
                     if r["status"] == "skip")
    assert skipped == ["gemm/stacked/cuda", "gemm/streaming/cuda"]


@pytest.mark.parametrize("name", SPLIT)
def test_registered_split_entries_verify(cli, name):
    rows = {r["entry"]: r for r in cli[1]["sharding"]}
    assert sorted(rows) == sorted(SPLIT)
    r = rows[name]
    assert r["status"] == "ok", r["violations"]
    walk = sharded_walk_collectives(r["schedule"]["levels_run"],
                                    name != "cache/sharded-weights",
                                    name != "cache/sharded-weights",
                                    name.endswith("-while"))
    census = {k: v for k, v in walk.items() if v}
    assert r["collectives"]["census"] == census
    if name == "cache/sharded-weights":
        assert r["collectives"]["records"] == 0
        return
    levels = r["schedule"]["levels_run"]
    assert levels == 7 if not name.endswith("-while") else 1 <= levels <= 7
    per_level = sorted((x["reduce_op"], x["tag"], x["group"])
                       for x in r["schedule"]["per_level"])
    want = [("max", TAG_MAX, "model")] * 2 + [("min", TAG_MIN, "model")]
    if name.endswith("-while"):
        want.append(("sum", collectives.TAG_CONSENSUS, "data"))
    assert per_level == sorted(want)
    # the decisions reduce dequantized floats by max and min only
    assert {x["taint"] for x in r["schedule"]["per_level"]} <= {"deq", None}
    cert = r["cost"]
    assert cert["collectives_per_walk"] == sum(walk.values()) \
        - (levels - 7) * len(want)
    assert [e["k"] for e in cert["sync_every_k"]] == [1, 2, 4, 8]


def test_split_entries_audit_exact_on_the_mesh(cli):
    rows = {r["entry"]: r for r in cli[1]["exactness"]}
    for name in ("head/sharded-consensus", "head/sharded-consensus-while"):
        assert rows[name]["status"] == "ok", rows[name]
        assert rows[name]["f32_fastpath_dots"] > 0


@pytest.mark.parametrize("early_exit", [False, True])
def test_declared_schedule_is_the_ports_not_the_references(early_exit):
    """The reference declares 4 pmax + 1 pmin a level and no gathers; the
    port's walk makes 2 MAX + 1 MIN a level (rows stacked into one call)
    and gathers its results, as ``sharded_walk_collectives`` counts."""
    from repro.analysis.registry import _consensus_contract

    ref = _consensus_contract(2, 2, early_exit)
    port = consensus_contract(2, 2, early_exit)
    assert [(s.prim, s.count, s.tag) for s in ref.per_level][:2] == \
        [("pmax", 4, TAG_MAX), ("pmin", 1, TAG_MIN)]
    assert [(s.prim, s.count, s.tag) for s in port.per_level][:2] == \
        [("pmax", 2, TAG_MAX), ("pmin", 1, TAG_MIN)]
    assert not any(s.prim == "all_gather" for s in ref.per_walk)
    for lv in range(1, 8):
        want = sharded_walk_collectives(lv, True, True, early_exit)
        reduces = sum(s.count for s in port.per_level) * lv + sum(
            s.count for s in port.per_walk if s.prim != "all_gather")
        gathers = sum(s.count for s in port.per_walk
                      if s.prim == "all_gather")
        assert (reduces, gathers) == (want["all_reduce"], want["all_gather"])


# ---------------------------------------- negative: hand-made records
def _rec(reduce_op="max", tag=TAG_MAX, op="all_reduce", dtype="float32",
         in_loop=False, walk=None, taint=None, group="model") -> Record:
    return Record(op=op, reduce_op=reduce_op if op == "all_reduce" else None,
                  dtype=dtype, nbytes=16, group=group, group_size=2,
                  in_loop=in_loop, walk=walk, tag=tag, taint=taint)


def _contract(**kw) -> ShardingContract:
    kw.setdefault("mesh_axes", (("data", 2), ("model", 2)))
    kw.setdefault("per_level", (ReductionSpec("pmax", 2, TAG_MAX),
                                ReductionSpec("pmin", 1, TAG_MIN)))
    kw.setdefault("n_levels", 2)
    return ShardingContract(**kw)


def _levels(n=2, walk=0):
    return [_rec(in_loop=True, walk=walk), _rec(in_loop=True, walk=walk),
            _rec("min", TAG_MIN, in_loop=True, walk=walk)] * n


def test_declared_schedule_passes():
    rep = audit_records(_levels(), _contract())
    assert rep.ok, [v.reason for v in rep.violations]
    assert rep.schedule["levels_run"] == 2


def test_extra_all_gather_fails():
    recs = _levels() + [_rec(None, "", op="all_gather", dtype="int8")]
    rep = audit_records(recs, _contract())
    assert any(v.primitive == "all_gather" and "does not declare" in v.reason
               for v in rep.violations)


def test_untagged_reduce_fails():
    recs = _levels()
    recs[1] = _rec(tag="", in_loop=True, walk=0)
    rep = audit_records(recs, _contract())
    assert any("without a declared l2r_coll tag" in v.reason
               for v in rep.violations)


def test_budget_overrun_fails():
    recs = [_rec() for _ in range(3)]
    contract = _contract(per_level=(), per_walk=(ReductionSpec(
        "pmax", 3, TAG_MAX),), max_collectives=2)
    rep = audit_records(recs, contract)
    assert [v.reason for v in rep.violations if "budget" in v.reason]


def test_count_mismatch_fails():
    """Declaring 2 pmax a walk but recording 1 (or a level short of the
    stream) is a mismatch: the contract pins the schedule exactly."""
    contract = _contract(per_level=(), per_walk=(ReductionSpec(
        "pmax", 2, TAG_MAX),))
    rep = audit_records([_rec()], contract)
    assert any("recorded 1 x pmax" in v.reason for v in rep.violations)
    rep = audit_records(_levels(1), _contract())  # 1 of 2 levels
    assert any("per-level schedule mismatch" in v.reason
               for v in rep.violations)


def test_kinds_contract_counts_a_whole_run():
    recs = [_rec(), _rec(None, "", op="all_gather")]
    ok = ShardingContract(mesh_axes=(("model", 2),),
                          kinds=(("all_reduce", 1), ("all_gather", 1)))
    assert audit_records(recs, ok).ok
    bad = ShardingContract(mesh_axes=(("model", 2),),
                           kinds=(("all_reduce", 2),))
    reasons = [v.reason for v in audit_records(recs, bad).violations]
    assert any("recorded 1 x all_reduce, declared 2" in r for r in reasons)
    assert any("all_gather" in r for r in reasons)


def test_float_sum_rules():
    floaty = [_rec("sum", TAG_SUM_INT, dtype="float32")]
    contract = _contract(per_level=(), per_walk=(ReductionSpec(
        "psum", 1, TAG_SUM_INT),))
    assert not audit_records(floaty, contract).ok
    relaxed = _contract(per_level=(), per_walk=contract.per_walk,
                        allow_float_psum=True)
    assert audit_records(floaty, relaxed).ok
    tainted = [_rec("sum", TAG_SUM_INT, dtype="float32", taint="deq")]
    assert not audit_records(tainted, relaxed).ok  # taint wins


# ------------------------------------------ negative: tiny torch functions
@pytest.fixture
def fake_group(monkeypatch):
    """A two-rank group whose collectives return their input (the
    recorder and the audit see the calls; no process group runs)."""
    dist = collectives.dist
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "all_reduce", lambda y, op=None, group=None:
                        None)
    monkeypatch.setattr(dist, "all_gather", lambda parts, y, group=None:
                        [p.copy_(y) for p in parts])
    group = object()
    collectives.name_groups({("model",): group})
    return group


def _ints():
    g = torch.Generator().manual_seed(0)
    aq = torch.randint(-128, 128, (2, 4), generator=g, dtype=torch.int8)
    bq = torch.randint(-128, 128, (4, 3), generator=g, dtype=torch.int8)
    return aq, bq


def test_float_psum_on_dequantized_value_flagged(fake_group):
    """An int8 product dequantized to f32 and then summed across ranks:
    the sum reassociates a float, so the ``deq`` taint flags it."""
    def body(aq, bq):
        acc = aq.to(torch.int64) @ bq.to(torch.int64)
        deq = acc.to(torch.float32) * 0.5
        return collectives.all_reduce(deq, "sum", fake_group)

    contract = ShardingContract(mesh_axes=(("model", 2),),
                                per_walk=(ReductionSpec("psum", 1),),
                                allow_float_psum=True)
    rep = audit_sharding(body, _ints(), contract, entry="neg/float-psum",
                         with_cost=False)
    assert not rep.ok
    assert any("plane-derived" in v.reason and v.primitive == "psum"
               for v in rep.violations), [v.reason for v in rep.violations]


def test_int_psum_on_quantized_value_passes(fake_group):
    """The allowed shape: the cross-rank sum on the integer accumulator
    (collectives.sum_int), dequantized only after."""
    def body(aq, bq):
        acc = (aq.to(torch.int64) @ bq.to(torch.int64)).to(torch.int32)
        return collectives.sum_int(acc, fake_group).to(torch.float32)

    contract = ShardingContract(mesh_axes=(("model", 2),),
                                per_walk=(ReductionSpec("psum", 1,
                                                        TAG_SUM_INT),))
    rep = audit_sharding(body, _ints(), contract, ExactnessContract(k=4),
                         entry="pos/int-psum")
    assert rep.ok, [v.reason for v in rep.violations]
    assert rep.schedule["per_walk"][0]["taint"] == "int"
    assert rep.cost["per_walk"]["count"] == 1


def test_all_gather_in_a_walk_is_flagged(fake_group):
    def body(x):
        return collectives.all_gather(x, fake_group, 0)

    contract = ShardingContract(mesh_axes=(("model", 2),))
    rep = audit_sharding(body, (torch.ones((2, 4), dtype=torch.int8),),
                         contract, entry="neg/all-gather", with_cost=False)
    assert any(v.primitive == "all_gather" for v in rep.violations)


# ------------------------------------------------ skips must fail loudly
def test_skipped_registry_entry_fails_loudly():
    fake = ExactEntry(
        name="fake/sharded", build=lambda **kw: (None, ()),
        tags=("sharded",), skip="needs a 2 x 2 mesh",
        sharding=ShardingContract(mesh_axes=(("data", 2), ("model", 2))))
    rows = audit_sharded_registry([fake])
    assert rows[0]["status"] == "violation"
    assert "SKIPPED" in rows[0]["violations"][0]["reason"]
    rows = audit_sharded_registry([fake], allow_skips=True)
    assert rows[0] == {"entry": "fake/sharded", "tags": ["sharded"],
                       "status": "skip", "reason": "needs a 2 x 2 mesh"}
    # the registry's own split entries skip without a mesh
    assert all(e.skip for e in registry.iter_entries(("sharded",)))


# ------------------------------------------------------ sync-cost pricing
def _both(prim, in_loop, axes=("model",), shape=(4,), dtype="float32"):
    from repro.analysis.collective_cost import \
        CollectiveRecord as RefRecord

    kw = dict(prim=prim, axes=axes, dtype=dtype, shape=shape,
              in_loop=in_loop, tag="l2r_coll_max")
    return CollectiveRecord(**kw), RefRecord(**kw)


_PRICED = ("count", "wire_bytes", "by_reduction")


@pytest.mark.parametrize("mesh_axes", [(("data", 1), ("model", 2)),
                                       (("data", 2), ("model", 1)),
                                       (("data", 2), ("model", 2))])
@pytest.mark.parametrize("n_levels", [3, 7])
def test_sync_cost_counts_and_wire_bytes_equal_the_reference(mesh_axes,
                                                             n_levels):
    from repro.analysis.collective_cost import \
        sync_cost_certificate as ref_cert

    pairs = [_both("pmax", True), _both("pmax", True),
             _both("pmin", True, dtype="int32"),
             _both("psum", True, axes=("data",), shape=()),
             _both("pmax", False, shape=(4, 3))]
    got = sync_cost_certificate([p for p, _ in pairs], mesh_axes, n_levels)
    want = ref_cert([r for _, r in pairs], mesh_axes, n_levels)
    for scope in ("per_level", "per_walk"):
        assert {k: got[scope][k] for k in _PRICED} == \
            {k: want[scope][k] for k in _PRICED}
    for key in ("mesh", "chips", "n_levels", "collectives_per_walk",
                "wire_bytes_per_walk"):
        assert got[key] == want[key]
    strip = ("collective_s", "savings_frac")  # priced: NVLink, not ICI
    assert [{k: v for k, v in e.items() if k not in strip}
            for e in got["sync_every_k"]] == \
        [{k: v for k, v in e.items() if k not in strip}
         for e in want["sync_every_k"]]


def test_sync_cost_certificate_pricing():
    recs = [_both("pmax", True)[0], _both("pmax", True)[0],
            _both("pmin", True)[0], _both("pmax", False)[0]]
    cert = sync_cost_certificate(recs, (("data", 2), ("model", 4)), 7)
    assert cert["collectives_per_walk"] == 7 * 3 + 1
    per_red = 2 * 3 / 4 * 16
    assert cert["wire_bytes_per_walk"] == 7 * 3 * per_red + per_red
    assert cert["collective_s"] == cert["wire_bytes_per_walk"] / 450e9
    ks = {e["k"]: e for e in cert["sync_every_k"]}
    assert [ks[k]["sync_levels"] for k in (1, 2, 4, 8)] == [7, 4, 2, 1]
    assert ks[8]["collectives"] == 3 + 1
    assert ring_wire_bytes("all-reduce", 16.0, 1) == 0.0
