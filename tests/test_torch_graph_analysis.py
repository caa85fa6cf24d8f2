"""The captured-graph cost analysis (``repro_torch.launch.graph_analysis``,
the port of ``repro.launch.hlo_analysis``) against the reference's HLO
analysis of the same functions, and its consumers.

* FLOPs: one matmul exactly; a 7-step scan and 3 x 5 nested scans, as
  ``higher_order.scan`` and as Python loops, equal to the reference's
  trip-count-weighted FLOPs of ``lax.scan`` (rel 1e-2, the reference
  tests' own tolerance); the smoke SmolLM forward (``l2r=None``) within
  1 % of the reference's ``analyze`` of its compiled HLO.
* Bytes: they scale with the result (> 3x from 256^2 to 512^2); a kernel
  node is one node, charged at its surface; a cache write by its update
  region.
* Collectives: none on one device; the smoke split prefill's graph nodes
  equal the recorder's records one for one and ``split_collectives``
  (+2 gathers); ``parse_collectives`` equals ``analyze``'s counts.
* The archive round trip, and ``reanalyze`` equal to a fresh analysis.
* The consumers catch seeded violations: ``audit_graph`` a bf16
  contraction, ``audit_partitioned_graph`` an untagged float add
  all-reduce, ``decode_donation`` a batcher with ``donate_state=False``.

Everything runs on the CPU; the kernels' custom ops take their plain
versions there (tests/test_torch_cuda.py holds the card's side).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._higher_order_ops.scan import scan

from repro.configs import get_smoke as j_get_smoke
from repro.launch import hlo_analysis as jh
from repro.models import common as jc
from repro.models import transformer as jt
from repro_torch.analysis.collective_cost import (from_records,
                                                  ring_wire_bytes,
                                                  sync_cost_certificate)
from repro_torch.analysis.compiled import (decode_donation, donation_report,
                                           probe_donation)
from repro_torch.analysis.exactness import ExactnessContract, audit_graph
from repro_torch.analysis.sharding import (ShardingContract, ReductionSpec,
                                           audit_partitioned_graph)
from repro_torch.configs import get_smoke
from repro_torch.core.quant import (QuantConfig, stack_planes_lhs,
                                    stack_planes_rhs)
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.l2r_gemm import kernel as gemm
from repro_torch.launch import dryrun, reanalyze
from repro_torch.launch import graph_analysis as ga
from repro_torch.launch.mesh import make_shape_mesh
from repro_torch.launch.roofline import parse_collectives
from repro_torch.models import transformer as tt
from repro_torch.models.common import abstract
from repro_torch.sharding import collectives
from repro_torch.sharding.axes import _desc
from test_torch_train import _one_torch_thread  # noqa: F401


def _hlo(f, *args):
    return jax.jit(f).lower(*args).compile().as_text()


def _records(f, *args):
    with torch.no_grad():
        return ga.to_records(ga.capture(f, args).gm)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------ FLOPs
def test_single_matmul_flops_exact():
    m, k, n = 64, 128, 32
    ref = jh.analyze(_hlo(lambda x, y: x @ y,
                          jax.ShapeDtypeStruct((m, k), jnp.float32),
                          jax.ShapeDtypeStruct((k, n), jnp.float32)))
    got = ga.analyze(_records(lambda x, y: x @ y, _meta(m, k), _meta(k, n)))
    assert got["flops"] == ref["flops"] == 2 * m * k * n
    assert got["flops_by_peak"] == {"f32": 2 * m * k * n}


def _ref_scan(m, outer, inner):
    a = jax.ShapeDtypeStruct((m, m), jnp.float32)

    def f(x):
        def body_o(c, _):
            def body_i(c2, _):
                return c2 @ x, None
            if inner:
                c, _ = jax.lax.scan(body_i, c, None, length=inner)
                return c, None
            return c @ x, None
        out, _ = jax.lax.scan(body_o, x, None, length=outer)
        return out

    return jh.analyze(_hlo(f, a))["flops"]


def _scan_port(x, w, outer, inner):
    def body_o(c, xs):
        if not inner:
            c2 = c @ w
            return c2, c2.sum()

        def body_i(c2, ys):
            c3 = c2 @ w
            return c3, c3.sum()

        c, _ = scan(body_i, c, torch.zeros(inner, 1))
        return c, c.sum()

    return scan(body_o, x, torch.zeros(outer, 1))[0]


def _loop_port(x, w, outer, inner):
    c = x
    for _ in range(outer):
        for _ in range(inner or 1):
            c = c @ w
    return c


@pytest.mark.parametrize("form", ["scan", "python_loop"])
@pytest.mark.parametrize("m,outer,inner", [(32, 7, 0), (16, 5, 3)])
def test_scans_weighted_by_trip_count_as_the_reference(form, m, outer,
                                                       inner):
    fn = _scan_port if form == "scan" else _loop_port
    recs = _records(lambda x, w: fn(x, w, outer, inner), torch.ones(m, m),
                    torch.ones(m, m))
    if form == "scan":
        loops = [r for r in recs if r["kind"] == "loop"]
        assert len(loops) == 1 and loops[0]["trip"] == outer
    got = ga.analyze(recs)["flops"]
    assert got == pytest.approx(_ref_scan(m, outer, inner), rel=1e-2)
    assert got == outer * (inner or 1) * 2 * m ** 3


def test_while_loop_of_unknown_count_is_refused():
    recs = [{"name": "while_loop", "op": "call_function",
             "target": "higher_order.while_loop", "kind": "loop",
             "args": [], "kwargs": {}, "out": [], "loop": "while_loop",
             "trip": None, "body": []}]
    with pytest.raises(ga.UnknownTripCount, match="trip count"):
        ga.analyze(recs)
    part = dryrun.graph_roofline(recs, 1, "bf16", 1.0)
    assert part["roofline"] is None and "trip count" in part["unavailable"]


@pytest.fixture(scope="module")
def smoke_forward_flops():
    """The smoke SmolLM forward (l2r=None, 2 x 16 tokens): the reference's
    analyze of its compiled HLO, and the port's of its graph captured on
    meta with the CPU's paths (the reference's chunk loop) and with the
    card's (kernel B5)."""
    from repro_torch.device import meta_target

    jcfg, cfg = j_get_smoke("smollm-135m"), get_smoke("smollm-135m")
    jp = jc.materialize(jt.lm_build(jcfg), jax.random.PRNGKey(0))
    tok = jnp.zeros((2, 16), jnp.int32)
    ref = jh.analyze(_hlo(lambda p, t: jt.lm_forward(jcfg, p, tokens=t)[0],
                          jp, tok))
    params = abstract(_desc(cfg, None))

    def fwd(p, t):
        return tt.lm_forward(cfg, p, tokens=t)[0]

    with meta_target("cpu"):
        loop = _records(fwd, params, _meta(2, 16, dtype=torch.int32))
    card = _records(fwd, params, _meta(2, 16, dtype=torch.int32))
    return ref, loop, card


def _flops_of(recs, targets):
    by = {r["name"]: r for r in recs}
    return sum(ga._product_flops(r, by)[0] for r in recs
               if r["kind"] == "product"
               and r["target"].split(".")[-1] in targets)


def test_smoke_forward_flops_are_the_reference_hlo(smoke_forward_flops):
    ref, loop, card = smoke_forward_flops
    got = ga.analyze(loop)
    # the reference's chunk loop, as the CPU takes it: the same products
    assert got["flops"] == pytest.approx(ref["flops"], rel=1e-2)
    assert got["collective_counts"] == {k: 0 for k in ref[
        "collective_counts"]}
    # on the card's path attention is kernel B5, which counts only the
    # visible (causal) pairs where the loop multiplies whole chunks: the
    # dense products (mm, addmm) are the same, the loop's attention
    # products (bmm) are B5 nodes
    assert ga.kernel_nodes(card) == {"flash_attention":
                                     get_smoke("smollm-135m").n_layers}
    dense = ("mm", "addmm")
    assert _flops_of(card, dense) == _flops_of(loop, dense) > 0
    assert _flops_of(card, ("bmm",)) == 0 < _flops_of(loop, ("bmm",))


# ------------------------------------------------------------ bytes
def test_bytes_scale_with_result_sizes():
    small = ga.analyze(_records(lambda x, y: x @ y, _meta(256, 256),
                                _meta(256, 256)))
    big = ga.analyze(_records(lambda x, y: x @ y, _meta(512, 512),
                              _meta(512, 512)))
    assert big["bytes"] > 3 * small["bytes"]
    # the inputs read once and the result written once
    assert small["bytes"] == 3 * 256 * 256 * 4


def test_no_collectives_on_single_device():
    got = ga.analyze(_records(lambda x: x * 2 + 1, torch.ones(8, 8)))
    assert got["total_wire_bytes"] == 0
    assert sum(got["collective_counts"].values()) == 0
    # pointwise ops move nothing a fused backend keeps: the input once
    assert got["bytes"] == 8 * 8 * 4


def test_kernel_nodes_are_one_node_at_their_surface():
    g = torch.Generator().manual_seed(0)
    m, k, n, d = 5, 48, 7, 4
    a = torch.randint(-128, 128, (m, k), dtype=torch.int8, generator=g)
    b = torch.randint(-128, 128, (k, n), dtype=torch.int8, generator=g)
    sa, sb = stack_planes_lhs(a, 8, 2), stack_planes_rhs(b, 8, 2)
    cap = ga.capture(gemm.l2r_gemm_stacked_planes, (sa, sb))
    recs = ga.to_records(cap.gm)
    assert ga.kernel_nodes(recs) == {"l2r_stacked_gemm": 1}
    assert not [r for r in recs if r["kind"] == "product"]
    ops, nbytes = gemm.stacked_cost(m, k, n, d)
    got = ga.analyze(recs)
    assert got["flops_by_peak"] == {"int8": ops["int8"]} and \
        got["flops"] == 2 * m * n * k
    assert got["bytes"] == nbytes  # the stacks once, the int32 result once
    # on the CPU the op is the plain version, bit for bit, and replays
    assert torch.equal(cap.output, gemm.l2r_gemm_stacked_planes_plain(sa, sb))
    assert torch.equal(cap(sa, sb), cap.output)
    # B5 and B4 on meta: one node each, their formula's FLOPs
    q, kk = _meta(2, 70, 6, 32), _meta(2, 70, 2, 32)
    for fn, lib, qk_int8 in ((fa.flash_attention_kernel, "flash_attention",
                              False),
                             (fa.flash_attention_l2r, "flash_attention_l2r",
                              True)):
        recs = _records(fn, q, kk, kk)
        assert ga.kernel_nodes(recs) == {lib: 1}
        ops, _ = fa.flash_cost(2, 70, 70, 6, 2, 32, True, None,
                               torch.float32, qk_int8)
        assert ga.analyze(recs)["flops_by_peak"] == ops


def test_cache_write_is_charged_by_its_update_region():
    cache = _meta(4, 1024, 64)
    upd = _meta(4, 1, 64)

    def write(c, u):
        c[:, 100:101].copy_(u)
        return c

    def scatter(c, u):
        c.index_put_((torch.arange(4, device="meta"),
                      torch.full((4,), 100, device="meta")), u[:, 0])
        return c

    for fn in (write, scatter):
        got = ga.analyze(_records(fn, cache, upd))
        assert got["weight_bytes"] == (4 * 1024 * 64 + 4 * 64) * 4
        assert got["bytes"] - got["weight_bytes"] == 2 * 4 * 64 * 4
        assert ga.written_inputs(_records(fn, cache, upd)) == [0]


# ------------------------------------------------------------ collectives
@pytest.fixture(scope="module")
def split_prefill():
    """The smoke SmolLM's prefill on rank 3 of a 2 x 2 mesh of shapes only,
    captured with the recorder on."""
    from repro_torch.serve.engine import prepare_params
    from repro_torch.sharding.axes import shard_params

    cfg = dataclasses.replace(get_smoke("smollm-135m"), l2r=QuantConfig())
    mesh = make_shape_mesh({"data": 2, "model": 2}, 3)
    params = shard_params(cfg, prepare_params(
        cfg, abstract(_desc(cfg, None)), mesh=mesh), mesh)
    batch = {"tokens": _meta(4, 8, dtype=torch.int32)}
    res = dryrun.meta_step(cfg, mesh, "prefill", params, batch, 12,
                           measure=False, graph=True)
    return cfg, params, res, ga.to_records(res["graph"].gm)


def test_split_prefill_graph_collectives_are_the_recorders(split_prefill):
    from repro_torch.serve.engine import split_collectives

    cfg, params, res, recs = split_prefill
    crecs = ga.collective_records(recs)
    assert [ga.recorded(c) for c in crecs] == \
        [r.to_json() for r in res["records"]]
    want = dict(split_collectives(cfg, params, "prefill"))
    want["all_gather"] += 2  # the head's vocabulary and the rows' gathers
    got = {k: 0 for k in want}
    for c in crecs:
        got[c["op"]] += 1
    assert got == want
    for c in crecs:
        assert c["n_groups"] * c["group_size"] == 4
        assert c["wire_bytes"] > 0 and c["result_bytes"] > 0
    kinds = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "all_to_all": "all-to-all"}
    ring = sum(ring_wire_bytes(
        kinds[r.op], r.nbytes * (r.group_size if r.op == "all_gather" else 1),
        r.group_size) for r in res["records"])
    ana = ga.analyze(recs)
    parsed = parse_collectives(recs)
    assert parsed["counts"] == ana["collective_counts"]
    assert parsed["total_wire_bytes"] == pytest.approx(
        ana["total_wire_bytes"])
    assert {kinds[k]: v for k, v in got.items() if v} == {
        k: v for k, v in parsed["counts"].items() if v}
    assert parsed["total_wire_bytes"] == pytest.approx(ring)
    # the schedule split_collectives derives, audited on the graph
    contract = ShardingContract(mesh_axes=(("data", 2), ("model", 2)),
                                kinds=tuple(sorted(want.items())))
    violations, _ = audit_partitioned_graph(recs, contract, "split")
    assert violations == []
    # the certificate's roofline from the graph, at the schedule's wire
    cert = sync_cost_certificate(from_records(res["records"]),
                                 contract.mesh_axes, 1, graph=recs)
    rl = cert["roofline"]
    assert rl["wire_bytes"] == cert["wire_bytes_per_walk"] > 0
    assert rl["flops"] == ana["flops"] and rl["bytes_hbm"] == ana["bytes"]
    assert 0 < cert["collective_share"] < 1


def test_archive_round_trip_and_reanalyze(tmp_path, capsys):
    dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    jpath = tmp_path / "smollm-135m_decode_32k_1pod.json"
    rec = json.loads(jpath.read_text())
    gpath = tmp_path / rec["graph_archive"]
    recs = ga.load_graph(str(gpath))
    assert ga.node_count(recs) == rec["graph_nodes"] > 0
    assert rec["graph_bytes"] == gpath.stat().st_size
    fresh = dryrun.graph_roofline(recs, rec["chips"], "bf16",
                                  rec["model_flops_per_chip"])
    assert fresh["roofline"] == rec["roofline"]
    # reanalyze rewrites the artifact from the archive alone
    stale = dict(rec, roofline=None, collectives=None,
                 useful_compute_ratio=None)
    jpath.write_text(json.dumps(stale))
    reanalyze.main(["--dir", str(tmp_path)])
    out = json.loads(jpath.read_text())
    for k in ("roofline", "collectives", "useful_compute_ratio"):
        assert out[k] == rec[k], k
    assert "[ok]" in capsys.readouterr().out
    # and the round trip of records is exact
    ga.save_graph(str(tmp_path / "x.graph.json.xz"), recs)
    assert ga.load_graph(str(tmp_path / "x.graph.json.xz")) == recs


# ------------------------------------------------------------ consumers
def test_audit_graph_catches_a_bf16_contraction():
    f32 = _records(lambda a, b: a @ b, _meta(4, 24), _meta(24, 16))
    bf16 = _records(lambda a, b: a.bfloat16() @ b.bfloat16(), _meta(4, 24),
                    _meta(24, 16))
    ints = _records(lambda a, b: torch._int_mm(a, b),
                    _meta(32, 32, dtype=torch.int8),
                    _meta(32, 32, dtype=torch.int8))
    ok = ExactnessContract(k=24)
    assert ok.f32_ok
    assert audit_graph(f32, ok, "f32") == []
    assert audit_graph(ints, ok, "int") == []
    v = audit_graph(bf16, ok, "bf16")
    assert len(v) == 1 and "bfloat16 contraction" in v[0].reason
    no_guard = ExactnessContract(k=24, allow_f32=False)
    v = audit_graph(f32, no_guard, "guard")
    assert len(v) == 1 and "guard does not hold" in v[0].reason


def test_audit_partitioned_graph_catches_an_untagged_float_sum():
    mesh = make_shape_mesh({"data": 2, "model": 2}, 0)
    group = mesh.group(("model",))

    def seeded(x):
        with collectives.tag(collectives.TAG_MAX):
            y = collectives.all_reduce(x, "max", group)
        z = collectives.all_reduce(x, "max", group)  # untagged
        return y + z + collectives.all_reduce(x, "sum", group)  # float add

    recs = _records(seeded, _meta(4, 8))
    contract = ShardingContract(
        mesh_axes=(("data", 2), ("model", 2)),
        per_walk=(ReductionSpec("pmax", 1, collectives.TAG_MAX),))
    violations, crecs = audit_partitioned_graph(recs, contract, "seeded")
    assert len(crecs) == 3
    reasons = [v.reason for v in violations]
    assert any("float add all-reduce" in r for r in reasons)
    assert any("without a declared l2r_coll tag" in r for r in reasons)
    assert any("budget exceeded" in r for r in reasons)
    assert crecs[0]["op_name"] == collectives.TAG_MAX and \
        crecs[0]["reduce_op"] == "maximum"
    assert crecs[2]["reduce_op"] == "add" and crecs[2]["dtype"] == "float32"


@pytest.mark.parametrize("donate", [True, False])
def test_decode_donation_catches_a_copied_state(donate):
    from repro_torch.models.common import materialize
    from repro_torch.serve import ContinuousBatcher
    from repro_torch.serve.batching import Request
    from repro_torch.serve.engine import prepare_params
    from repro_torch.models.transformer import lm_build

    cfg = dataclasses.replace(get_smoke("smollm-135m"), l2r=QuantConfig())
    params = prepare_params(cfg, materialize(
        lm_build(cfg), torch.Generator().manual_seed(1), device="cpu"))
    b = ContinuousBatcher(cfg, params, n_slots=2, max_len=32, device="cpu",
                          donate_state=donate)
    b.submit(Request(0, np.array([1, 2, 3, 4]), 4))
    b.step()
    rep = decode_donation(b)
    assert rep["n_state_leaves"] > 0
    if donate:
        assert rep["ok"] and rep["n_in_place"] == rep["n_state_leaves"]
    else:
        assert not rep["ok"] and rep["n_in_place"] == 0
        assert "NOT donated" in rep["violations"][0]["reason"]


def test_donation_report_reads_the_alias_map():
    def step(state, x):
        state["k"][:, :1].copy_(x)
        return state, x * 2

    recs = _records(step, {"k": _meta(2, 4), "v": _meta(2, 4)},
                    _meta(2, 1))
    rep = donation_report(recs)
    assert rep["mutated_params"] == [0]
    assert rep["aliased_params"] == [0, 1] and rep["n_aliases"] == 2
    # the dynamic probe: the state comes back on its own storage, a
    # cloned one does not
    state = {"k": torch.zeros(2, 4), "v": torch.zeros(2, 4)}
    x = torch.ones(2, 1)
    assert probe_donation(step, (state, x), (0,)) == {0: True}
    assert probe_donation(lambda s, y: step(
        {k: v.clone() for k, v in s.items()}, y), (state, x), (0,)) == \
        {0: False}
