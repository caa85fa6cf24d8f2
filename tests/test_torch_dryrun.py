"""The dry run (``repro_torch.launch.dryrun``) against the reference's
layout arithmetic, and its meta run at smoke width.

* The bytes a rank holds: ``param_specs`` and ``state_specs`` arithmetic
  of both packages on stand-in meshes (16x16, 2x16x16, 2x2) for all ten
  configs and both ``kv_shard`` values; the port's own layouts
  (``held_layouts`` for params, ``engine.local_state`` for the state)
  differ from it only on the leaves a mixer declares ``held``.
* One cell a family through the meta run on a 2 x 2 mesh of shapes
  only: the artifact's keys (the reference's where they keep a meaning),
  the collectives it recorded against ``split_collectives``, and the
  parts it cannot reach given as null with their reason.
* The CLI: one full-width cell, ``--kv-seq-shard`` and ``--moe-hints``.

The meta run's collective records against a rank's real records are in
tests/test_torch_tp_mixers.py (its one spawn).
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as j_get_config
from repro.models.encdec import encdec_build as j_encdec_build
from repro.models.transformer import lm_build as j_lm_build
from repro.serve import engine as je
from repro.sharding import axes as jaxes
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke
from repro_torch.configs.registry import ShapeSpec
from repro_torch.core.quant import QuantConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_shape_mesh
from repro_torch.sharding.axes import _desc, _paths
from test_torch_train import _one_torch_thread  # noqa: F401

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}
REF_KEYS = ("arch", "shape", "kind", "multi_pod", "chips", "params",
            "n_tokens", "l2r", "opts", "memory_analysis", "collectives",
            "roofline", "model_flops_per_chip", "useful_compute_ratio",
            "cost_analysis_raw")
#: the reference's compile_s and hlo_bytes are capture_s and graph_nodes
NO_MEANING = ("compile_s", "hlo_bytes", "lower_s")


class _FakeMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _axis(mesh, e) -> int:
    if e is None:
        return 1
    return math.prod(mesh.shape[a] for a in ((e,) if isinstance(e, str)
                                             else e))


def _ref_bytes(mesh, shapes_dtypes: list, specs: list) -> int:
    """The reference's arithmetic: each leaf's numel over its spec's axes,
    times its dtype's size."""
    out = 0
    for (shape, itemsize), spec in zip(shapes_dtypes, specs):
        n = math.prod(shape)
        for e in spec:
            n //= _axis(mesh, e)
        out += n * itemsize
    return out


def _ref_params(arch: str, mesh) -> int:
    cfg = j_get_config(arch)
    desc = j_encdec_build(cfg) if cfg.family == "encdec" else j_lm_build(cfg)
    leaves = jax.tree.leaves(desc, is_leaf=lambda x: hasattr(x, "axes"))
    specs = jax.tree.leaves(jaxes.param_specs(desc, mesh),
                            is_leaf=lambda x: isinstance(x, JP))
    # bf16 params, as the reference's dry run abstracts them
    sizes = [2 if jnp.dtype(p.dtype) == jnp.float32
             else jnp.dtype(p.dtype).itemsize for p in leaves]
    return _ref_bytes(mesh, [(p.shape, z) for p, z in zip(leaves, sizes)],
                      specs)


def _ref_state(arch: str, mesh, batch: int, seq: int, kv_shard: str) -> int:
    cfg = j_get_config(arch)
    st = jax.tree.leaves(je.abstract_state(cfg, batch, seq))
    specs = jax.tree.leaves(je.state_specs(cfg, mesh, batch, seq, kv_shard),
                            is_leaf=lambda x: isinstance(x, JP))
    return _ref_bytes(mesh, [(s.shape, s.dtype.itemsize) for s in st],
                      specs)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_are_the_reference_spec_arithmetic(arch, mesh_name):
    """Params (bf16, as the reference's dry run) and the serving state of
    the decode cell under param_specs / state_specs equal the reference's
    for both kv_shard values; the port's held layouts differ only on the
    leaves whose Param declares ``held``, and hold what local_state
    gives."""
    shape = MESHES[mesh_name]
    jm, tm = _FakeMesh(shape), make_shape_mesh(shape, 0)
    cfg = get_config(arch)
    desc = _desc(cfg, None)
    sp = SHAPES["decode_32k"]
    declared = {path for path, p in _paths(desc) if p.held is not None}
    for kv_shard in ("heads", "seq"):
        got = dryrun.layout_bytes(cfg, tm, desc, "decode", sp.global_batch,
                                  sp.seq_len, kv_shard, {})
        assert got["params"]["specs"] == _ref_params(arch, jm)
        assert set(got["params"]["held_leaves"]) <= declared
        if not got["params"]["held_leaves"]:
            assert got["params"]["rank"] == got["params"]["specs"] \
                == got["params"]["max"]
        assert got["state"]["rank"] == _ref_state(
            arch, jm, sp.global_batch, sp.seq_len, kv_shard)
        held = got["state"]["held_rank"]
        assert (held is None) == (kv_shard == "seq")


def _smoke_cell(arch: str, kind: str, **over) -> dict:
    cfg = dataclasses.replace(get_smoke(arch), **over)
    sp = ShapeSpec("smoke", 8, 4, kind)
    return dryrun.dry_cell(arch, cfg, sp, make_shape_mesh(
        {"data": 2, "model": 2}, 0), l2r=cfg.l2r is not None)


FAMILY_CELLS = [("smollm-135m", "prefill"), ("smollm-135m", "decode"),
                ("smollm-135m", "train"), ("mamba2-130m", "prefill"),
                ("recurrentgemma-2b", "decode"), ("whisper-base", "prefill"),
                ("qwen2-vl-7b", "decode"), ("granite-8b", "train")]


@pytest.mark.parametrize("arch,kind", FAMILY_CELLS)
def test_meta_run_of_a_smoke_cell_gives_the_artifact(arch, kind):
    rec = _smoke_cell(arch, kind, l2r=QuantConfig())
    for k in REF_KEYS:
        assert k in rec, k
    for k in NO_MEANING:
        assert k not in rec, k
    assert rec["unavailable"] == {}, rec["unavailable"]
    json.dumps(rec)  # the artifact is JSON
    rl = rec["roofline"]
    assert rl["peak"] == "int8" and rl["chips"] == 4
    assert rl["bound_s"] == max(rl["compute_s"], rl["memory_s"],
                                rl["collective_s"]) > 0
    raw = rec["cost_analysis_raw"]
    assert raw["flops"] > 0 and raw["bytes_moved"] > 0
    assert rec["capture_s"] > 0 and rec["graph_nodes"] > 0
    assert rl["flops"] == rec["graph_cost"]["flops"] > 0
    mem = rec["memory_analysis"]
    assert mem["peak_bytes"] == mem["argument_size_in_bytes"] + \
        mem["temp_size_in_bytes"] and mem["temp_size_in_bytes"] > 0
    coll = rec["collectives"]
    assert sum(coll["counts"].values()) > 0
    assert coll["total_wire_bytes"] == sum(coll["wire_bytes"].values()) > 0
    assert 0 < rec["useful_compute_ratio"]


def test_meta_prefill_collectives_are_split_collectives():
    """The meta prefill of the smoke SmolLM on 2 x 2 issues what
    split_collectives derives for its split params, plus the head's
    gather (its vocabulary split) and the rows' gather over "data"."""
    from repro_torch.models.common import abstract
    from repro_torch.serve.engine import prepare_params, split_collectives
    from repro_torch.sharding.axes import shard_params

    cfg = dataclasses.replace(get_smoke("smollm-135m"), l2r=QuantConfig())
    mesh = make_shape_mesh({"data": 2, "model": 2}, 3)
    params = shard_params(cfg, prepare_params(
        cfg, abstract(_desc(cfg, None)), mesh=mesh), mesh)
    batch = {"tokens": torch.empty((4, 8), dtype=torch.int32,
                                   device="meta")}
    res = dryrun.meta_step(cfg, mesh, "prefill", params, batch, 12)
    want = dict(split_collectives(cfg, params, "prefill"))
    want["all_gather"] += 2
    got = {k: 0 for k in want}
    for r in res["records"]:
        got[r.op] += 1
    assert got == want
    assert res["out"][1].shape == (4, 1, cfg.vocab)


def test_what_the_meta_run_cannot_reach_is_null_with_its_reason():
    moe = _smoke_cell("deepseek-moe-16b", "prefill")
    assert moe["roofline"] is None and moe["memory_analysis"] is None
    assert "moe.py" in moe["unavailable"]["meta_run"]
    assert moe["bytes_per_rank"]["params"]["rank"] > 0
    assert moe["model_flops_per_chip"] > 0
    seq = dryrun.dry_cell("smollm-135m", get_smoke("smollm-135m"),
                          ShapeSpec("smoke", 8, 4, "decode"),
                          make_shape_mesh({"data": 2, "model": 2}, 0),
                          kv_shard="seq")
    assert seq["unavailable"]["meta_run"] == dryrun.SEQ_DECODE
    assert seq["bytes_per_rank"]["state"]["rank"] > 0


def test_meter_counts_live_storage_and_moved_bytes():
    x = torch.empty((256, 256), device="meta")
    w = torch.empty((256, 256), device="meta")

    def f(a, b):
        h = a @ b          # 256 KiB made
        g = (h * 2).relu()  # two more while h lives
        del h
        return g.sum()

    res = dryrun.meter(f, (x, w), [x, w])
    assert res["flops"] == 2 * 256 ** 3
    assert res["temp_peak_bytes"] == 3 * 256 * 256 * 4
    # mm reads 2 and writes 1, mul and relu read 1 and write 1, sum reads 1
    assert res["bytes_moved"] == (3 + 2 + 2 + 1) * 256 * 256 * 4 + 4


def test_cli_writes_an_artifact_and_names_what_it_refuses(tmp_path,
                                                          capsys):
    dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "smollm-135m_decode_32k_1pod.json")
                     .read_text())
    assert rec["chips"] == 256 and rec["roofline"]["peak"] == "bf16"
    assert rec["bytes_per_rank"]["state"]["kv_shard"] == "heads"
    dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                 "--out", str(tmp_path), "--kv-seq-shard", "--tag", "_seq",
                 "--multi-pod", "on"])
    rec = json.loads((tmp_path / "smollm-135m_decode_32k_2pod_seq.json")
                     .read_text())
    assert rec["chips"] == 512 and rec["roofline"] is None
    assert "[OK]" in capsys.readouterr().out
    dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k"])
    assert "[SKIP]" in capsys.readouterr().out
    with pytest.raises(ValueError, match="moe-hints"):
        dryrun.main(["--arch", "deepseek-moe-16b", "--shape", "train_4k",
                     "--moe-hints"])
