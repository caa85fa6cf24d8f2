"""The port's mesh, axis rules and spec functions against the reference's,
in one process (no process group).

The reference's spec functions read only a mesh's ``shape`` and
``axis_names``, so both packages run on stand-ins at the production
shapes (16x16, 2x16x16) and the local ones (1x4, 2x2, 4x2), over the
Param trees of all ten configs.  Also here: ``sharded_walk_axes``'s
routing (tests/test_sharded_serving.py:54), the hint's rank check
(:74), the column slice of a sharded weight cache on a mesh of one
coordinate, and the guards that name what is not ported.  The
multi-rank walk is tests/test_torch_sharded_walk.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as j_get_config
from repro.core.progressive import sharded_walk_axes as j_walk_axes
from repro.models import common as jc
from repro.models.encdec import encdec_build as j_encdec_build
from repro.models.transformer import lm_build as j_lm_build
from repro.serve import engine as je
from repro.sharding import axes as jaxes
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.core.progressive import sharded_walk_axes, streaming_argmax
from repro_torch.core.quant import QuantConfig, quantize, quantize_weights
from repro_torch.launch.mesh import (Mesh, install_local_mesh,
                                     make_local_mesh, make_production_mesh)
from repro_torch.models import common as tc
from repro_torch.models.encdec import encdec_build
from repro_torch.models.transformer import lm_build
from repro_torch.serve import engine as te
from repro_torch.sharding import axes, ctx
from repro_torch.sharding.axes import P
from test_torch_train import _one_torch_thread  # noqa: F401

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x4": {"data": 1, "model": 4}, "2x2": {"data": 2, "model": 2},
          "4x2": {"data": 4, "model": 2}}


@pytest.fixture(autouse=True)
def _no_mesh_left():
    """The installed mesh routes the serving stack: restore none after
    every test of this module."""
    yield
    ctx.set_mesh(None)


class _FakeMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _meshes(name):
    return _FakeMesh(MESHES[name]), Mesh(MESHES[name])


def _leaves(tree) -> list:
    """Spec leaves of a port tree in the reference's flattening order
    (dict keys sorted, None fields dropped)."""
    if tree is None:
        return []
    if isinstance(tree, P):
        return [tuple(tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return [x for t in tree for x in _leaves(t)]


def _j_leaves(tree) -> list:
    import jax

    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _descs(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    if tcfg.family == "encdec":
        return j_encdec_build(jcfg), encdec_build(tcfg)
    return j_lm_build(jcfg), lm_build(tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_match_reference(arch):
    jdesc, tdesc = _descs(arch)
    for name in MESHES:
        jm, tm = _meshes(name)
        for jfn, tfn in ((jaxes.param_specs, axes.param_specs),
                         (jaxes.zero1_specs, axes.zero1_specs)):
            got, ref = _leaves(tfn(tdesc, tm)), _j_leaves(jfn(jdesc, jm))
            assert len(ref) > 5 and got == ref, (arch, name, tfn.__name__)
        rules = axes.logical_rules(tm)
        assert _leaves(tc.partition_specs(tdesc, rules)) == \
            _j_leaves(jc.partition_specs(jdesc, rules)), (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_match_reference(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for name in MESHES:
        jm, tm = _meshes(name)
        assert te._model_axis_for_cache(tcfg, tm) == \
            je._model_axis_for_cache(jcfg, jm)
        for batch in (1, 2, 8, 32, 256):
            assert te._bspec(tm, batch) == je._bspec(jm, batch), (name, batch)
        for kv_shard in ("heads", "seq"):
            if kv_shard == "seq" and tcfg.family == "encdec":
                continue  # the reference's encdec specs ignore it alike
            got = _leaves(te.state_specs(tcfg, tm, 32, 64, kv_shard))
            ref = _j_leaves(je.state_specs(jcfg, jm, 32, 64, kv_shard))
            assert ref and got == ref, (arch, name, kv_shard)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b",
                                  "whisper-base", "qwen2-vl-7b"])
def test_train_step_shardings_match_reference(arch, monkeypatch):
    """The sharded step's (in, out) spec trees: the reference's with its
    NamedSharding wrapper taken off (``named`` patched here)."""
    from types import SimpleNamespace

    from repro.train import step as jstep
    from repro_torch.train.step import train_step_shardings

    monkeypatch.setattr(jstep, "named", lambda mesh, tree: tree)
    jdesc, tdesc = _descs(arch)
    cfg = get_config(arch)
    shapes = {"tokens": (8, 64), "labels": (8, 64)}
    if cfg.family == "encdec":
        shapes["frames"] = (8, 32, cfg.d_model)
    if cfg.rope_mode == "mrope":
        shapes["rope_positions"] = (3, 8, 64)
    batch = {k: SimpleNamespace(shape=v) for k, v in shapes.items()}
    for name in MESHES:
        jm, tm = _meshes(name)
        for ef in (False, True):
            got = train_step_shardings(cfg, tm, tdesc, batch, ef)
            ref = jstep.train_step_shardings(j_get_config(arch), jm, jdesc,
                                             batch, ef)
            assert len(got) == len(ref) == 2
            for g, r in zip(got, ref):
                assert _leaves(g) == _j_leaves(r), (arch, name, ef)


def test_batch_and_safe_specs_match_reference():
    for name in MESHES:
        jm, tm = _meshes(name)
        for b in (1, 3, 16, 64, 512):
            assert tuple(axes.batch_spec(tm, b)) == \
                tuple(jaxes.batch_spec(jm, b)), (name, b)
        for shape, spec in (((50280, 576), ("model", None)),
                            ((64, 2048, 1408), ("model", None, "model")),
                            ((32, 48), (("pod", "data"), "model")),
                            ((7, 16), ("data", "model", None))):
            if "pod" in str(spec) and "pod" not in tm.axis_names:
                continue  # an unknown axis is a KeyError in both
            assert tuple(axes.safe_spec(shape, spec, tm)) == tuple(
                jaxes.safe_spec(shape, JP(*spec), jm)), (name, shape, spec)
        assert axes.dp_axes(tm) == jaxes.dp_axes(jm)


def test_abstract_holds_shapes_on_the_meta_device():
    desc = lm_build(get_config("smollm-135m"))
    jdesc = j_lm_build(j_get_config("smollm-135m"))
    got = tc.tree_leaves(tc.abstract(desc))
    ref = __import__("jax").tree.leaves(jc.abstract(jdesc))
    assert all(t.device.type == "meta" for t in got)
    assert [tuple(t.shape) for t in got] == [tuple(r.shape) for r in ref]


@pytest.mark.parametrize("lead,n,shape,want", [
    ((8,), 16, {"data": 2, "model": 4}, (("data",), "model")),
    ((7,), 16, {"data": 2, "model": 4}, ((), "model")),
    ((8,), 10, {"data": 2, "model": 4}, (("data",), None)),
    ((7,), 10, {"data": 2, "model": 4}, None),
    ((8,), 16, {"data": 1, "model": 1}, None),
    ((2, 8), 16, {"data": 2, "model": 4}, None),
    ((32,), 1024, {"pod": 2, "data": 16, "model": 16},
     (("pod", "data"), "model")),
    ((16,), 1024, {"pod": 2, "data": 16, "model": 16}, ((), "model")),
])
def test_sharded_walk_axes_routes_as_reference(lead, n, shape, want):
    jm, tm = _FakeMesh(shape), Mesh(shape)
    ref = j_walk_axes(lead, n, jm)
    got = sharded_walk_axes(lead, n, tm)
    assert (ref is None) == (want is None) == (got is None)
    if want is not None:
        assert ref[1:] == got[1:] == want and got[0] is tm
    assert sharded_walk_axes((8,), 16, None) is None  # no mesh anywhere


def test_installed_mesh_routes_the_walk():
    tm = Mesh({"data": 2, "model": 4})
    ctx.set_mesh(tm)
    assert sharded_walk_axes((8,), 16) == (tm, ("data",), "model")


def test_mesh_context_restored_after_each_test():
    assert ctx.get_mesh() is None


def test_hint_overlong_spec_raises():
    mesh = install_local_mesh(1, 1)
    assert ctx.get_mesh() is mesh
    x = torch.zeros((4, 8))
    assert ctx.hint(x, "data") is x
    assert ctx.hint(x, "data", None) is x
    with pytest.raises(ValueError, match=r"rank 2"):
        ctx.hint(x, "data", None, "model")
    with pytest.raises(ValueError, match=r"\(4, 8\)"):
        ctx.hint_uneven(x, None, None, "model")
    ctx.set_mesh(None)
    assert ctx.hint(x, "data", None, "model") is x
    with pytest.raises(ValueError, match="rank 2"):
        ctx.constrain(x, Mesh({"data": 1}), "data", None, None)
    assert ctx.safe_axes(Mesh({"data": 2, "model": 4}), (8, 6, 4),
                         ("data", "model", ("pod", "model"))) == \
        ("data", None, ("model",))


def test_mesh_coordinates_are_row_major():
    shape = {"pod": 2, "data": 3, "model": 4}
    for rank in range(24):
        m = Mesh(shape, rank=rank)
        c = m.coords()
        assert rank == (c["pod"] * 3 + c["data"]) * 4 + c["model"]
        assert m.index(("pod", "data")) == c["pod"] * 3 + c["data"]
        assert m.index(("data", "pod")) == m.index(("pod", "data"))
        assert m.index("model") == c["model"]
    prod = make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    multi = make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    with pytest.raises(ValueError, match="shapes only"):
        prod.coords()
    one = make_local_mesh(1, 1)  # no process group needed
    assert one.coords() == {"data": 0, "model": 0}
    with pytest.raises(RuntimeError, match="spawn_local"):
        make_local_mesh(2, 2)


@pytest.mark.parametrize("model", [2, 4])
def test_sharded_cache_holds_its_slice_of_the_whole(model):
    """Each coordinate's cache equals the whole cache's columns bit for
    bit (q, scale, the K-major window-padded stack), and lays its stack
    K-major and contiguous."""
    cfg = QuantConfig()
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (48, 16)).astype(np.float32))
    kw = dict(prestack=True, window_pad=True, plane_shifted=True,
              k_major=True)
    whole = quantize_weights(w, cfg, **kw)
    for rank in range(model):
        mesh = Mesh({"data": 1, "model": model}, rank=rank)
        part = quantize_weights(w, cfg, shard=(None, "model"), mesh=mesh,
                                **kw)
        n_l, off = 16 // model, rank * (16 // model)
        assert part.shard == part.planes.shard
        assert (part.shard.n_total, part.shard.offset,
                part.shard.axis) == (16, off, "model")
        cols = slice(off, off + n_l)
        assert torch.equal(part.q, whole.q[:, cols])
        assert torch.equal(part.scale, whole.scale[:, cols])
        st = part.planes.stack
        assert torch.equal(st, whole.planes.stack[:, cols])
        assert st.stride() == (1, st.shape[0])  # K-major, contiguous
        assert st.untyped_storage().nbytes() == st.numel()
    # an axis that does not divide the columns leaves the cache whole
    mesh = Mesh({"data": 1, "model": 3}, rank=1)
    part = quantize_weights(w, cfg, shard=(None, "model"), mesh=mesh, **kw)
    assert part.shard is None and torch.equal(part.q, whole.q)
    with pytest.raises(ValueError, match="output channels"):
        quantize_weights(w, cfg, shard=("model", None),
                         mesh=Mesh({"model": 4}, rank=0))


def test_a_sharded_cache_needs_its_mesh():
    cfg = QuantConfig()
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((48, 16)).astype(np.float32))
    xq, xs = quantize(torch.from_numpy(
        rng.standard_normal((8, 48)).astype(np.float32)), cfg, axis=0)
    part = quantize_weights(w, cfg, prestack=True, window_pad=True,
                            shard=(None, "model"),
                            mesh=Mesh({"data": 1, "model": 2}, rank=1))
    with pytest.raises(ValueError, match="one rank's slice"):
        streaming_argmax(xq, part.planes, xs, part.scale)
    bare = dataclasses.replace(part, planes=None)
    with pytest.raises(ValueError, match="prestack=True"):
        bare.stream_operand(cfg.n_bits, cfg.log2_radix)


def test_unported_mesh_modes_raise_naming_their_slice():
    from repro_torch.serve.batching import ContinuousBatcher

    cfg = dataclasses.replace(get_smoke("smollm-135m"), l2r=QuantConfig())
    # "specs" serves every family (the smoke model's one kv
    # head over a model axis of 2 takes the head_dim layout, an SSM its
    # heads), and refuses whole params where the layout splits them
    with pytest.raises(ValueError, match="shard_params"):
        ContinuousBatcher(cfg, {}, state_sharding="specs", device="cpu",
                          mesh=Mesh({"data": 1, "model": 2}, rank=0))
    with pytest.raises(ValueError, match="shard_params"):
        ContinuousBatcher(get_smoke("mamba2-130m"), {}, device="cpu",
                          state_sharding="specs",
                          mesh=Mesh({"data": 1, "model": 2}, rank=0))
    # "batch" constructs: rank 1 of a (data 2, model 1) mesh holds slots
    # 2 and 3 of 4 (no collective runs before the first step)
    eng = ContinuousBatcher(cfg, {}, n_slots=4, state_sharding="batch",
                            device="cpu", progressive=True,
                            mesh=Mesh({"data": 2, "model": 1}, rank=1))
    assert (eng._r0, eng._n_local) == (2, 2)
    assert tuple(eng.state.pos.shape) == (2,)
    assert tuple(eng.cur_tok.shape) == (4, 1)
    with pytest.raises(ValueError, match="state_sharding"):
        ContinuousBatcher(cfg, {}, state_sharding="rows", device="cpu")
