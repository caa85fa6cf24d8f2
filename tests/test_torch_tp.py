"""The tensor-parallel pieces of the port in one process (no ranks).

The reference gets its tensor parallelism from GSPMD; the port writes it
by hand (ROADMAP A13c), and these are the pieces it rests on:

* a weight cache cut by its contraction rows (core/quant.py:
  shard_weights) holds the whole cache's rows, of ``q`` and of every
  plane block of the stack, and the whole columns' scales; cut by its
  output channels, the whole cache's columns;
* the ranks' int32 partials of a K-split product (kernel B1's plain
  version on each K-slice), summed in int64 and narrowed as
  sharding/collectives.py:sum_int narrows, equal the whole product at
  every ``levels`` truncation, a 16-bit case that wraps under
  ``L2R_CERTIFY=warn`` included;
* an activation row quantized from the MAX of its slices' amaxes
  (kernels/l2r_gemm/ops.py:_row_split_quant, the all-reduce stood in
  for) gives the whole row's codes and scale;
* sharding/axes.py:shard_params and models/convert.py's crossing keep
  the slice of every leaf of a JAX-``materialize``d tree that the
  reference's ``param_specs`` names (its optimizer state the slice its
  ``zero1_specs`` names), and a prepared tree's caches the slices of the
  whole caches;
* ``shard_params`` and the ``"specs"`` slot layout take an SSM config
  (its head-aligned ``in_proj``) and kv heads the model axis does not
  divide (the head_dim cache layout), and "specs" refuses whole params
  where the layout splits them.

The multi-rank runs are tests/test_torch_tp_serve.py (serving) and
tests/test_torch_sharded_train.py (training).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.l2r_gemm import wrap_int32
from repro_torch.core.quant import (ColumnShard, QuantConfig, RowShard,
                                    quantize, shard_weights)
from repro_torch.kernels.l2r_gemm import ops
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import quantize_tree, tree_leaves
from repro_torch.models.transformer import lm_build
from test_torch_train import _one_torch_thread  # noqa: F401

MESH = {"data": 2, "model": 2}


def _ranks(shape=MESH):
    return [Mesh(shape, rank=r) for r in range(int(np.prod(list(
        shape.values()))))]


def _cache(k: int = 96, n: int = 40, seed: int = 0, stacked: bool = False):
    """A prepared weight cache as prepare_params builds it (per-out-channel
    scales, the pre-shifted K-major plane stack)."""
    from repro_torch.models.common import Param

    g = torch.Generator().manual_seed(seed)
    shape = (3, k, n) if stacked else (k, n)
    axes = ("layers", "embed", "ffn") if stacked else ("embed", "ffn")
    w = torch.randn(shape, generator=g)
    return quantize_tree({"w": Param(shape, axes)}, {"w": w},
                         QuantConfig(), prestack=True)["w"]


@pytest.mark.parametrize("stacked", [False, True])
def test_row_slice_is_the_whole_caches_rows(stacked):
    whole = _cache(stacked=stacked)
    kd = 1 if stacked else 0
    spec = (None, "model", None) if stacked else ("model", None)
    k = whole.q.shape[kd]
    d = whole.planes.d
    for mesh in _ranks():
        part = shard_weights(whole, spec, mesh, kd)
        j = mesh.coords()["model"]
        rows = slice(j * k // 2, (j + 1) * k // 2)
        idx = (slice(None), rows) if stacked else (rows,)
        assert isinstance(part.shard, RowShard)
        assert part.shard.k_total == k and part.shard.offset == rows.start
        assert torch.equal(part.q, whole.q[idx])
        assert torch.equal(part.scale, whole.scale)  # the whole columns'
        st = whole.planes.stack
        blocks = st.reshape(*st.shape[:kd], d, k, st.shape[-1])
        want = blocks[(slice(None),) * (kd + 1) + (rows,)].reshape(
            part.planes.stack.shape)
        assert part.planes.k == k // 2
        assert torch.equal(part.planes.stack, want)
        # K-major, as kernel B1 reads it
        assert part.planes.stack.stride(kd) == 1


def test_column_slice_is_the_whole_caches_columns():
    whole = _cache()
    n = whole.q.shape[-1]
    for mesh in _ranks():
        part = shard_weights(whole, (None, "model"), mesh, 0)
        j = mesh.coords()["model"]
        cols = slice(j * n // 2, (j + 1) * n // 2)
        assert isinstance(part.shard, ColumnShard)
        assert torch.equal(part.q, whole.q[:, cols])
        assert torch.equal(part.scale, whole.scale[:, cols])
        assert torch.equal(part.planes.stack, whole.planes.stack[:, cols])
        assert part.planes.stack.stride(0) == 1


@pytest.mark.parametrize("n_bits,k", [(8, 96), (16, 64)])
def test_k_split_partials_sum_to_the_whole_product(n_bits, k, monkeypatch):
    """B1's plain version on each K-slice, the int32 partials summed in
    int64 and narrowed (collectives.sum_int's arithmetic): the whole
    product at every ``levels``; the 16-bit case wraps mod 2^32."""
    monkeypatch.setenv("L2R_CERTIFY", "warn")
    g = torch.Generator().manual_seed(n_bits)
    lo, hi = -(2 ** (n_bits - 1)) + 1, 2 ** (n_bits - 1)
    dt = torch.int8 if n_bits == 8 else torch.int16
    a = torch.randint(lo, hi, (6, k), generator=g).to(dt)
    b = torch.randint(lo, hi, (k, 10), generator=g).to(dt)
    cfg = QuantConfig(n_bits=n_bits)
    levels_all = range(1, 2 * cfg.planes)
    wrapped = False
    for m in (2, 4):
        for levels in levels_all:
            whole = ops.l2r_gemm(a, b, n_bits, 2, levels)
            parts = [ops.l2r_gemm(a[:, j * k // m:(j + 1) * k // m],
                                  b[j * k // m:(j + 1) * k // m], n_bits, 2,
                                  levels) for j in range(m)]
            total = sum(p.to(torch.int64) for p in parts)
            wrapped |= bool((total.abs() >= 2 ** 31).any())
            assert torch.equal(wrap_int32(total), whole), (m, levels)
    if n_bits == 16:
        assert wrapped, "no sum left the int32 range: the wrap is untested"


def test_global_amax_quantization_is_the_whole_rows(monkeypatch):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(7, 48, generator=g) * torch.linspace(0.1, 3, 48)
    cfg = QuantConfig()
    want_q, want_s = quantize(x, cfg, axis=0)
    for m in (2, 3, 4):
        slices = x.chunk(m, dim=-1)
        amaxes = torch.stack([s.abs().amax(-1, keepdim=True) for s in slices])

        def fake_reduce(t, op, group):  # the MAX all-reduce of the slices
            assert op == "max"
            return amaxes.amax(0)

        monkeypatch.setattr(ops, "all_reduce", fake_reduce)
        got = [ops._row_split_quant(s, 0, cfg, None) for s in slices]
        assert torch.equal(torch.cat([q for q, _ in got], -1), want_q)
        for _, s in got:
            assert torch.equal(s, want_s)


# ------------------------------------------------ slices of a JAX tree
def _j_tree(arch: str, seed: int = 0):
    import jax

    from repro.configs import get_smoke as j_get_smoke
    from repro.models.common import materialize
    from repro.models.transformer import lm_build as j_lm_build

    jcfg = j_get_smoke(arch)
    desc = j_lm_build(jcfg)
    key = jax.random.PRNGKey(seed)
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: materialize(desc, k)).lower(key).compile(
        {"xla_backend_optimization_level": 0})(key))
    return jcfg, desc, tree


class _FakeMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _np_slice(x: np.ndarray, spec, shape: dict, coords: dict) -> np.ndarray:
    idx = []
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    for dim, ax in zip(x.shape, spec):
        names = (ax,) if isinstance(ax, str) else tuple(ax or ())
        n, i = 1, 0
        for a in names:
            n, i = n * shape[a], i * shape[a] + coords[a]
        idx.append(slice(i * dim // n, (i + 1) * dim // n))
    return x[tuple(idx)]


@pytest.mark.parametrize("arch", ["granite-8b", "deepseek-moe-16b"])
def test_shard_params_keeps_the_param_specs_slices(arch):
    import jax

    from repro.sharding import axes as jaxes
    from repro_torch.models.convert import (lm_params_from_jax,
                                            opt_state_from_jax)
    from repro_torch.optim.adamw import OptState
    from repro_torch.sharding.axes import shard_params
    from repro_torch.train.step import zero1_layout

    jcfg, jdesc, tree = _j_tree(arch)
    cfg = get_smoke(arch)
    jspecs = jax.tree.leaves(jaxes.param_specs(jdesc, _FakeMesh(MESH)),
                             is_leaf=lambda s: not isinstance(s, dict)
                             and not isinstance(s, list))
    jz = jax.tree.leaves(jaxes.zero1_specs(jdesc, _FakeMesh(MESH)),
                         is_leaf=lambda s: not isinstance(s, dict)
                         and not isinstance(s, list))
    leaves = jax.tree.leaves(tree)
    state = OptState(step=np.int32(1), m=tree, v=tree)
    for mesh in _ranks():
        coords = mesh.coords()
        by_shard = tree_leaves(shard_params(
            cfg, lm_params_from_jax(tree, "cpu"), mesh))
        zero = zero1_layout(cfg, mesh)
        opt = opt_state_from_jax(state, "cpu", zero)
        assert len(by_shard) == len(leaves) == len(jspecs)
        for got, m, x, sp, zs in zip(by_shard, tree_leaves(opt.m), leaves,
                                     jspecs, jz):
            np.testing.assert_array_equal(got.numpy(),
                                          _np_slice(x, sp, MESH, coords))
            np.testing.assert_array_equal(
                m.numpy(), _np_slice(x, zs, MESH, coords))


def test_shard_params_cuts_a_prepared_trees_caches():
    from repro_torch.core.quant import QuantizedWeights
    from repro_torch.models.common import materialize
    from repro_torch.serve.engine import prepare_params
    from repro_torch.sharding.axes import param_specs, shard_params

    cfg = dataclasses.replace(get_smoke("granite-8b"), l2r=QuantConfig())
    params = materialize(lm_build(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    whole = prepare_params(cfg, params)
    specs = param_specs(lm_build(cfg), _ranks()[0])
    for mesh in _ranks():
        part = shard_params(cfg, whole, mesh)
        assert part["head_q"] is whole["head_q"]  # prepare_params's own
        for name in ("wq", "wk", "wv", "wo"):
            w, p = whole["stack"][0]["mixer"][name], \
                part["stack"][0]["mixer"][name]
            assert isinstance(p, QuantizedWeights)
            spec = specs["stack"][0]["mixer"][name]
            kd = 1
            want = shard_weights(w, spec, mesh, kd)
            assert torch.equal(p.q, want.q)
            assert torch.equal(p.scale, want.scale)
            assert torch.equal(p.planes.stack, want.planes.stack)
            split = [i for i, a in enumerate(spec) if a == "model"]
            assert isinstance(p.shard, RowShard if split == [kd]
                              else ColumnShard), name


def test_params_split_reads_the_backbone_not_the_experts():
    """The step factories run split params in the model scope
    (serve/engine.py:split_scope): a shard_params tree is split; a whole
    tree, and a whole backbone with a rank's experts (the dp-local MoE's
    layout, models/moe.py:shard_experts), are not."""
    from repro_torch.models.common import materialize
    from repro_torch.models.moe import shard_experts
    from repro_torch.sharding.axes import params_split, shard_params

    cfg = get_smoke("deepseek-moe-16b")
    whole = materialize(lm_build(cfg), torch.Generator().manual_seed(0),
                        device="cpu")
    mesh = _ranks()[1]
    assert not params_split(cfg, whole)
    assert not params_split(cfg, shard_experts(cfg, whole, mesh))
    assert params_split(cfg, shard_params(cfg, whole, mesh))


def test_specs_refuses_what_a13d_ports():
    """What the slot layout once refused is accepted: an SSM's params
    split (head-aligned in_proj and conv), the smoke SmolLM's one kv head
    over a model axis of 2 in the head_dim layout; "specs" still refuses
    whole params where the layout splits them."""
    from repro_torch.models.common import materialize
    from repro_torch.models.transformer import init_lm_state
    from repro_torch.serve.batching import check_state_sharding
    from repro_torch.sharding import ctx
    from repro_torch.sharding.axes import params_split, shard_params

    mesh = Mesh({"data": 1, "model": 2}, rank=0)
    ssm = get_smoke("mamba2-130m")
    with pytest.raises(ValueError, match="shard_params"):
        check_state_sharding(ssm, {}, mesh, "specs")
    p = shard_params(ssm, materialize(lm_build(ssm), torch.Generator()
                                      .manual_seed(0), device="cpu"), mesh)
    # z, x of 4 of 8 heads (64 + 64), B and C (2 x 16), dt of 4 heads
    assert tuple(p["stack"][0]["mixer"]["in_proj"].shape) == (4, 64, 164)
    assert params_split(ssm, p)
    check_state_sharding(ssm, p, mesh, "specs")
    cfg = get_smoke("smollm-135m")
    params = shard_params(cfg, materialize(
        lm_build(cfg), torch.Generator().manual_seed(0), device="cpu"), mesh)
    check_state_sharding(cfg, params, mesh, "specs")
    ranked = Mesh({"data": 1, "model": 2}, rank=0,
                  groups={("model",): None})  # no collective runs
    with ctx.model_shard(ranked):
        st = init_lm_state(cfg, 2, 16, torch.float32, device="cpu")
    c = st.stack[0]
    # every kv head, the whole keys, half of each head's values
    assert c.k.shape[-2:] == (cfg.n_kv, cfg.head_dim)
    assert c.v.shape[-2:] == (cfg.n_kv, cfg.head_dim // 2)
