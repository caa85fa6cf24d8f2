"""Logical-axis -> mesh-axis rules for params, optimizer state and data.

The port of ``repro/sharding/axes.py``: pure functions of shapes and a
mesh's ``shape`` and ``axis_names``, returning :class:`P` specs (the
reference's ``PartitionSpec``, as a tuple of per-dim entries: a mesh
axis name, a tuple of names, or None).

Production meshes (launch/mesh.py): (data=16, model=16) and (pod=2,
data=16, model=16).  Parameter logical axes: ``vocab``, ``qkv``, ``ffn``
and ``experts`` -> "model"; ``embed`` and ``layers`` replicated.  The
optimizer state additionally shards its largest replicated divisible
dim over "data" (ZeRO-1).

:func:`shard_params` keeps this rank's slice of every leaf of a param
tree (the reference's ``jax.device_put(params, named(mesh,
param_specs(desc, mesh)))``): the tensor-parallel backbone of every
family, run in a ``ctx.model_shard`` scope; :func:`gather_params` is its
inverse.  A rank holds each leaf as :func:`held_layouts` says, which is
``param_specs``'s contiguous block but where the leaf's descriptor says
otherwise (models/common.py:Param ``held``, set by the mixer that reads
it), for two kinds of leaf whose mixer would otherwise need collectives
the reference's partitioner inserts:

* Mamba-2's ``in_proj`` (d, 2 d_inner + 2N + H) and its conv (conv_w,
  conv_b over d_inner + 2N) are head-aligned
  (models/ssm.py:held_columns): a rank holds its heads' z, x and dt
  columns and B's and C's whole (one group, used by every head), where
  ``param_specs`` would cut contiguous blocks across the z / xBC boundary
  (mamba2-130m at model 2: 1,804 of 3,352 columns a rank, not 1,676).
  A column subset of an L2R product is bit for bit (per-row activation
  scales, per-column weight scales);
* RG-LRU's ``w_a`` and ``w_x`` (float gate products) stay whole on every
  rank where ``param_specs`` splits their rows: a sum over the ranks
  would reassociate (models/rglru.py:gates_whole; 2 x 26.2 MB of f32 a
  rec layer of recurrentgemma-2b on every rank).

Where the model axis does not divide a leaf's dim ``param_specs`` keeps
it whole (``safe_spec``), and so do the mixers' head-aligned leaves where
it does not divide the heads; a block whose weights are whole runs whole
on every rank and its consumer takes the rank's slice
(models/common.py:residual_dense).  :func:`whole_leaves` lists them.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.sharding.collectives import on_device
from repro_torch.sharding.ctx import axes_tuple, mesh_axis_size

__all__ = [
    "P",
    "PARAM_RULES",
    "dp_axes",
    "batch_spec",
    "safe_spec",
    "param_specs",
    "zero1_specs",
    "zero1_spec",
    "logical_rules",
    "slice_index",
    "local_slice",
    "batch_rows",
    "Layout",
    "held_layouts",
    "whole_leaves",
    "cut_leaf",
    "shard_params",
    "gather_params",
    "params_split",
    "splits_anything",
]

PARAM_RULES: dict[str, Any] = {
    "vocab": "model",
    "embed": None,
    "qkv": "model",
    "ffn": "model",
    "experts": "model",
    "layers": None,
}


def _entry(e):
    """A spec entry as the reference's PartitionSpec keeps it: a list as
    a tuple, a tuple of one name as that name."""
    if isinstance(e, (list, tuple)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: one entry per leading dim of the operand (a mesh
    axis name, a tuple of names, or None = replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 \
            else f"P({self[0]!r})"


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def logical_rules(mesh) -> dict[str, Any]:
    return dict(PARAM_RULES)


def batch_spec(mesh, batch_size: int) -> P:
    """Tokens/labels (B, S): batch over the DP axes when divisible."""
    axes = dp_axes(mesh)
    size = mesh_axis_size(mesh, axes)
    if batch_size % size == 0:
        return P(axes, None)
    if batch_size % mesh.shape["data"] == 0:
        return P("data", None)
    return P(None, None)


def batch_rows(mesh, batch: int):
    """``(axes, r0, n)``: this rank's rows ``[r0, r0 + n)`` of a
    ``batch``-row global batch, split contiguously in rank order over
    :func:`batch_spec`'s axes (those of size 1 dropped), or ``(None, 0,
    batch)`` where the batch is not split (no mesh, a count the data axes
    do not divide, or data axes of size 1)."""
    if mesh is None:
        return None, 0, batch
    axes = tuple(a for a in axes_tuple(batch_spec(mesh, batch)[0])
                 if mesh.shape[a] > 1)
    if not axes:
        return None, 0, batch
    n = batch // mesh_axis_size(mesh, axes)
    return axes, mesh.index(axes) * n, n


def safe_spec(shape: tuple[int, ...], spec: tuple, mesh) -> P:
    """Replicate any sharded dim the mesh does not divide, and dedupe
    mesh axes (the leading dim that names an axis keeps it)."""
    fixed = []
    used: set = set()
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, ax in zip(shape, spec):
        if ax is not None and dim % mesh_axis_size(mesh, ax) != 0:
            ax = None
        if ax is not None:
            key = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
            if used & set(key):
                ax = None
            else:
                used |= set(key)
        fixed.append(ax)
    return P(*fixed)


def _base_spec(p, rules: dict, mesh) -> P:
    return safe_spec(p.shape, P(*(rules.get(a, None) if a is not None
                                  else None for a in p.axes)), mesh)


def param_specs(desc_tree, mesh):
    """The P tree of a Param descriptor tree (models/common.py:Param)."""
    from repro_torch.models.common import tree_map

    rules = logical_rules(mesh)
    return tree_map(lambda p: _base_spec(p, rules, mesh), desc_tree)


def zero1_spec(p, mesh) -> P:
    """One Param's optimizer-state spec: its param spec plus "data" on
    its largest still-replicated dim that divides (ZeRO-1)."""
    spec = list(_base_spec(p, logical_rules(mesh), mesh))
    dsize = mesh.shape["data"]
    best, best_dim = None, 0
    for i, (dim, s) in enumerate(zip(p.shape, spec)):
        if s is None and dim % dsize == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best is not None:
        spec[best] = "data"
    return P(*spec)


def zero1_specs(desc_tree, mesh):
    """Optimizer-state specs: the param spec plus "data" on the largest
    still-replicated dim that divides (ZeRO-1)."""
    from repro_torch.models.common import tree_map

    return tree_map(lambda p: zero1_spec(p, mesh), desc_tree)


def slice_index(shape: tuple[int, ...], spec: tuple, mesh):
    """The function ``coords -> index`` (a tuple of slices) of the block
    of a ``shape`` tensor that the rank at ``coords`` (axis name ->
    index, launch/mesh.py:Mesh.coords) holds under ``spec``: each dim
    split evenly over its axes, row-major over a tuple of them."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))

    def index(coords: dict) -> tuple:
        out = []
        for dim, ax in zip(shape, spec):
            names = (ax,) if isinstance(ax, str) else tuple(ax or ())
            n, i = 1, 0
            for a in names:
                n, i = n * mesh.shape[a], i * mesh.shape[a] + coords[a]
            size = dim // n
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    return index


def local_slice(x, spec: tuple, mesh):
    """This rank's block of ``x`` under ``spec`` (:func:`slice_index`), a
    view."""
    return x[slice_index(tuple(x.shape), spec, mesh)(mesh.coords())]


def _desc(cfg, desc):
    if desc is not None:
        return desc
    if cfg.family == "encdec":
        from repro_torch.models.encdec import encdec_build

        return encdec_build(cfg)
    from repro_torch.models.transformer import lm_build

    return lm_build(cfg)


def _spec_leaves(specs) -> list:
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    return [x for t in specs for x in _spec_leaves(t)]


def _walk(params, specs, desc, fn):
    """``fn(leaf, spec, desc_param)`` over the leaves of ``params`` that
    the spec tree covers (a ``{"q", "scale"}`` record is one leaf); keys
    it does not cover (a ``prepare_params`` head cache) stay as they
    are."""
    if isinstance(specs, P):
        return fn(params, specs, desc)
    if isinstance(params, dict):
        return {k: _walk(v, specs[k], desc[k], fn) if k in specs else v
                for k, v in params.items()}
    return type(params)(_walk(v, sp, d, fn)
                        for v, sp, d in zip(params, specs, desc))


class Layout(NamedTuple):
    """How a rank holds one leaf over "model": ``spec`` names "model" on
    the split dim (the dims ZeRO-1 may not cut again), ``index(coords) ->
    index tuple`` gives the block of the rank at ``coords`` (slices, or a
    LongTensor of positions along the last dim), ``shared`` the positions
    ``(lo, hi)`` of the rank's block along its last dim that every model
    rank holds alike (counted once in a global norm), or None."""

    spec: P
    index: Callable
    shared: tuple | None = None


def _paths(tree, path: str = "") -> list:
    """``(path, leaf)`` of every Param leaf, in ``tree_leaves`` order."""
    from repro_torch.models.common import Param

    if isinstance(tree, Param):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths(tree[k], f"{path}.{k}" if path else k)]
    return [x for i, t in enumerate(tree)
            for x in _paths(t, f"{path}[{i}]")]


def _leaf_layout(p, spec: P, mesh) -> Layout:
    """A leaf's :class:`Layout`: ``param_specs``' block, or what its
    descriptor's ``held`` says (models/common.py:Param)."""
    if p.held is None:
        return Layout(spec, slice_index(p.shape, spec, mesh))
    nd = len(p.shape)
    held = p.held(mesh.shape.get("model", 1))
    if held is None:
        return Layout(P(*([None] * nd)), slice_index(p.shape, (), mesh))
    columns, shared = held
    return Layout(P(*spec),
                  lambda c: (slice(None),) * (nd - 1) + (columns(c["model"]),),
                  shared)


def held_layouts(cfg, mesh, desc=None) -> list[Layout]:
    """One :class:`Layout` a leaf of ``cfg``'s param tree, in
    ``tree_leaves`` order (the module docstring says where it is not
    ``param_specs``'s block)."""
    desc = _desc(cfg, desc)
    specs = _spec_leaves(param_specs(desc, mesh))
    return [_leaf_layout(p, spec, mesh)
            for (_, p), spec in zip(_paths(desc), specs)]


def whole_leaves(cfg, mesh, desc=None) -> list[str]:
    """The leaves whose logical axes map to "model" that a rank holds
    whole all the same (the model axis does not divide them, or they are
    the RG-LRU's gate weights): where a block runs whole on every rank."""
    desc = _desc(cfg, desc)
    out = []
    for (path, p), lay in zip(_paths(desc),
                                    held_layouts(cfg, mesh, desc)):
        if any(PARAM_RULES.get(a) == "model" for a in p.axes if a) \
                and "model" not in lay.spec:
            out.append(path)
    return out


def cut_leaf(x, layout: Layout, mesh):
    """This rank's block of a whole leaf ``x`` under ``layout`` (a copy
    where it cuts, ``x`` itself where it does not)."""
    if not any(a is not None for a in layout.spec):
        return x
    idx = on_device(layout.index(mesh.coords()), x.device)
    return x[idx].clone()


def splits_anything(cfg, mesh, desc=None) -> bool:
    """Does ``cfg``'s layout over ``mesh`` split any leaf over "model"?"""
    return mesh is not None and mesh.shape.get("model", 1) > 1 and any(
        "model" in lay.spec for lay in held_layouts(cfg, mesh, desc))


def shard_params(cfg, params, mesh, desc=None):
    """This rank's slice of every leaf of ``params`` per
    :func:`held_layouts` over ``mesh`` (copies: the whole tree can be
    freed).  Takes a raw tree (float leaves) or a prepared one
    (serve/engine.py:prepare_params: a :class:`QuantizedWeights` is cut
    by core/quant.py:shard_weights, by output channels or by contraction
    rows, the head cache ``head_q`` kept as prepare_params split it).
    Every family; the result runs in a ``ctx.model_shard`` scope.
    models/moe.py:shard_experts is the special case that cuts the expert
    stacks alone."""
    from repro_torch.core.quant import QuantizedWeights, shard_weights

    desc = _desc(cfg, desc)
    specs = param_specs(desc, mesh)
    layouts = iter(held_layouts(cfg, mesh, desc))

    def cut(x, spec, p):
        lay = next(layouts)
        if not any(a is not None for a in lay.spec):
            return x
        if isinstance(x, QuantizedWeights):
            if lay.shared is not None:
                raise ValueError(
                    "shard_params: a prepared record of a head-aligned "
                    "Mamba-2 leaf (prepare_params makes the ssm family's "
                    "forward fail in both packages); split the raw tree")
            return shard_weights(x, spec, mesh,
                                 1 if p.axes[0] == "layers" else 0)
        if isinstance(x, dict):
            raise NotImplementedError(
                "shard_params: the int8 {'q', 'scale'} records "
                "(models/common.py:quantize_params) serve whole; split a "
                "raw or a prepare_params tree")
        return cut_leaf(x, lay, mesh)

    return _walk(params, specs, desc, cut)


def gather_params(cfg, params, mesh, desc=None):
    """The whole float params from every rank's :func:`shard_params`
    slices (every rank calls it; one all-gather over the model group per
    dtype): the inverse of :func:`shard_params` on a raw tree."""
    from repro_torch.models.common import tree_leaves, tree_unflatten
    from repro_torch.sharding.collectives import gather_slices

    desc = _desc(cfg, desc)
    shapes = [tuple(p.shape) for p in tree_leaves(desc)]
    whole = gather_slices(tree_leaves(params),
                          [lay.index for lay in held_layouts(cfg, mesh,
                                                             desc)],
                          shapes, mesh, axes=("model",))
    return tree_unflatten(params, whole)


def params_split(cfg, params) -> bool:
    """Do ``params`` hold a rank's backbone slices (:func:`shard_params`)
    rather than whole leaves?  Read from the leaves' shapes against the
    descriptor tree; the expert stacks do not count (a whole backbone
    with a rank's experts, models/moe.py:shard_experts, is the
    dp-local MoE's layout)."""
    from repro_torch.models.common import Param

    def split(x, d) -> bool:  # a leaf ``params`` lacks counts as whole
        if isinstance(d, Param):
            if "experts" in d.axes:
                return False
            x = x["q"] if isinstance(x, dict) else x  # an int8 record
            return tuple(x.shape) != tuple(d.shape)
        if isinstance(d, dict):
            return any(split(x[k], d[k]) for k in d if k in x)
        return any(split(a, b) for a, b in zip(x, d))

    return split(params, _desc(cfg, None))
