"""The installed mesh and the interior sharding hints.

The port of ``repro/sharding/ctx.py``.  The installed mesh
(:func:`set_mesh`) routes the serving stack onto its sharded paths:
``core/progressive.py:streaming_argmax`` takes the consensus level walk,
``quantize_weights(..., shard=)`` keeps this rank's slice of a weight
cache, and the batcher and the gateway pass the mesh to their steps.  A
mesh left installed by one caller changes all of that for the next, so
tests restore ``set_mesh(None)`` after each test.

The reference's hints pin tensors for its partitioner.  PyTorch runs
eagerly with no partitioner, so :func:`hint`, :func:`hint_dp`,
:func:`hint_uneven` and :func:`constrain` return their input unchanged;
they keep the reference's check that a spec names no more dims than the
operand has.  (The reference's ``hints_disabled`` scope, which turns the
hints off around a replicated backbone, has nothing to turn off here and
is not ported.)  A mesh is anything with the reference mesh's ``shape``
(axis name -> size) and ``axis_names`` (launch/mesh.py:Mesh).

The data-parallel paths run each rank on its own rows of the global
batch: :func:`row_shard` installs a mesh for a scope and records the
axes the rows are split over (:func:`row_axes`), which models/moe.py
reads to keep the global batch's routing.

The tensor-parallel paths run each rank on its slice of the backbone's
params (sharding/axes.py:shard_params, per ``param_specs``):
:func:`model_shard` installs a mesh for a scope and says that the
params hold this rank's part of the ``model`` axis, and, with ``seq``,
that the residual stream between blocks holds this rank's part of the
sequence; :func:`model_split` reads it (models/common.py:dense, the
attention, MLP and MoE layers, ``lm_forward`` and the cross-entropy).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple

import torch

_MESH = None
_ROWS: tuple[str, ...] = ()
_MODEL = None  # the ModelSplit of a model_shard scope

__all__ = ["set_mesh", "get_mesh", "hint", "hint_dp", "hint_uneven",
           "mesh_axis_size", "safe_axes", "constrain", "row_shard",
           "row_axes", "axes_tuple", "ModelSplit", "model_shard",
           "model_split", "snapshot", "restored"]


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def axes_tuple(axes) -> tuple[str, ...]:
    """A spec entry (a name, a tuple of names, or None) as a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@contextlib.contextmanager
def row_shard(mesh, axes):
    """Within the scope ``mesh`` is installed and the activations hold
    this rank's rows of the global batch, split evenly over ``axes`` (a
    spec entry; axes of size 1 are dropped, None for whole rows).  The
    previous mesh and row axes come back on exit."""
    global _MESH, _ROWS
    saved = _MESH, _ROWS
    _MESH = mesh
    _ROWS = tuple(a for a in axes_tuple(axes) if mesh.shape[a] > 1)
    try:
        yield
    finally:
        _MESH, _ROWS = saved


def row_axes() -> tuple[str, ...]:
    """The axes this rank's rows are split over (:func:`row_shard`); ()
    for whole rows."""
    return _ROWS


class ModelSplit(NamedTuple):
    """The backbone's split over the ``model`` axis in a
    :func:`model_shard` scope: this rank is ``index`` of ``size`` in
    ``group`` (the model axis's process group); ``seq`` says that the
    residual stream between blocks holds this rank's part of the
    sequence (Megatron's sequence parallelism)."""

    mesh: Any
    group: Any
    size: int
    index: int
    seq: bool


@contextlib.contextmanager
def model_shard(mesh, seq: bool = False):
    """Within the scope ``mesh`` is installed and the backbone's params
    are this rank's slices over its ``model`` axis (sharding/axes.py:
    shard_params); with ``seq`` the residual stream between blocks is
    split over ``model`` by sequence.  A model axis of size 1 (or none)
    splits nothing.  The previous mesh and split come back on exit."""
    global _MESH, _MODEL
    saved = _MESH, _MODEL
    _MESH = mesh
    m = mesh.shape.get("model", 1)
    _MODEL = ModelSplit(mesh, mesh.group("model"), m, mesh.index("model"),
                        seq) if m > 1 else None
    try:
        yield
    finally:
        _MESH, _MODEL = saved


def model_split() -> ModelSplit | None:
    """The backbone's split over ``model`` (:func:`model_shard`); None
    for whole params."""
    return _MODEL


def snapshot() -> tuple:
    """The installed mesh, row axes and model split, for :func:`restored`
    (a checkpointed block recomputes in the backward, after its scopes
    have exited)."""
    return _MESH, _ROWS, _MODEL


@contextlib.contextmanager
def restored(snap: tuple):
    """Within the scope the state of :func:`snapshot` is installed; the
    previous comes back on exit."""
    global _MESH, _ROWS, _MODEL
    saved = _MESH, _ROWS, _MODEL
    _MESH, _ROWS, _MODEL = snap
    try:
        yield
    finally:
        _MESH, _ROWS, _MODEL = saved


def mesh_axis_size(mesh, axis) -> int:
    """Total size of a mesh axis entry (name, tuple of names, or None)."""
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _check_spec_rank(x: torch.Tensor, spec: tuple, fn: str) -> None:
    """A spec longer than the operand's rank raises, with the shapes."""
    if len(spec) > x.ndim:
        raise ValueError(
            f"{fn}: spec {spec!r} has {len(spec)} entries but x has rank "
            f"{x.ndim} (shape {tuple(x.shape)}); a spec must not name more "
            f"dims than the operand has — extra entries used to be silently "
            f"dropped")


def safe_axes(mesh, shape: tuple[int, ...], spec: tuple) -> tuple:
    """Per-dim mesh axes of ``spec`` with unknown axis names dropped and
    non-divisible dims replicated (the weight-cache sharding of
    core/quant.py reads this too)."""
    fixed = []
    for dim, ax in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if ax is not None and isinstance(ax, (tuple, list)):
            ax = tuple(a for a in ax if a in mesh.axis_names) or None
        if ax is not None and not isinstance(ax, (tuple, list)) \
                and ax not in mesh.axis_names:
            ax = None
        fixed.append(ax if ax is None or dim % mesh_axis_size(mesh, ax) == 0
                     else None)
    return tuple(fixed)


def constrain(x: torch.Tensor, mesh, *spec) -> torch.Tensor:
    """The reference's constraint against an explicit mesh: ``x``
    unchanged, after the rank check (identity when ``mesh`` is None)."""
    if mesh is None:
        return x
    _check_spec_rank(x, spec, "constrain")
    return x


def hint(x: torch.Tensor, *spec) -> torch.Tensor:
    """``x`` unchanged; with a mesh installed, a spec longer than ``x``'s
    rank raises."""
    if _MESH is None:
        return x
    return constrain(x, _MESH, *spec)


def hint_dp(x: torch.Tensor) -> torch.Tensor:
    """Dim 0 over the data-parallel axes: ``x`` unchanged."""
    from repro_torch.sharding.axes import dp_axes  # axes imports this

    if _MESH is None:
        return x
    return hint(x, dp_axes(_MESH))


def hint_uneven(x: torch.Tensor, *spec) -> torch.Tensor:
    """The hint without the divisibility guard: ``x`` unchanged, after the
    rank check."""
    if _MESH is None:
        return x
    _check_spec_rank(x, spec, "hint_uneven")
    return x
