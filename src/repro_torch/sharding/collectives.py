"""The collectives of the mesh: one helper per operation, each taking the
process group.

gloo, the backend that runs several ranks on one card or on the CPU,
reduces host tensors: a CUDA tensor is copied to the host (a blocking
copy, which waits for the kernels that made it), reduced there and copied
back, explicitly.  A backend that takes device tensors (NCCL) gets them
as they are, with no synchronize.  Every call counts itself in
:data:`COUNTS`.

The data-parallel paths (ZeRO-1, the sharded train step, MoE's
dispatch) also need collectives that autograd differentiates:
:func:`sum_forward` (a sum whose gradient passes through unchanged),
:func:`split_rows` / :func:`gather_rows` (a rank's slice of replicated
rows and the gather back, each the other's adjoint) and
:func:`all_to_all` (its own adjoint).  Several tensors travel as one
flat bucket a dtype (:func:`all_reduce_many`, :func:`gather_slices`):
each host-staged call costs milliseconds whatever its size.

The tensor-parallel paths (Megatron-style, by hand: eager torch has no
partitioner) add :func:`copy_in` (the identity, whose gradient is summed
over the group: the input of a column-parallel region),
:func:`reduce_scatter` (the sum's slice along a dim, for sequence
parallelism) and :func:`sum_int` (the exact sum of int32 partial
products, wrapping mod 2^32 as one accumulator does).  The mixers whose
rank reads more than its own channels add :func:`gather_channels` (its
channels of a whole tensor that every rank then uses: the gradient summed
and cut back) and :func:`copy_in_columns` (:func:`copy_in` on a range of
a weight's columns that every rank holds alike).  Every rank issues each
of them in the same order.

**Shapes only.**  A collective on a ``meta`` operand touches no process
group: it returns a ``meta`` tensor of its result's shape and dtype, and
is counted and recorded as on a running rank.  Its group may then be a
:class:`ShapeGroup` (axis names and size only, launch/mesh.py:
make_shape_mesh), so one rank's step runs on ``meta`` under a mesh of
any size with no process started (launch/dryrun.py: the eager
counterpart of lowering under a mesh).  Such a collective is the custom
op ``repro_torch::all_reduce`` / ``all_gather`` / ``all_to_all`` (fake
only: it returns the result's shape), whose arguments carry what the
recorder records (the reduce op, the group's axis names, size and count,
whether it runs in a level loop, the tag), so a captured graph
(launch/graph_analysis.py) holds each collective as one node with the
recorder's fields.  A collective over a process group is never an op:
gloo runs are as they were.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.l2r_gemm import wrap_int32

__all__ = ["COUNTS", "reset", "ShapeGroup", "group_size", "Record",
           "recording", "active_records", "tag", "level_loop", "name_groups", "TAG_MAX", "TAG_MIN",
           "TAG_CONSENSUS", "TAG_GATHER", "TAG_SUM_INT", "all_reduce",
           "all_gather", "gather_columns",
           "all_reduce_many", "all_to_all", "sum_forward", "split_rows",
           "gather_rows", "gather_slices", "copy_in", "reduce_scatter",
           "sum_int", "gather_channels", "copy_in_columns"]

COUNTS = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}

_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "sum": dist.ReduceOp.SUM}


#: the tags of the level walks' collectives (the reference's names,
#: repro/core/policy.py COLL_TAG_*), of their result gathers, and of the
#: row-parallel product's exact integer sum
TAG_MAX = "l2r_coll_max"
TAG_MIN = "l2r_coll_min"
TAG_CONSENSUS = "l2r_coll_consensus"
TAG_GATHER = "l2r_coll_gather"
TAG_SUM_INT = "l2r_coll_sum_int"


def reset() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


class ShapeGroup(NamedTuple):
    """The group of a mesh of shapes only: its axis ``names``, its
    ``size`` and how many such groups the mesh has (``count``).  Only
    collectives on ``meta`` operands take one."""

    names: tuple[str, ...]
    size: int
    count: int = 1


def group_size(group) -> int:
    """The number of ranks in ``group`` (a process group or a
    :class:`ShapeGroup`)."""
    if isinstance(group, ShapeGroup):
        return group.size
    return dist.get_world_size(group)


def _shapes_only(x: torch.Tensor, group) -> bool:
    """Does this collective run on shapes only (a ``meta`` operand)?  A
    :class:`ShapeGroup` cannot reduce values."""
    if x.is_meta:
        return True
    if isinstance(group, ShapeGroup):
        raise ValueError(f"a collective over {group} (a mesh of shapes "
                         f"only) on a {x.device} tensor: only meta "
                         f"operands run without a process group")
    return False


@dataclasses.dataclass(frozen=True)
class Record:
    """One collective as it ran: ``op`` ("all_reduce", "all_gather" or
    "all_to_all"), ``reduce_op`` ("max", "min", "sum"; None for the
    others), the dtype and bytes of this rank's operand, the group's
    axis names (``"model"``, ``"data"``, ``"data,model"``; "?" for a
    group no mesh named) and size, whether it ran inside a level loop
    (and which loop: ``walk``, counted from 0 in the recording), the
    innermost :func:`tag` ("" untagged), and ``taint``, the exactness
    taint of the operand where a taint audit runs (else None)."""

    op: str
    reduce_op: str | None
    dtype: str
    nbytes: int
    group: str
    group_size: int
    in_loop: bool
    walk: int | None
    tag: str
    taint: str | None = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


#: the recorder's list (None: nothing records) and the taint callback
#: of an active taint audit (tensor -> taint)
_REC: dict = {"records": None, "taint": None, "walks": 0}
_TAGS: list[str] = []
_LOOP: list[int] = []  # the walk index of each open level loop
_GROUP_NAMES: dict = {}


class recording:
    """``with recording() as records:`` appends a :class:`Record` of every
    collective issued inside to ``records`` (``taint``: a callable that
    gives an operand's taint, set by a taint audit).  Not reentrant."""

    def __init__(self, taint=None):
        self.records: list[Record] = []
        self.taint = taint

    def __enter__(self) -> list[Record]:
        if _REC["records"] is not None:
            raise RuntimeError("a collective recording is already active")
        _REC.update(records=self.records, taint=self.taint, walks=0)
        return self.records

    def __exit__(self, *exc) -> None:
        _REC.update(records=None, taint=None)


def active_records() -> list | None:
    """The list an active :func:`recording` appends to, else None."""
    return _REC["records"]


class tag:
    """``with tag(name):`` tags the collectives issued inside (the
    innermost tag wins)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _TAGS.append(self.name)

    def __exit__(self, *exc):
        _TAGS.pop()


class level_loop:
    """``with level_loop():`` marks a walk's level loop: a collective
    issued inside is a per-level one of that walk."""

    __slots__ = ()

    def __enter__(self):
        _LOOP.append(_REC["walks"])
        _REC["walks"] += 1

    def __exit__(self, *exc):
        _LOOP.pop()


def name_groups(groups: dict) -> None:
    """Name process groups for the recorder: ``groups`` maps a tuple of
    axis names to its group (launch/mesh.py:Mesh does this)."""
    for names, pg in groups.items():
        if pg is not None:
            _GROUP_NAMES[pg] = ",".join(names)


def _record(op: str, reduce_op: str | None, x: torch.Tensor, group) -> None:
    taint = _REC["taint"]
    _REC["records"].append(Record(
        op=op, reduce_op=reduce_op, dtype=str(x.dtype).replace("torch.", ""),
        nbytes=x.numel() * x.element_size(),
        group=_GROUP_NAMES.get(group, "?"),
        group_size=group_size(group), in_loop=bool(_LOOP),
        walk=_LOOP[-1] if _LOOP else None,
        tag=_TAGS[-1] if _TAGS else "",
        taint=None if taint is None else taint(x)))


def _op_args(group) -> tuple:
    """What a shapes-only collective's op carries besides its operand: the
    group's axis names, size and count, the level loop (in it, and the
    walk's index or -1) and the innermost tag."""
    size = group_size(group)
    count = group.count if isinstance(group, ShapeGroup) \
        else max(1, dist.get_world_size() // size)
    return (_GROUP_NAMES.get(group, "?"), size, count, bool(_LOOP),
            _LOOP[-1] if _LOOP else -1, _TAGS[-1] if _TAGS else "")


@torch.library.custom_op("repro_torch::all_reduce", mutates_args=())
def _all_reduce_op(x: torch.Tensor, reduce_op: str, group: str, size: int,
                   count: int, in_loop: bool, walk: int,
                   tag: str) -> torch.Tensor:
    raise RuntimeError("a shapes-only all_reduce has no values to reduce")


@torch.library.custom_op("repro_torch::all_gather", mutates_args=())
def _all_gather_op(x: torch.Tensor, dim: int, group: str, size: int,
                   count: int, in_loop: bool, walk: int,
                   tag: str) -> torch.Tensor:
    raise RuntimeError("a shapes-only all_gather has no values to gather")


@torch.library.custom_op("repro_torch::all_to_all", mutates_args=())
def _all_to_all_op(x: torch.Tensor, group: str, size: int, count: int,
                   in_loop: bool, walk: int, tag: str) -> torch.Tensor:
    raise RuntimeError("a shapes-only all_to_all has no values to exchange")


_all_reduce_op.register_fake(lambda x, *args: torch.empty_like(
    x, memory_format=torch.contiguous_format))
_all_to_all_op.register_fake(lambda x, *args: torch.empty_like(
    x, memory_format=torch.contiguous_format))


@_all_gather_op.register_fake
def _(x, dim, group, size, *args):
    shape = list(x.shape)
    shape[dim] *= size
    return x.new_empty(shape)


def _host_staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``x`` reduced elementwise over ``group`` with ``op`` ("max", "min"
    or "sum"), as a new tensor on ``x``'s device."""
    COUNTS["all_reduce"] += 1
    if _REC["records"] is not None:
        _record("all_reduce", op, x, group)
    if _shapes_only(x, group):
        return torch.ops.repro_torch.all_reduce(x.detach(), op,
                                                *_op_args(group))
    staged = _host_staged(x, group)
    y = x.cpu() if staged else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y.to(x.device) if staged else y


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order,
    on ``x``'s device."""
    COUNTS["all_gather"] += 1
    if _REC["records"] is not None:
        _record("all_gather", None, x, group)
    if _shapes_only(x, group):
        return torch.ops.repro_torch.all_gather(x.detach(), dim % x.ndim,
                                                *_op_args(group))
    staged = _host_staged(x, group)
    y = x.contiguous().cpu() if staged else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(group_size(group))]
    dist.all_gather(parts, y, group=group)
    out = torch.cat(parts, dim)
    return out.to(x.device) if staged else out


def gather_columns(y: torch.Tensor, shard) -> torch.Tensor:
    """``y`` computed on one rank's slice of a sharded weight cache
    (``shard``: core/quant.py:ColumnShard, None for a whole cache): the
    whole output, gathered along the last dim over the shard's axis."""
    if shard is None:
        return y
    return all_gather(y, shard.mesh.group(shard.axis), dim=-1)


def _by_dtype(xs: list[torch.Tensor]) -> dict:
    out: dict = {}
    for i, x in enumerate(xs):
        out.setdefault(x.dtype, []).append(i)
    return out


def all_reduce_many(xs: list[torch.Tensor], op: str, group
                    ) -> list[torch.Tensor]:
    """Each of ``xs`` reduced over ``group`` (:func:`all_reduce`), with
    one call per dtype on a flat bucket of them all."""
    out: list = [None] * len(xs)
    for idx in _by_dtype(xs).values():
        flat = all_reduce(torch.cat([xs[i].reshape(-1) for i in idx]), op,
                          group)
        for i, part in zip(idx, flat.split([xs[i].numel() for i in idx])):
            out[i] = part.view(xs[i].shape)
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    COUNTS["all_to_all"] += 1
    if _REC["records"] is not None:
        _record("all_to_all", None, x, group)
    if _shapes_only(x, group):
        return torch.ops.repro_torch.all_to_all(x.detach(), *_op_args(group))
    staged = _host_staged(x, group)
    y = x.contiguous().cpu() if staged else x.contiguous()
    out = torch.empty_like(y)
    dist.all_to_all_single(out, y, group=group)
    return out.to(x.device) if staged else out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (G, ...) with G the group's size -> ``out`` (G, ...) with
    ``out[j]`` group rank j's ``x[i]`` (i this rank's group rank): the
    exchange of per-destination blocks (``dist.all_to_all_single``).  Its
    own adjoint, so the gradient travels back the same way."""
    return _AllToAll.apply(x, group)


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_forward(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x``; the gradient reaches ``x`` unchanged.
    For a term every rank adds to its own loss (a global mean of
    per-rank parts): each rank's gradient then covers its own part, and
    the gradients' sum over the group is the whole term's."""
    return _SumForward.apply(x, group)


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, n, dim):
        ctx.group, ctx.dim = group, dim
        size = x.shape[dim] // n
        return x.narrow(dim, index * size, size)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, dim):
        ctx.index, ctx.dim, ctx.size = index, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, \
            None, None


def split_rows(x: torch.Tensor, group, index: int, n: int,
               dim: int = 0) -> torch.Tensor:
    """Slice ``index`` of ``n`` equal slices of ``x`` along ``dim`` (``x``
    the same on every rank of ``group``, ``index`` this rank's group
    rank).  The gradient is gathered over the group, so every rank's
    ``x`` receives the whole gradient of the slices' computations."""
    return _SplitRows.apply(x, group, index, n, dim)


def gather_rows(x: torch.Tensor, group, index: int,
                dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` (:func:`all_gather`);
    the gradient of this rank's slice (``index``, its group rank) is its
    part of the whole result's, for a computation every rank of the group
    repeats on the whole result."""
    return _GatherRows.apply(x, group, index, dim)


def gather_slices(parts: list[torch.Tensor], slices: list, shapes: list,
                  mesh, axes=None) -> list[torch.Tensor]:
    """Whole tensors from the slices of the ranks of the group over
    ``axes`` (default: the whole mesh): ``parts[i]`` is this rank's slice
    of a tensor of ``shapes[i]``, ``slices[i]`` the function that gives a
    rank's index tuple (sharding/axes.py:slice_index, from its
    coordinates).  One all-gather over the group per dtype; a slice that
    several ranks hold (a dim not split over every axis) is written once
    per holder, with the same values."""
    names = mesh.axis_names if axes is None else \
        tuple(a for a in mesh.axis_names if a in axes)
    group = mesh.group(names)
    n = math.prod(mesh.shape[a] for a in names)
    mine = mesh.coords()
    out: list = [None] * len(parts)
    for idx in _by_dtype(parts).values():
        sizes = [parts[i].numel() for i in idx]
        flat = all_gather(torch.cat([parts[i].reshape(-1) for i in idx]),
                          group, dim=0).view(n, sum(sizes))
        for i in idx:
            out[i] = torch.empty(shapes[i], dtype=parts[i].dtype,
                                 device=parts[i].device)
        for gr in range(n):  # group rank gr: row-major over ``names``
            coords, r = dict(mine), gr
            for a in reversed(names):
                r, coords[a] = divmod(r, mesh.shape[a])
            for i, piece in zip(idx, flat[gr].split(sizes)):
                out[i][on_device(slices[i](coords), out[i].device)] = \
                    piece.view(parts[i].shape)
    return out


def on_device(index: tuple, device) -> tuple:
    """An index tuple (slices, or a LongTensor of positions along a dim)
    with its tensors on ``device``."""
    return tuple(i.to(device) if isinstance(i, torch.Tensor) else i
                 for i in index)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.group), None


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself (the same on every rank of ``group``), whose gradient
    is summed over the group: the input of a column-parallel region, where
    each rank's product reaches only its own columns' part of ``x``'s
    gradient."""
    return _CopyIn.apply(x, group)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, n, dim):
        ctx.group, ctx.dim = group, dim
        size = x.shape[dim] // n
        return all_reduce(x, "sum", group).narrow(dim, index * size, size)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None, None, None


def reduce_scatter(x: torch.Tensor, group, index: int, n: int,
                   dim: int) -> torch.Tensor:
    """Slice ``index`` of ``n`` equal slices along ``dim`` of the group's
    sum of ``x`` (the partial sums of a row-parallel product under
    sequence parallelism); the gradient is gathered over the group.  gloo
    has no reduce-scatter: this is an all-reduce followed by a narrow."""
    return _ReduceScatter.apply(x, group, index, n, dim)


def sum_int(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of the int32 ``x`` as an int32 accumulator holds
    it: summed in int64 and narrowed mod 2^32 on purpose (a K-split
    integer product then equals the one-rank product, wrap included;
    gloo's own int32 arithmetic is not relied on).  Tagged
    :data:`TAG_SUM_INT`."""
    with tag(TAG_SUM_INT):
        return wrap_int32(all_reduce(x.to(torch.int64), "sum", group))


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, dim):
        ctx.group, ctx.index, ctx.dim, ctx.size = group, index, dim, \
            x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.group).narrow(
            ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None


def gather_channels(x: torch.Tensor, group, index: int,
                    dim: int = -1) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` (:func:`all_gather`),
    where each rank then computes only its own part of what follows from
    the whole (the RG-LRU gates' outputs, a norm's rows): the gradient is
    summed over the group and this rank's slice (``index``) kept, the
    adjoint of :func:`reduce_scatter`."""
    return _GatherChannels.apply(x, group, index, dim % x.ndim)


class _CopyInColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group, lo, hi):
        ctx.group, ctx.lo, ctx.hi = group, lo, hi
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        g[..., ctx.lo:ctx.hi] = all_reduce(g[..., ctx.lo:ctx.hi], "sum",
                                           ctx.group)
        return g, None, None, None


def copy_in_columns(w: torch.Tensor, group, lo: int, hi: int
                    ) -> torch.Tensor:
    """``w`` itself, whose gradient's columns ``[lo, hi)`` (last dim) are
    summed over the group: the columns of a rank's weight slice that every
    rank holds alike and uses for its own part (Mamba-2's B and C
    projections beside a rank's heads)."""
    return _CopyInColumns.apply(w, group, lo, hi)
