"""The collectives of the sharded walk: one helper per operation, each
taking the process group.

gloo, the backend that runs several ranks on one card or on the CPU,
reduces host tensors: a CUDA tensor is copied to the host (a blocking
copy, which waits for the kernels that made it), reduced there and copied
back, explicitly.  A backend that takes device tensors (NCCL) gets them
as they are, with no synchronize.  Every call counts itself in
:data:`COUNTS`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["COUNTS", "reset", "all_reduce", "all_gather", "gather_columns"]

COUNTS = {"all_reduce": 0, "all_gather": 0}

_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "sum": dist.ReduceOp.SUM}


def reset() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _host_staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``x`` reduced elementwise over ``group`` with ``op`` ("max", "min"
    or "sum"), as a new tensor on ``x``'s device."""
    COUNTS["all_reduce"] += 1
    staged = _host_staged(x, group)
    y = x.cpu() if staged else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y.to(x.device) if staged else y


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order,
    on ``x``'s device."""
    COUNTS["all_gather"] += 1
    staged = _host_staged(x, group)
    y = x.contiguous().cpu() if staged else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
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
