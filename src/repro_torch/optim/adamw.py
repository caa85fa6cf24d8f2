"""AdamW + schedules + global-norm clipping on trees of tensors.

The port of ``repro/optim/adamw.py``.  Optimizer state mirrors the
params (m, v in f32) plus an int32 step counter; updates are functional
(new tensors, as the reference returns new arrays).  Every scalar of
the update is f32, as it is in JAX: the schedule, ``b1 ** step`` and
the bias corrections.  Leaves are walked in ``jax.tree.leaves`` order
(dict keys sorted, lists in order), so :func:`global_norm` stacks the
per-leaf sums as the reference does.  There is no mesh: the ZeRO-1
sharding of m and v is the multi-device slice's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm"]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any
    v: Any


def adamw_init(params) -> OptState:
    """Zero moments in f32 on the params' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)  # noqa: E731
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=_F32, device=like.device)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``: an f32
    scalar, computed in f32 in the reference's order."""
    s = step.to(_F32)
    warm = torch.minimum(s / _f32(max(cfg.warmup_steps, 1), s), _f32(1.0, s))
    t = torch.clamp((s - _f32(cfg.warmup_steps, s))
                    / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi, s) * t))
    return _f32(cfg.lr, s) * warm * (
        _f32(cfg.min_lr_ratio, s) + _f32(1 - cfg.min_lr_ratio, s) * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(_F32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.minimum(_f32(1.0, norm),
                          _f32(max_norm, norm) / torch.clamp(norm, min=1e-9))
    return tree_map(lambda x: (x.to(_F32) * scale).to(x.dtype), tree), norm


def adamw_update(cfg: AdamWConfig, grads, params, state: OptState):
    """Returns (new_params, new_state, metrics)."""
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    sf = step.to(_F32)
    b1c = 1 - torch.pow(_f32(cfg.b1, sf), sf)
    b2c = 1 - torch.pow(_f32(cfg.b2, sf), sf)

    def upd(g, p, m, v):
        g = g.to(_F32)
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m2 / b1c
        vhat = v2 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.to(_F32)
        p2 = p.to(_F32) - lr * delta
        return p2.to(p.dtype), m2, v2

    flat = [upd(g, p, m, v) for g, p, m, v in zip(
        tree_leaves(grads), tree_leaves(params), tree_leaves(state.m),
        tree_leaves(state.v))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in flat])
                           for i in range(3))
    return new_p, OptState(step=step, m=new_m, v=new_v), {
        "grad_norm": gnorm, "lr": lr}
