"""AdamW + schedules + global-norm clipping on trees of tensors.

The port of ``repro/optim/adamw.py``.  Optimizer state mirrors the
params (m, v in f32) plus an int32 step counter; updates are functional
(new tensors, as the reference returns new arrays).  Every scalar of
the update is f32, as it is in JAX: the schedule, ``b1 ** step`` and
the bias corrections.  Leaves are walked in ``jax.tree.leaves`` order
(dict keys sorted, lists in order), so :func:`global_norm` stacks the
per-leaf sums as the reference does.

ZeRO-1 (:class:`Zero1`, the data-parallel train step): m and v hold this
rank's slice of every leaf under ``sharding/axes.py:zero1_specs``; the
update takes the whole (summed) gradients, clips them by their global
norm as without a mesh, updates this rank's slice of each parameter and
all-gathers the slices, so every rank holds the whole parameters.  The
update is elementwise, so the gathered parameters and moments equal a
whole-leaf update of the same gradients bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding.axes import local_slice, slice_index, zero1_spec
from repro_torch.sharding.collectives import gather_slices

__all__ = ["AdamWConfig", "OptState", "Zero1", "adamw_init", "adamw_update",
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


@dataclasses.dataclass(frozen=True)
class Zero1:
    """ZeRO-1's layout over ``mesh``: one ``zero1_specs`` spec and whole
    shape per leaf of the param tree, in ``tree_leaves`` order."""

    mesh: Any
    specs: tuple
    shapes: tuple

    @classmethod
    def build(cls, desc_tree, mesh) -> "Zero1":
        """From the Param descriptor tree (``lm_build`` / ``encdec_build``)."""
        leaves = tree_leaves(desc_tree)
        return cls(mesh, tuple(zero1_spec(p, mesh) for p in leaves),
                   tuple(tuple(p.shape) for p in leaves))

    def local(self, tree) -> list:
        """This rank's slice of each whole leaf of ``tree`` (views)."""
        return [local_slice(x, s, self.mesh)
                for x, s in zip(tree_leaves(tree), self.specs)]

    def gather(self, parts: list) -> list:
        """The whole leaves from every rank's slices (one all-gather over
        the mesh per dtype)."""
        return gather_slices(parts, [slice_index(sh, sp, self.mesh) for
                                     sh, sp in zip(self.shapes, self.specs)],
                             list(self.shapes), self.mesh)


def adamw_init(params, zero: Zero1 | None = None) -> OptState:
    """Zero moments in f32 on the params' device; with ``zero`` this
    rank's slice of each."""
    zeros = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)  # noqa: E731
    dev = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if zero is not None:
        return OptState(step=step, **{k: tree_unflatten(
            params, [zeros(x) for x in zero.local(params)]) for k in "mv"})
    return OptState(step=step, m=tree_map(zeros, params),
                    v=tree_map(zeros, params))


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


def _clip(norm: torch.Tensor, max_norm: float):
    scale = torch.minimum(_f32(1.0, norm),
                          _f32(max_norm, norm) / torch.clamp(norm, min=1e-9))
    return lambda x: (x.to(_F32) * scale).to(x.dtype)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    return tree_map(_clip(norm, max_norm), tree), norm


def adamw_update(cfg: AdamWConfig, grads, params, state: OptState,
                 zero: Zero1 | None = None):
    """Returns (new_params, new_state, metrics).  With ``zero`` the
    state holds this rank's slices, ``grads`` and ``params`` are whole
    (the same on every rank), and so are the new params."""
    if zero is not None:
        gnorm = global_norm(grads)
        clip = (_clip(gnorm, cfg.clip_norm) if cfg.clip_norm is not None
                else lambda x: x)
        grads = tree_unflatten(grads, [clip(g) for g in zero.local(grads)])
        whole, params = params, tree_unflatten(params, zero.local(params))
    elif cfg.clip_norm is not None:
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
    if zero is not None:
        new_p = tree_unflatten(whole, zero.gather([o[0] for o in flat]))
    return new_p, OptState(step=step, m=new_m, v=new_v), {
        "grad_norm": gnorm, "lr": lr}
