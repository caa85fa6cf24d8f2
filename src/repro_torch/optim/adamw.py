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
update takes the (summed) gradients of the params as the ranks hold them,
clips them by their global norm as without a mesh, updates this rank's
slice of each parameter and all-gathers the slices back to the held
params.  With the backbone replicated every rank holds the whole params
and the gather runs over the whole mesh; with it split over ``model``
(``shard_params``) a rank holds its slice (sharding/axes.py:held_layouts),
its ZeRO-1 slice is that slice's part over "data", and the gather runs
over the data group.  The update is
elementwise, so the gathered parameters and moments equal a whole-leaf
update of the same gradients (and grad norm) bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding.axes import (cut_leaf, held_layouts, local_slice,
                                       slice_index, zero1_spec)
from repro_torch.sharding.collectives import all_reduce, gather_slices

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
    shape per leaf of the param tree, in ``tree_leaves`` order, and the
    layout the params are held under (``held``: sharding/axes.py:
    held_layouts for a backbone split over ``model``, None for whole
    params)."""

    mesh: Any
    specs: tuple
    shapes: tuple
    held: tuple | None = None

    @classmethod
    def build(cls, cfg, mesh, split: bool = False) -> "Zero1":
        """For ``cfg``'s param tree (``lm_build`` / ``encdec_build``);
        ``split``: the params are held as ``held_layouts`` says."""
        from repro_torch.sharding.axes import _desc

        leaves = tree_leaves(_desc(cfg, None))
        held = tuple(held_layouts(cfg, mesh)) if split else None
        return cls(mesh, tuple(zero1_spec(p, mesh) for p in leaves),
                   tuple(tuple(p.shape) for p in leaves), held)

    def _sub(self, i: int) -> tuple:
        """Leaf ``i``'s ZeRO-1 spec within its held slice: the dims the
        held layout leaves whole keep their data axes (a "model" the
        layout does not split is dropped: the rank holds those dims
        whole)."""
        if self.held is None:
            return self.specs[i]
        held = tuple(self.held[i].spec) + (None,) * len(self.shapes[i])
        return tuple(None if h is not None or z is None else
                     (tuple(a for a in ((z,) if isinstance(z, str) else z)
                            if a != "model") or None)
                     for z, h in zip(self.specs[i], held))

    def _held_shape(self, i: int) -> tuple:
        if self.held is None:
            return self.shapes[i]
        idx = self.held[i].index(self.mesh.coords())
        return tuple(len(s) if isinstance(s, torch.Tensor)
                     else len(range(*s.indices(n)))
                     for s, n in zip(idx + (slice(None),) * len(
                         self.shapes[i]), self.shapes[i]))

    def local(self, tree) -> list:
        """This rank's slice of each leaf of ``tree`` held as the params
        are (views)."""
        return [local_slice(x, self._sub(i), self.mesh)
                for i, x in enumerate(tree_leaves(tree))]

    def gather(self, parts: list) -> list:
        """The held leaves from the ranks' slices (one all-gather per
        dtype over the whole mesh, or over the data group when the params
        are split over ``model``)."""
        shapes = [self._held_shape(i) for i in range(len(parts))]
        return gather_slices(parts, [slice_index(sh, self._sub(i), self.mesh)
                                     for i, sh in enumerate(shapes)],
                             shapes, self.mesh,
                             None if self.held is None else ("data",))

    def from_whole(self, tree) -> list:
        """This rank's ZeRO-1 slice of each whole leaf of ``tree``:
        models/convert.py's crossing of a whole state."""
        leaves = tree_leaves(tree)
        if self.held is not None:
            leaves = [cut_leaf(x, lay, self.mesh)
                      for x, lay in zip(leaves, self.held)]
        return [local_slice(x, self._sub(i), self.mesh)
                for i, x in enumerate(leaves)]

    def gather_whole(self, parts: list) -> list:
        """The whole leaves from every rank's ZeRO-1 slices (all-gathers
        over the mesh, or over the data group and then the model group
        when the params are split, one per dtype)."""
        if self.held is None:
            return gather_slices(
                parts, [slice_index(sh, sp, self.mesh) for
                        sh, sp in zip(self.shapes, self.specs)],
                list(self.shapes), self.mesh)
        return gather_slices(self.gather(parts),
                             [lay.index for lay in self.held],
                             list(self.shapes), self.mesh, ("model",))

    def global_norm(self, grads) -> torch.Tensor:
        """The global norm of gradients held as the params are, each
        element counted once: a leaf split over ``model`` adds its
        ranks' sums of squares (one all-reduce over the model group)."""
        split = [i for i in range(len(self.shapes)) if self.held is not None
                 and "model" in self.held[i].spec
                 and self.mesh.shape.get("model", 1) > 1]
        sums = []
        for i, x in enumerate(tree_leaves(grads)):
            sq = torch.square(x.to(_F32))
            shared = self.held[i].shared if i in split else None
            if shared is not None and self.mesh.index("model"):
                # columns every model rank holds alike: rank 0 counts them
                sq = torch.cat([sq[..., :shared[0]], sq[..., shared[1]:]],
                               -1)
            sums.append(torch.sum(sq))
        if split:
            tot = all_reduce(torch.stack([sums[i] for i in split]), "sum",
                             self.mesh.group("model"))
            for i, t in zip(split, tot):
                sums[i] = t
        return torch.sqrt(torch.sum(torch.stack(sums)))


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
    state holds this rank's slices, ``grads`` and ``params`` are held as
    ``zero`` says (whole, or the rank's ``shard_params`` slices; the same
    on every rank that holds them), and so are the new params."""
    if zero is not None:
        gnorm = zero.global_norm(grads)
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
