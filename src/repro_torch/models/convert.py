"""Reference param trees -> port params, by value.

The port cannot reproduce ``jax.random``, so a model built by the
reference crosses as numpy arrays and keeps its keys and layouts: both
packages then compute the same function.  VGG-16
(``materialize(vgg16_build(...), key)``, a tree of ``{"w", "b"}`` per
layer with HWIO conv weights) crosses with :func:`params_from_jax`; an
LM (``materialize(lm_build(cfg), key)``: nested dicts, the ``prefix`` and
``suffix`` lists and the ``stack`` leaves with their leading ``layers``
axis) with :func:`lm_params_from_jax`.  ``.npz`` trees saved by the
reference's checkpoint manager load the same way.  The optimizer's
``OptState`` and the error-feedback ``EFState`` cross with
:func:`opt_state_from_jax` and :func:`ef_state_from_jax`, so both
packages can train on from one state; given a ZeRO-1 layout
(optim/adamw.py:Zero1) they keep this rank's slices, and
:func:`gather_opt_state` / :func:`gather_ef_state` make the whole state
again from every rank's.  A rank's slices of a crossed tree
(sharding/axes.py:held_layouts), and the whole tree again, are
sharding/axes.py's ``shard_params`` and ``gather_params``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.optim.adamw import OptState
from repro_torch.optim.compression import EFState

__all__ = ["params_from_jax", "lm_params_from_jax", "opt_state_from_jax",
           "ef_state_from_jax", "gather_opt_state", "gather_ef_state"]


def params_from_jax(tree: dict, device: str | torch.device | None = None
                    ) -> dict:
    """``{layer: {"w": array, "b": array}}`` of numpy (or array-like)
    leaves -> the same tree of f32 tensors on ``device``."""
    return lm_params_from_jax(
        {name: {k: np.asarray(v, np.float32) for k, v in leaf.items()}
         for name, leaf in tree.items()}, device)


def _tensor(x, dev: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native bf16
        return torch.from_numpy(a.astype(np.float32)).to(
            dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def lm_params_from_jax(tree, device: str | torch.device | None = None):
    """A reference LM param tree of numpy (or array-like) leaves -> the
    same tree (same keys, list order and layouts, same dtypes) of
    tensors on ``device``."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return _tensor(t, dev)

    return walk(tree)


def _local(tree, zero):
    """This rank's ZeRO-1 slice of every whole leaf (copies), or ``tree``
    itself."""
    if zero is None:
        return tree
    return tree_unflatten(tree, [x.clone() for x in zero.from_whole(tree)])


def opt_state_from_jax(state, device: str | torch.device | None = None,
                       zero=None):
    """A reference ``OptState`` (step, m, v) -> the port's
    :class:`~repro_torch.optim.adamw.OptState` of tensors on ``device``;
    with ``zero`` (optim/adamw.py:Zero1) m and v are this rank's
    slices."""
    dev = resolve_device(device)
    return OptState(step=_tensor(state.step, dev),
                    m=_local(lm_params_from_jax(state.m, dev), zero),
                    v=_local(lm_params_from_jax(state.v, dev), zero))


def ef_state_from_jax(state, device: str | torch.device | None = None,
                      zero=None):
    """A reference ``EFState`` -> the port's
    :class:`~repro_torch.optim.compression.EFState` on ``device``; with
    ``zero`` the residuals are this rank's slices."""
    return EFState(residual=_local(
        lm_params_from_jax(state.residual, device), zero))


def gather_opt_state(state: OptState, zero) -> OptState:
    """The whole :class:`OptState` from every rank's ZeRO-1 slices (every
    rank of ``zero``'s mesh calls this)."""
    return state._replace(**{k: tree_unflatten(
        getattr(state, k), zero.gather_whole(tree_leaves(getattr(state, k))))
        for k in ("m", "v")})


def gather_ef_state(state: EFState, zero) -> EFState:
    """The whole :class:`EFState` from every rank's slices."""
    return EFState(residual=tree_unflatten(
        state.residual, zero.gather_whole(tree_leaves(state.residual))))

