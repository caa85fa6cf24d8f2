"""Reference param trees -> port params, by value.

The port cannot reproduce ``jax.random``, so a model built by the
reference (``materialize(vgg16_build(...), key)``, a tree of
``{"w", "b"}`` per layer with HWIO conv weights) crosses as numpy arrays
and keeps its keys and layouts: both packages then compute the same
function.  ``.npz`` trees saved by the reference's checkpoint manager
load the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(tree: dict, device: str | torch.device | None = None
                    ) -> dict:
    """``{layer: {"w": array, "b": array}}`` of numpy (or array-like)
    leaves -> the same tree of f32 tensors on ``device``."""
    dev = resolve_device(device)
    return {name: {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
                   for k, v in leaf.items()}
            for name, leaf in tree.items()}
