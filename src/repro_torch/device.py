"""The port's device rule and the float-precision pin.

Public entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  On a host without CUDA a call that names no device
raises: the port never carries on quietly on the CPU.  Kernel dispatch
below the entry points follows the device of the tensor it is given.

A ``meta`` tensor (shapes only: the dry run, launch/dryrun.py) takes the
card's path where the model code orders its arithmetic otherwise on the
card (:func:`card_path`: ``models/common.py``'s row means, whose split
form gathers other tensors there): the dry run describes the card.
:func:`meta_target` makes it take the CPU's instead, to hold a meta run
against a CPU run.  Kernel dispatch is not such a path: a kernel wrapper
launches only on a CUDA tensor, so a meta tensor takes the plain version
(and ``chunked_attention`` its plain loop).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "no_tf32", "card_path", "meta_target"]

#: the device whose paths a ``meta`` tensor takes (:func:`meta_target`)
_META_TARGET = ["cuda"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a :class:`torch.device` with an explicit card index;
    ``None`` means the current CUDA card, which must then exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and this host has no "
                "CUDA device; pass device='cpu' to run the plain versions "
                "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} asked for, but CUDA is "
                               f"not available on this host")
        if dev.index is None:  # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def no_tf32():
    """True-f32 matmuls and convolutions inside the block.

    cuDNN runs f32 convolutions in TF32 by default; every path that
    claims exactness (the guarded f32 digit dots) or serves as the float
    reference pins both switches off here and restores them after.
    """
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def card_path(x: torch.Tensor) -> bool:
    """Does the model code take its card path for ``x``: a CUDA tensor,
    or a ``meta`` tensor while the meta target is the card."""
    return x.is_cuda or (x.is_meta and _META_TARGET[-1] == "cuda")


@contextlib.contextmanager
def meta_target(device: str):
    """Within the block ``meta`` tensors take ``device``'s paths
    (``"cuda"``, the default, or ``"cpu"``)."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"meta_target({device!r}): cuda or cpu")
    _META_TARGET.append(device)
    try:
        yield
    finally:
        _META_TARGET.pop()
