"""Checkpointing: atomic step directories, async writer, resume.

The port of ``repro/checkpoint/manager.py``, in its file format: one
``.npz`` per tree ("segment"), each leaf under the reference's key
string — ``"/".join`` of its JAX key path: ``['embed']`` for a dict key,
``[0]`` for a list index, ``.q`` / ``.scale`` / ``.planes`` / ``.stack``
/ ``.k`` for the fields of the records and caches (None fields have no
key) — plus a JSON manifest.  Files cross between the two packages in
both directions.

Two leaves are stored in the reference's form rather than the port's:

* a :class:`~repro_torch.core.quant.PlaneOperands` stack is written
  raw-digit and row-major (the reference's default layout, its
  ``plane_shifted=False``); loading converts it exactly into the
  template's layout (pre-shifted, K-major for the port's weight caches);
* a bf16 tensor is written as f32 (exact; numpy has no bf16) and cast
  back to the template's dtype on load.

Writes go to ``step_XXXXXXXX.tmp`` and are renamed atomically; a
``latest`` file points at the newest complete step, so a crash mid-write
never corrupts the restore point.  One process writes one file set
(``proc0``): the multi-host namespacing of the reference keeps its names.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.quant import PlaneOperands
from repro_torch.device import resolve_device

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]


def _children(node) -> list[tuple[str, Any]] | None:
    """``(key, child)`` pairs of an interior node in JAX's flattening
    order (dict keys sorted, None fields skipped), None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # NamedTuple
        return [(f".{f}", getattr(node, f)) for f in node._fields
                if getattr(node, f) is not None]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, PlaneOperands):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)
                if getattr(node, f.name) is not None]
    return None


def _leaves(tree, prefix: tuple[str, ...] = ()):
    """``(key string, leaf)`` of every leaf; a PlaneOperands is one leaf
    (its stack, under ``.stack``)."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        if isinstance(tree, PlaneOperands):
            prefix = (*prefix, ".stack")
        yield "/".join(prefix), tree
        return
    for k, child in kids:
        yield from _leaves(child, (*prefix, k))


def _host(leaf) -> np.ndarray:
    """A leaf as the reference stores it (see the module docstring)."""
    if isinstance(leaf, PlaneOperands):
        leaf = leaf.with_layout(False).stack
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        # a copy also on the CPU: the caller may write its tensors in
        # place while an async writer still holds this array
        return t.to("cpu", copy=True).contiguous().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> dict[str, np.ndarray]:
    """The whole tree on the host, keyed as the reference keys it."""
    return {key: _host(leaf) for key, leaf in _leaves(tree)}


def save_pytree(tree, path: str):
    np.savez(path, **_flatten_with_paths(tree))


def _rebuild(template, fn: Callable, prefix: tuple[str, ...] = ()):
    """``template`` with every leaf replaced by ``fn(key, leaf)``."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        key = (*prefix, ".stack") if isinstance(template, PlaneOperands) \
            else prefix
        return fn("/".join(key), template)
    new = {k: _rebuild(c, fn, (*prefix, k)) for k, c in kids}
    if isinstance(template, dict):
        return {k: new[f"[{k!r}]"] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(new.get(f".{f}") for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(new[f"[{i}]"] for i in range(len(template)))
    return dataclasses.replace(template, **{
        f.name: new[f".{f.name}"] for f in dataclasses.fields(template)
        if f".{f.name}" in new})


def _is_k_major(stack: torch.Tensor, axis: int) -> bool:
    return stack.ndim > 1 and stack.stride(axis) == 1 \
        and stack.shape[axis] > 1


def _load_leaf(arr: np.ndarray, tpl, dev: torch.device):
    """One stored array into the template leaf's dtype and layout on
    ``dev``."""
    if isinstance(tpl, PlaneOperands):
        raw = dataclasses.replace(
            tpl, stack=torch.from_numpy(np.ascontiguousarray(arr)).to(dev),
            shifted=False).with_layout(tpl.shifted)
        ax = tpl.axis % tpl.stack.ndim
        st = raw.stack.to(tpl.stack.dtype)
        if _is_k_major(tpl.stack, ax):  # the template's memory layout
            st = st.movedim(ax, -1).contiguous().movedim(-1, ax)
        return dataclasses.replace(raw, stack=st)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(dev, tpl.dtype if isinstance(tpl, torch.Tensor)
                else t.dtype)


def load_pytree(template, path: str, device: str | torch.device | None = None):
    """Restore into the structure of ``template`` (shapes must match; its
    tensors may lie on any device, ``meta`` included) on ``device``
    (CUDA unless given; raises without it)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        def fn(key, leaf):
            arr = data[key]
            shape = tuple((leaf.stack if isinstance(leaf, PlaneOperands)
                           else leaf).shape)
            assert arr.shape == shape, (key, arr.shape, shape)
            return _load_leaf(arr, leaf, dev)

        return _rebuild(template, fn)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True,
                 process_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self.proc = process_index
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ---------- paths ----------
    def _step_dir(self, step: int, tmp: bool = False) -> str:
        return os.path.join(self.dir,
                            f"step_{step:08d}" + (".tmp" if tmp else ""))

    def latest_step(self) -> int | None:
        f = os.path.join(self.dir, "latest")
        if not os.path.exists(f):
            return None
        with open(f) as fh:
            return int(fh.read().strip())

    # ---------- save ----------
    def _write(self, step: int, flats: dict[str, dict], extra: dict):
        try:
            tmp = self._step_dir(step, tmp=True)
            os.makedirs(tmp, exist_ok=True)
            for name, flat in flats.items():
                np.savez(os.path.join(tmp, f"{name}.proc{self.proc}.npz"),
                         **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as fh:
                json.dump({"step": step, "time": time.time(), **extra}, fh)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            with open(os.path.join(self.dir, "latest.tmp"), "w") as fh:
                fh.write(str(step))
            os.replace(os.path.join(self.dir, "latest.tmp"),
                       os.path.join(self.dir, "latest"))
            self._gc()
        except Exception as e:  # surfaced on the next wait()/save()
            self._error = e

    def save(self, step: int, trees: dict[str, Any],
             extra: dict | None = None, block: bool = False):
        """trees: ``{"params": ..., "opt": ..., ...}``, one file each."""
        self.wait()
        # device -> host here, synchronously: the caller may update its
        # tensors in place while the writer thread runs
        flats = {name: _flatten_with_paths(t) for name, t in trees.items()}
        extra = extra or {}
        if self.async_write and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, flats, extra), daemon=True)
            self._thread.start()
        else:
            self._write(step, flats, extra)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---------- restore ----------
    def restore(self, step: int, templates: dict[str, Any],
                device: str | torch.device | None = None) -> dict[str, Any]:
        d = self._step_dir(step)
        return {name: load_pytree(
            tpl, os.path.join(d, f"{name}.proc{self.proc}.npz"), device)
            for name, tpl in templates.items()}

    def restore_latest(self, templates: dict[str, Any],
                       device: str | torch.device | None = None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, templates, device)

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as fh:
            return json.load(fh)
