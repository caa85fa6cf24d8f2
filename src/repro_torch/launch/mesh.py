"""Meshes over ``torch.distributed`` and a local launcher for their ranks.

The port of ``repro/launch/mesh.py``.  A :class:`Mesh` names its axes
and their sizes (``shape``, ``axis_names``, as the reference's mesh) and,
on a running process group, knows this rank's coordinate on each axis
and holds one process group per set of axes.  Ranks lie on the mesh in
row-major order: rank = data_index * model + model_index.

:func:`spawn_local` starts the ranks of a group on this host (in place
of the reference's virtual-device environment): each rank initialises
the group with an explicit timeout, runs a function and returns its
result to the parent, and a rank that raises, dies or outlives the
deadline makes the parent raise.
"""

from __future__ import annotations

import itertools
import math
import multiprocessing as mp
import pickle
import queue
import socket
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.sharding import ctx

__all__ = ["Mesh", "make_shape_mesh", "make_production_mesh",
           "make_local_mesh", "install_local_mesh", "spawn_local",
           "TIMEOUT_S"]

#: seconds a collective waits for another rank before it raises
TIMEOUT_S = 300.0


class Mesh:
    """Named axes over the ranks of a process group.

    ``shape`` maps axis name -> size in axis order; ``rank`` is this
    process's rank (None for a mesh of shapes only, such as the
    production meshes); ``groups`` maps each tuple of axis names (in
    axis order) to the process group of the ranks that share this rank's
    coordinates on every other axis.
    """

    def __init__(self, shape: dict[str, int], rank: int | None = None,
                 groups: dict | None = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self._groups = groups or {}
        if self._groups:
            from repro_torch.sharding.collectives import name_groups
            name_groups(self._groups)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def _names(self, axes) -> tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in names)

    def coords(self, rank: int | None = None) -> dict[str, int]:
        """This rank's index on each axis (or ``rank``'s: ranks lie on the
        mesh in row-major order)."""
        if rank is None and self.rank is None:
            raise ValueError(f"{self!r} is a mesh of shapes only: it has "
                             f"no rank")
        out, r = {}, self.rank if rank is None else rank
        for name in reversed(self.axis_names):
            r, out[name] = divmod(r, self.shape[name])
        return {a: out[a] for a in self.axis_names}

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (a name or a tuple
        of names): its group rank in :meth:`group` (axes)."""
        c = self.coords()
        idx = 0
        for a in self._names(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, axes):
        """The process group of ``axes`` (a name or a tuple of names)
        that holds this rank."""
        key = self._names(axes)
        if key not in self._groups:
            raise ValueError(f"{self!r} has no process group over {key}")
        return self._groups[key]


def make_shape_mesh(shape: dict[str, int], rank: int = 0) -> Mesh:
    """A mesh of shapes only seen from ``rank``: it has that rank's
    coordinates, and one sharding/collectives.py:ShapeGroup (axis names
    and size, no process group) per set of axes.  Collectives over it run
    on ``meta`` tensors only (launch/dryrun.py)."""
    from repro_torch.sharding.collectives import ShapeGroup

    names = tuple(shape)
    world = math.prod(shape.values())
    groups = {sub: ShapeGroup(sub, math.prod(shape[a] for a in sub),
                              world // math.prod(shape[a] for a in sub))
              for n in range(1, len(names) + 1)
              for sub in itertools.combinations(names, n)}
    return Mesh(shape, rank=rank, groups=groups)


def make_production_mesh(*, multi_pod: bool = False,
                         rank: int | None = None) -> Mesh:
    """The reference's production shapes, as a mesh of shapes only:
    (data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``; seen from ``rank`` (:func:`make_shape_mesh`) where it
    is given, else with no rank."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}
    if rank is not None:
        return make_shape_mesh(shape, rank)
    return Mesh(shape)


def _subset_groups(shape: dict[str, int], timeout: timedelta) -> dict:
    """One process group per non-empty set of axes, made collectively by
    every rank in the same order; returns this rank's group per set."""
    names, sizes = tuple(shape), tuple(shape.values())
    rank = dist.get_rank()
    coords = list(itertools.product(*(range(s) for s in sizes)))
    out = {}
    for n in range(1, len(names) + 1):
        for subset in itertools.combinations(range(len(names)), n):
            classes: dict[tuple, list[int]] = {}
            for r, c in enumerate(coords):  # row-major: r is the rank
                rest = tuple(c[i] for i in range(len(names))
                             if i not in subset)
                classes.setdefault(rest, []).append(r)
            for ranks in classes.values():
                pg = dist.new_group(ranks, timeout=timeout)
                if rank in ranks:
                    out[tuple(names[i] for i in subset)] = pg
    return out


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh over the initialised default process group,
    whose world size must be data * model; its groups time out after
    TIMEOUT_S, as :func:`spawn_local`'s.  A one-rank mesh needs no
    process group."""
    shape = {"data": data, "model": model}
    if data * model == 1 and not dist.is_initialized():
        return Mesh(shape, rank=0)
    if not dist.is_initialized():
        raise RuntimeError(f"make_local_mesh({data}, {model}): initialise "
                           f"a process group of {data * model} ranks first "
                           f"(spawn_local)")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the process group has {world}")
    return Mesh(shape, rank=dist.get_rank(),
                groups=_subset_groups(shape, timedelta(seconds=TIMEOUT_S)))


def install_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """:func:`make_local_mesh` installed as the module mesh
    (sharding/ctx.py), so the serving stack routes through it; returns
    the mesh (``ctx.set_mesh(None)`` uninstalls)."""
    mesh = make_local_mesh(data, model)
    ctx.set_mesh(mesh)
    return mesh


# ------------------------------------------------------------ launcher
def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str,
               threads: int | None, work, results) -> None:
    """One rank: take ``(fn, args)`` from ``work``, join the group, run
    ``fn(*args)``, send back its result or its traceback."""
    try:
        fn, args = pickle.loads(work.get())
        if threads is not None:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=TIMEOUT_S))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which raises
        results.put(("error", rank, traceback.format_exc()))


def spawn_local(world: int, fn, *args, backend: str = "gloo",
                deadline_s: float | None = None,
                threads: int | None = None) -> list:
    """Run ``fn(*args)`` on ``world`` new ranks of one process group on
    this host; returns the results by rank.

    ``fn`` and ``args`` are pickled (``fn`` by import path).  Each rank
    initialises ``backend`` over a free localhost port with a TIMEOUT_S
    timeout on every collective, and with ``threads`` set, that many
    intra-op threads.  A rank that raises (a collective another rank
    never reaches raises after the timeout), exits without a result, or
    is still running ``deadline_s`` seconds after the start makes this
    raise; every rank is stopped before it returns.
    """
    mpc = mp.get_context("spawn")
    # the work goes by queue (a process's own arguments are written to it
    # at its start, which blocks until it has read them all), pickled to
    # bytes both ways: the queue would pass a tensor's storage by a file
    # descriptor that dies with the process that sent it
    work, results = mpc.Queue(), mpc.Queue()
    port = _free_port()
    procs = [mpc.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, backend, threads, work,
                               results))
             for r in range(world)]
    out: dict[int, object] = {}
    gone: dict[int, float] = {}  # rank -> when it was first seen exited
    t_end = None if deadline_s is None else time.monotonic() + deadline_s
    try:
        for p in procs:
            p.start()
        job = pickle.dumps((fn, args))
        for _ in procs:
            work.put(job)
        while len(out) < world:
            try:
                kind, rank, payload = results.get(timeout=0.5)
            except queue.Empty:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if r in out or p.exitcode is None:
                        continue
                    # a rank that exited cleanly has its result in flight
                    if p.exitcode != 0 or now - gone.setdefault(r, now) > 5:
                        raise RuntimeError(f"rank {r} of {world} exited "
                                           f"with code {p.exitcode} and no "
                                           f"result")
                if t_end is not None and now > t_end:
                    late = sorted(set(range(world)) - set(out))
                    raise TimeoutError(f"spawn_local: ranks {late} still "
                                       f"running after {deadline_s} s")
                continue
            if kind == "error":
                raise RuntimeError(f"rank {rank} of {world} raised:\n"
                                   f"{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
