"""Sync-cost certificate of the sharded level walks.

The port of ``repro/analysis/collective_cost.py``.  The sharding audit
(analysis/sharding.py) verifies WHAT a split run reduces; this module
prices it.  From a verified schedule — one :class:`CollectiveRecord`
per collective of one walk — and the mesh, it gives a per-(entry x
mesh) **sync-cost certificate**:

* static and per-walk collective counts (per-level records fire once
  per level of the stream, per-walk records once),
* bytes on the wire per rank under the ring model (an all-reduce moves
  ``2 (n-1)/n * S`` for a group of n, :func:`ring_wire_bytes`),
* the projected **sync-every-k** table for k in {1, 2, 4, 8}: reducing
  every k-th level drops the per-walk sync count from ``n_levels`` to
  ``ceil(n_levels / k)`` firings of the per-level schedule.

Time is priced with a DATA-SHEET MODEL, not a measurement: the H100 SXM
data sheet's NVLink 4 figure, 900 GB/s of bidirectional bandwidth a GPU
(:data:`NVLINK_BYTES_PER_S`, 450 GB/s each way, from launch/roofline.py,
the one home of the card's constants).  The port's meshes run host-staged
gloo ranks on one card, which this model does not describe.  Given the
records of the entry's captured step (launch/graph_analysis.py, the
counterpart of the reference's ``hlo_text``), the certificate also
carries the roofline terms of that graph with the verified schedule's
wire bytes, and the collective share of their serial sum.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch.roofline import NVLINK_BYTES_PER_S

__all__ = ["CollectiveRecord", "sync_cost_certificate", "ring_wire_bytes",
           "prim_of", "from_records", "NVLINK_BYTES_PER_S"]



def ring_wire_bytes(kind: str, size: float, n: int) -> float:
    """Standard ring-model bytes on the wire per rank for a collective of
    result size ``size`` over a group of ``n`` (a copy of the reference's
    ``launch/hlo_analysis.py:ring_wire_bytes``); a group of 1 moves
    nothing."""
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return (n - 1) / n * size
    if kind == "reduce-scatter":
        return (n - 1) * size
    if kind == "all-reduce":
        return 2 * (n - 1) / n * size
    if kind == "all-to-all":
        return (n - 1) / n * size
    return size  # collective-permute


_KINDS = {"psum": "all-reduce", "pmax": "all-reduce", "pmin": "all-reduce",
          "all_gather": "all-gather", "all_to_all": "all-to-all"}


def prim_of(r) -> str:
    """A sharding/collectives.py record's primitive in the reference's
    names: ``pmax`` / ``pmin`` / ``psum`` for an all-reduce, else the
    op."""
    if r.op == "all_reduce":
        return {"max": "pmax", "min": "pmin", "sum": "psum"}[r.reduce_op]
    return r.op


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective of a walk, in the reference's terms.

    ``prim`` is ``psum`` / ``pmax`` / ``pmin`` (an all-reduce and its
    reduce op) or ``all_gather`` / ``all_to_all``; ``axes`` the mesh
    axes of its group; ``shape`` this rank's operand shape; ``in_loop``
    separates the per-level schedule from the per-walk one; ``tag`` is
    the ``l2r_coll_*`` tag; ``taint`` the operand's exactness taint
    (``"int"`` / ``"f32exact"`` / ``"deq"`` / None)."""

    prim: str
    axes: tuple
    dtype: str
    shape: tuple
    in_loop: bool
    tag: str = ""
    taint: str | None = None

    def result_bytes(self) -> float:
        n = 1
        for d in self.shape:
            n *= int(d)
        return float(n) * getattr(torch, self.dtype).itemsize

    def wire_bytes(self, axis_sizes: dict) -> float:
        """Ring bytes on the wire per rank for this collective over its
        mesh axes."""
        group = 1
        for a in self.axes:
            group *= int(axis_sizes.get(a, 1))
        return ring_wire_bytes(_KINDS.get(self.prim, "all-reduce"),
                               self.result_bytes(), group)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["axes"] = list(self.axes)
        d["shape"] = [int(x) for x in self.shape]
        return d


def from_records(records: list) -> list[CollectiveRecord]:
    """The :class:`CollectiveRecord` of each of sharding/collectives.py's
    records (its bytes as a flat shape)."""
    out = []
    for r in records:
        size = getattr(torch, r.dtype).itemsize
        out.append(CollectiveRecord(
            prim=prim_of(r), axes=tuple(a for a in r.group.split(",") if a),
            dtype=r.dtype, shape=(r.nbytes // size,), in_loop=r.in_loop,
            tag=r.tag, taint=r.taint))
    return out


def _bucket(records: list, axis_sizes: dict) -> dict:
    by: dict[str, int] = {}
    for r in records:
        key = f"{r.prim}[{r.tag or 'untagged'}]"
        by[key] = by.get(key, 0) + 1
    return {
        "count": len(records),
        "wire_bytes": sum(r.wire_bytes(axis_sizes) for r in records),
        "by_reduction": by,
    }


def sync_cost_certificate(records: list, mesh_axes: tuple, n_levels: int,
                          *, ks: tuple = (1, 2, 4, 8),
                          graph: list | None = None) -> dict:
    """Fold a verified schedule into the per-(entry x mesh) certificate.

    ``records`` are the :class:`CollectiveRecord` s of one walk with its
    per-level collectives once (one level's), ``mesh_axes`` the
    contract's ``(name, size)`` pairs, ``n_levels`` the stream depth the
    per-level schedule fires at.  ``collective_s`` is the wire bytes over
    :data:`NVLINK_BYTES_PER_S` (a data-sheet model).  With ``graph`` (the
    entry's captured step, launch/graph_analysis.py:to_records) the
    certificate also carries ``roofline`` (the graph's FLOPs and bytes,
    the schedule's wire bytes: what the contract declares, not the
    graph's census) and ``collective_share``."""
    axis_sizes = dict(mesh_axes)
    chips = 1
    for _, s in mesh_axes:
        chips *= int(s)
    per_level = [r for r in records if r.in_loop]
    per_walk = [r for r in records if not r.in_loop]
    lvl = _bucket(per_level, axis_sizes)
    wlk = _bucket(per_walk, axis_sizes)

    def totals(sync_levels: int) -> tuple[int, float, float]:
        count = sync_levels * lvl["count"] + wlk["count"]
        wire = sync_levels * lvl["wire_bytes"] + wlk["wire_bytes"]
        return count, wire, wire / NVLINK_BYTES_PER_S

    count1, wire1, secs1 = totals(n_levels)
    cert = {
        "mesh": {a: int(s) for a, s in mesh_axes},
        "chips": chips,
        "n_levels": n_levels,
        "per_level": lvl,
        "per_walk": wlk,
        "collectives_per_walk": count1,
        "wire_bytes_per_walk": wire1,
        "collective_s": secs1,
        "collective_s_model": "H100 SXM data sheet NVLink, 450 GB/s each "
                              "way (not measured)",
        "sync_every_k": [],
    }
    for k in ks:
        sync_levels = math.ceil(n_levels / k)
        count, wire, secs = totals(sync_levels)
        cert["sync_every_k"].append({
            "k": int(k), "sync_levels": sync_levels,
            "collectives": count, "wire_bytes": wire, "collective_s": secs,
            "savings_frac": 0.0 if secs1 <= 0 else 1.0 - secs / secs1,
        })
    if graph is not None:
        from repro_torch.launch.graph_analysis import analyze
        from repro_torch.launch.roofline import roofline_terms

        ana = analyze(graph)
        rf = roofline_terms(ana["flops"], ana["bytes"], wire1, chips,
                            flops_by_peak=ana["flops_by_peak"])
        serial = rf.compute_s + rf.memory_s + rf.collective_s
        cert["roofline"] = rf.asdict()
        cert["collective_share"] = (rf.collective_s / serial
                                    if serial > 0 else 0.0)
    return cert
