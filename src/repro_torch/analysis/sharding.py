"""Collective-schedule audit of the split runs.

The port of ``repro/analysis/sharding.py``.  The reference lowers each
shard_mapped entry and lints the jaxpr's reductions and the partitioned
HLO.  The port splits by hand (no partitioner): every collective goes
through sharding/collectives.py, whose recorder gives the schedule as it
ran, and a rank's captured step holds the same collectives as graph
nodes (:func:`audit_partitioned_graph`).  The recorder gives them one
:class:`~repro_torch.sharding.collectives.Record` per call, with its
tag (:func:`~repro_torch.sharding.collectives.tag`, the reference's
``l2r_coll_*`` names), its group and whether it ran inside a level loop.
Per entry with a :class:`ShardingContract` the audit checks:

a) **the schedule** — inside each walk's level loop exactly the declared
   per-level collectives (by reduce op and tag) at every level, and
   outside it exactly the declared per-walk ones; or, for a whole-model
   run (``kinds``), the count of each kind of collective;
b) **no undeclared data movers** — an all-gather or all-to-all the
   contract does not declare (the walk reduces, it does not move plane
   stacks) is a violation;
c) **no float sums on plane-derived values** — with the exactness taint
   walk (analysis/exactness.py, with the ``"deq"`` provenance that keeps
   dequantized decision floats tracked) running, a float SUM over a
   tainted value is the reassociation class the reference guards
   against; without ``allow_float_psum`` any float SUM is (the
   reference's partitioned-module rule);
d) **the budget** — no more collectives than the contract allows.

The port's schedule is not the reference's.  The reference declares, a
level, 4 ``pmax`` + 1 ``pmin`` over ``model`` (plus a ``psum`` over the
data axes with early exit) and no gathers.  The port's consensus walk
(core/policy.py:head_walk_machinery) reduces a level two MAX and one MIN
over ``model`` (several rows stacked into one call), its early exit one
int32 SUM over the data axes, its finalize one MAX and one MIN, and it
gathers the logits (and the tokens and levels over the data axes) at the
end (core/progressive.py:sharded_walk_collectives counts the same).  The
port's contracts declare the port's schedule.

The reference's second pass, ``audit_partitioned_hlo``, reads the
partitioned module; its counterpart :func:`audit_partitioned_graph` reads
a rank's captured step (launch/graph_analysis.py), whose collectives are
nodes carrying the recorder's fields, with the reference's rules: a data
mover the contract does not declare, a float SUM all-reduce (unless
``allow_float_psum``), an all-reduce without a declared tag (where the
contract declares tags), and the count budget.

The reference's layout conformance (the compiled module's input
shardings) has no counterpart: a rank's operands are its own tensors,
and the walk raises where a cache holds another rank's slice.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable

import torch

from repro_torch.analysis import exactness
from repro_torch.analysis.collective_cost import (from_records, prim_of,
                                                  sync_cost_certificate)
from repro_torch.analysis.exactness import ExactnessContract, Violation
from repro_torch.sharding import collectives

__all__ = [
    "ReductionSpec",
    "ShardingContract",
    "ShardingReport",
    "audit_sharding",
    "audit_records",
    "audit_partitioned_graph",
    "audit_sharded_registry",
]

#: collectives that MOVE data between ranks: undeclared, a violation
DATA_MOVERS = ("all_gather", "all_to_all")


@dataclasses.dataclass(frozen=True)
class ReductionSpec:
    """One declared collective: primitive (``pmax`` / ``pmin`` /
    ``psum``, or ``all_gather`` / ``all_to_all``), multiplicity per
    scope (per level of a walk, or per walk), and its tag."""

    prim: str
    count: int = 1
    tag: str = ""


@dataclasses.dataclass(frozen=True)
class ShardingContract:
    """What a split entry promises about its collectives.

    ``mesh_axes`` is the mesh as ``(name, size)`` pairs; ``per_level`` /
    ``per_walk`` the exact schedule inside / outside a walk's level loop
    (a walk runs ``n_levels`` levels, or with ``early_exit`` between 1
    and ``n_levels``); ``kinds`` instead pins a whole-model run's count
    of each kind (``{"all_reduce": n, "all_gather": g, "all_to_all":
    a}``); ``max_collectives`` caps the total (None: the declared
    schedule's total); ``allow_float_psum`` permits float SUMs on values
    the taint walk does not mark (float training, a float model)."""

    mesh_axes: tuple
    per_level: tuple = ()
    per_walk: tuple = ()
    n_levels: int = 1
    early_exit: bool = False
    kinds: tuple | None = None
    max_collectives: int | None = None
    allow_float_psum: bool = False

    def declares(self, prim: str) -> bool:
        if self.kinds is not None:
            return dict(self.kinds).get(prim, 0) > 0
        return any(s.prim == prim for s in self.per_level + self.per_walk)


@dataclasses.dataclass
class ShardingReport:
    entry: str
    violations: list
    schedule: dict          # one level's and the walk's records
    collectives: dict       # census of the whole recorded run
    cost: dict | None = None
    #: what the audited run returned (not part of the JSON report)
    output: object = dataclasses.field(default=None, repr=False,
                                       compare=False)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        return {
            "entry": self.entry, "ok": self.ok,
            "schedule": self.schedule,
            "collectives": self.collectives,
            "cost": self.cost,
            "violations": [v.to_json() for v in self.violations],
        }


# ------------------------------------------------------ the taint walk
class _ScheduleAuditor(exactness._Auditor):
    """exactness' taint walk with the collectives recorded: each record
    carries its operand's taint.  Exactness verdicts are muted (they are
    the exactness pass's); dequantized floats keep ``"deq"``
    provenance, so a float sum of a dequantized product is seen."""

    def __init__(self, contract: ExactnessContract | None, entry: str):
        super().__init__(contract or ExactnessContract(), entry)
        self.recording = collectives.recording(taint=self.taint_of)

    def dequant_taint(self):
        return "deq"

    def flag(self, prim, reason, ins=(), outs=()):
        pass  # exactness rules are the exactness pass's job

    def context(self):
        return self.recording

    def op_taint(self, name, ins, in_t, outs, out):
        res = super().op_taint(name, ins, in_t, outs, out)
        if "deq" in in_t and "int" not in in_t and "f32exact" not in in_t:
            res = ["deq" if t is None and x.dtype.is_floating_point else t
                   for x, t in zip(outs, res)]
        return res


# ------------------------------------------------------------ the rules
def _levels(walk_recs: list, want: Counter) -> int | None:
    """The level count that makes a walk's per-level records ``want``
    times it, or None if none does."""
    got = Counter((prim_of(r), r.tag) for r in walk_recs)
    if not want:
        return None if got else 0
    key = next(iter(want))
    lv, rem = divmod(got[key], want[key])
    if rem or any(got[k] != want[k] * lv for k in set(got) | set(want)):
        return None
    return lv


def _untagged(key) -> str:
    prim, tag = key
    return f"{prim}[{tag or 'untagged'}]"


def _check_schedule(records: list, c: ShardingContract, entry: str,
                    out: list) -> tuple[int, int]:
    """The schedule rules (a); returns (levels run in all, walks)."""
    if c.kinds is not None:
        got, declared = Counter(r.op for r in records), dict(c.kinds)
        for kind in sorted(set(declared) | set(got)):
            n = declared.get(kind, 0)
            if got[kind] != n:
                out.append(Violation(
                    entry, kind, f"collective count mismatch: recorded "
                                 f"{got[kind]} x {kind}, declared {n}"))
        return 0, 0
    want = Counter()
    for s in c.per_level:
        want[(s.prim, s.tag)] += s.count
    walks: dict[int, list] = {}
    for r in records:
        if r.in_loop:
            walks.setdefault(r.walk, []).append(r)
    levels_run = 0
    for w, recs in sorted(walks.items()):
        lv = _levels(recs, want)
        ok = lv is not None and lv >= 1 and (
            lv <= c.n_levels if c.early_exit else lv == c.n_levels)
        if not ok:
            got = Counter((prim_of(r), r.tag) for r in recs)
            for key in sorted(set(got) | set(want)):
                reason = (f"per-level schedule mismatch: recorded "
                          f"{got[key]} x {_untagged(key)} in walk {w}, "
                          f"declared {want[key]} a level over "
                          f"{'1..' if c.early_exit else ''}{c.n_levels} "
                          f"levels")
                if not key[1]:
                    reason += " (a collective without a declared l2r_coll " \
                              "tag)"
                out.append(Violation(entry, key[0], reason,
                                     detail="scope=per-level"))
        else:
            levels_run += lv
    if want and not walks:
        out.append(Violation(entry, "schedule", "per-level schedule "
                             "mismatch: no collective ran inside a level "
                             "loop", detail="scope=per-level"))
    n_walks = max(len(walks), 1)
    want_w = Counter()
    for s in c.per_walk:
        want_w[(s.prim, s.tag)] += s.count * n_walks
    got_w = Counter((prim_of(r), r.tag) for r in records if not r.in_loop)
    for key in sorted(set(got_w) | set(want_w)):
        if got_w[key] != want_w[key]:
            reason = (f"per-walk schedule mismatch: recorded {got_w[key]} x "
                      f"{_untagged(key)}, declared {want_w[key]}")
            if not key[1]:
                reason += " (a collective without a declared l2r_coll tag)"
            out.append(Violation(entry, key[0], reason,
                                 detail="scope=per-walk"))
    return levels_run, n_walks


def audit_records(records: list, sharding: ShardingContract,
                  entry: str = "<records>", *,
                  with_cost: bool = True) -> ShardingReport:
    """Audit a recorded schedule (sharding/collectives.py's records of
    one entry's run, or hand-made ones) against ``sharding``."""
    violations: list[Violation] = []
    for r in records:
        prim = prim_of(r)
        if prim in DATA_MOVERS and not sharding.declares(prim):
            violations.append(Violation(
                entry, prim, f"cross-rank data mover `{prim}` that the "
                             f"contract does not declare: the walk's "
                             f"schedule reduces, it moves no plane stack",
                detail=f"group={r.group} tag={r.tag or 'untagged'}"))
        if r.op != "all_reduce" or r.reduce_op != "sum":
            continue
        floating = getattr(torch, r.dtype).is_floating_point
        if floating and r.taint is not None:
            violations.append(Violation(
                entry, prim, "float cross-rank sum over a plane-derived "
                             "value: the sum's order reassociates it (the "
                             "exact path reduces by max, min or an integer "
                             "sum)",
                detail=f"dtype={r.dtype} group={r.group} taint={r.taint}"))
        elif floating and not sharding.allow_float_psum:
            violations.append(Violation(
                entry, prim, f"float add all-reduce ({r.dtype}) on a "
                             f"claimed-exact run: partial sums are "
                             f"reassociated across ranks",
                detail=f"group={r.group} tag={r.tag or 'untagged'}"))
    levels_run, n_walks = _check_schedule(records, sharding, entry,
                                          violations)
    if sharding.max_collectives is not None:
        limit = sharding.max_collectives
    elif sharding.kinds is not None:
        limit = sum(n for _, n in sharding.kinds)
    else:
        limit = (levels_run * sum(s.count for s in sharding.per_level)
                 + n_walks * sum(s.count for s in sharding.per_walk))
    if len(records) > limit:
        violations.append(Violation(
            entry, "run", f"collective-count budget exceeded: {len(records)}"
                          f" collectives recorded, budget {limit}",
            detail=",".join(sorted({prim_of(r) for r in records}))))
    first = min((r.walk for r in records if r.in_loop), default=None)
    walk0 = [r for r in records if r.in_loop and r.walk == first]
    per_level = sum(s.count for s in sharding.per_level)
    one_level = walk0[:per_level] if per_level else walk0
    per_walk = [r for r in records if not r.in_loop][
        :sum(s.count for s in sharding.per_walk) or None]
    census = dict(Counter(r.op for r in records))
    cost = None
    if with_cost and sharding.kinds is None:
        cost = sync_cost_certificate(from_records(one_level + per_walk),
                                     sharding.mesh_axes, sharding.n_levels)
    return ShardingReport(
        entry=entry, violations=violations,
        schedule={"per_level": [r.to_json() for r in one_level],
                  "per_walk": [r.to_json() for r in per_walk],
                  "levels_run": levels_run, "walks": n_walks},
        collectives={"census": census, "records": len(records)},
        cost=cost)


def _budget(c: ShardingContract) -> int:
    """The static collective budget of a captured step: unrolled, each
    per-level collective appears once a level."""
    if c.max_collectives is not None:
        return c.max_collectives
    if c.kinds is not None:
        return sum(n for _, n in c.kinds)
    return (c.n_levels * sum(s.count for s in c.per_level)
            + sum(s.count for s in c.per_walk))


def audit_partitioned_graph(records: list, contract: ShardingContract,
                            entry: str = "<graph>") -> tuple[list, list]:
    """Check a rank's captured step (its records,
    launch/graph_analysis.py:to_records) against the contract: the
    counterpart of the reference's ``audit_partitioned_hlo``.  Returns
    ``(violations, collective_records)``.  The rules: a data mover
    (all-gather, all-to-all) the contract does not declare, a float
    ``add`` all-reduce (partial sums reassociated across ranks) unless
    ``allow_float_psum``, an all-reduce without one of the contract's
    declared tags (where it declares any: a collective the schedule never
    declared), and the static count budget."""
    from repro_torch.launch.graph_analysis import collective_records

    recs = collective_records(records)
    violations: list[Violation] = []
    tags = {s.tag for s in contract.per_level + contract.per_walk if s.tag}
    for r in recs:
        where = f"{r['computation']}::{r['name']}"
        if r["op"] in DATA_MOVERS and not contract.declares(r["op"]):
            violations.append(Violation(
                entry, r["op"], f"{r['kind']} in the captured step that "
                                f"the contract does not declare: a sharded "
                                f"operand is moved between ranks", where))
            continue
        if r["op"] != "all_reduce":
            continue
        if getattr(torch, r["dtype"]).is_floating_point \
                and r["reduce_op"] == "add" \
                and not contract.allow_float_psum:
            violations.append(Violation(
                entry, "all_reduce",
                f"float add all-reduce ({r['dtype']}): partial sums are "
                f"reassociated across ranks", where))
        elif tags and r["tag"] not in tags:
            violations.append(Violation(
                entry, "all_reduce",
                f"{r['dtype']} {r['reduce_op'] or '?'} all-reduce without "
                f"a declared l2r_coll tag: a collective the schedule never "
                f"declared (tag={r['tag'] or '<none>'!r})", where))
    budget = _budget(contract)
    if len(recs) > budget:
        violations.append(Violation(
            entry, "graph",
            f"collective-count budget exceeded: {len(recs)} collectives in "
            f"the captured step, budget {budget}",
            detail=",".join(sorted({r["kind"] for r in recs}))))
    return violations, recs


def audit_sharding(fn: Callable, args: tuple, sharding: ShardingContract,
                   contract: ExactnessContract | None = None,
                   entry: str = "", *,
                   with_cost: bool = True) -> ShardingReport:
    """Run ``fn(*args)`` once under the taint walk with the collectives
    recorded, and audit the schedule (:func:`audit_records`).  Every rank
    of the mesh calls it with the same arguments."""
    name = entry or getattr(fn, "__name__", "<fn>")
    aud = _ScheduleAuditor(contract, name)
    out = aud.run(fn, args)
    records = list(aud.recording.records)
    aud.keep.clear()
    rep = audit_records(records, sharding, name, with_cost=with_cost)
    rep.output = out
    return rep


def audit_sharded_registry(entries=None, *, allow_skips: bool = False,
                           with_cost: bool = True, device=None,
                           mesh=None) -> list[dict]:
    """Sweep every registered entry carrying a :class:`ShardingContract`
    on ``mesh`` (every rank of it calls this).

    A skipped entry (no mesh of its shape here) is a VIOLATION unless
    ``allow_skips``: a split entry must not pass unaudited."""
    from repro_torch.analysis import registry

    rows = []
    for e in (entries if entries is not None
              else registry.iter_entries(mesh=mesh)):
        if getattr(e, "sharding", None) is None:
            continue
        row: dict = {"entry": e.name, "tags": list(e.tags)}
        if e.skip:
            if allow_skips:
                row.update(status="skip", reason=e.skip)
            else:
                row.update(status="violation", ok=False, violations=[
                    Violation(
                        entry=e.name, primitive="registry",
                        reason=f"registered split entry SKIPPED ({e.skip}) "
                               "— the audit must not silently pass; run "
                               "the sharding pass (it spawns a 2 x 2 mesh) "
                               "or pass allow_skips explicitly").to_json()])
            rows.append(row)
            continue
        fn, args = e.build(device=device, mesh=mesh)
        rep = audit_sharding(fn, args, e.sharding, e.contract,
                             entry=e.name, with_cost=with_cost)
        row.update(status="ok" if rep.ok else "violation", **rep.to_json())
        rows.append(row)
    return rows
