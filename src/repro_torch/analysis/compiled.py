"""Serving-engine audits: in-place decode state, warmup coverage, no
prefill shapes past the buckets.

The port of ``repro/analysis/compiled.py``.  The reference audits three
facts of its compiled serving artifacts; each has a GPU meaning here:

* **donation becomes in-place state** — XLA's buffer donation is how the
  reference's decode step avoids copying its caches; the port's decode
  step writes the state tensors in place.  :func:`audit_batcher` runs
  one decode step and checks that every state leaf kept its storage
  (``data_ptr``); storage that moved means a copy per step (seeded by
  ``ContinuousBatcher(donate_state=False)``, which clones the state).
* **AOT coverage becomes warmup coverage** — every bucket the gateway
  can route to, and the decode step, must have run in
  ``ServingGateway.warmup`` (``warmup_s`` keeps each one's seconds), or
  the first request of that length pays the kernels' first-use costs on
  the serving thread.
* **the retrace budget becomes no shapes past the buckets** — the
  gateway and the batcher record the ``(rows, length)`` of every prefill
  they run (the gateway after its warmup); a length that is not a bucket
  means a prompt escaped the bucketing.  Bookkeeping only: no kernel,
  result or timing changes.

The reference's ``donation_report`` reads XLA's input-output alias map
from the compiled module.  Its counterpart here reads the decode step's
captured graph (launch/graph_analysis.py): :func:`donation_report` gives
the inputs an op writes in place (a mutated placeholder: the step updates
that buffer instead of copying it) and the outputs that are inputs
themselves (the alias map); :func:`decode_donation` captures a live
batcher's decode step as ``step()`` calls it and checks that every state
leaf is such a mutated input.  :func:`probe_donation` is the reference's
dynamic probe: one call, then each donated argument's tensors must come
back in the output on the same storage.
"""

from __future__ import annotations

from repro_torch.analysis.exactness import tensors_of

__all__ = ["audit_gateway", "audit_batcher", "donation_report",
           "decode_donation", "probe_donation"]


def donation_report(records: list[dict]) -> dict:
    """Which inputs of a captured graph (its records,
    launch/graph_analysis.py:to_records) the step updates in place, and
    which outputs are inputs: ``{"n_aliases", "aliased_params",
    "aliases", "mutated_params"}``."""
    from repro_torch.launch import graph_analysis as ga

    aliases = ga.output_aliases(records)
    return {"n_aliases": len(aliases),
            "aliased_params": sorted({a["param"] for a in aliases}),
            "aliases": aliases,
            "mutated_params": ga.written_inputs(records)}


def decode_donation(b, entry: str = "batcher") -> dict:
    """The decode step of the live ContinuousBatcher ``b`` captured as
    ``b.step()`` runs it (its state cloned first where ``donate_state``
    is off) on a copy of its state, and checked: every state leaf must be
    an input the step writes in place (:func:`donation_report`).  A
    progressive batcher's step passes its policy rows; an early-exit walk
    reads values on the host and cannot be captured."""
    import contextlib

    import torch

    from repro_torch.launch import graph_analysis as ga
    from repro_torch.serve.batching import _map
    from repro_torch.sharding import ctx

    def step(params, state, tok, policy):
        st = state if b.donate_state else _map(torch.clone, state)
        scope = ctx.row_shard(b.mesh, b._rows) if b._rows \
            else contextlib.nullcontext()
        with scope:
            if b.progressive:
                return b._decode(params, st, tok, None, policy)
            return b._decode(params, st, tok)

    tok = b.cur_tok[b._r0:b._r0 + b._n_local]
    state = _map(torch.clone, b.state)
    with torch.no_grad():
        cap = ga.capture(step, (b.params, state, tok, b.slot_policy))
    records = ga.to_records(cap.gm)
    rep = donation_report(records)
    slot: dict = {}  # each distinct tensor's input position, as captured
    for t in tensors_of((b.params, state)):
        slot.setdefault(id(t), len(slot))
    leaves = sorted({slot[id(t)] for t in tensors_of(state)})
    kept = [i for i in leaves if i in set(rep["mutated_params"])]
    violations = []
    if len(kept) != len(leaves):
        violations.append(_violation(
            entry, "decode state NOT donated: state leaves that the "
                   "captured decode step does not update in place",
            f"in_place={len(kept)}/{len(leaves)} leaves"))
    return {"entry": entry, "ok": not violations, "violations": violations,
            "n_state_leaves": len(leaves),
            "n_in_place": len(kept), "n_aliases": rep["n_aliases"],
            "graph_nodes": ga.node_count(records)}


def probe_donation(fn, args: tuple, donated: tuple[int, ...]) -> dict:
    """Call ``fn(*args)`` once and report, for each argument index in
    ``donated``, whether every tensor of that argument comes back in the
    output on its own storage (the step wrote it in place): the
    counterpart of the reference's probe that a donated buffer is dead
    after the call."""
    before = {i: [t.untyped_storage().data_ptr() for t in
                  tensors_of(args[i])] for i in donated}
    out = fn(*args)
    ptrs = {t.untyped_storage().data_ptr() for t in tensors_of(out)}
    return {i: all(p in ptrs for p in before[i]) for i in donated}


def _violation(entry: str, reason: str, detail: str = "") -> dict:
    return {"entry": entry, "reason": reason, "detail": detail}


def _off_buckets(shapes, buckets) -> list:
    return sorted(s for s in shapes if s[1] not in set(buckets))


def audit_gateway(gw, entry: str = "gateway") -> dict:
    """Warmup coverage + prefill shapes of a ServingGateway.

    Call after serving traffic (a gateway built with ``aot_warmup=False``
    is warmed here first).  The shapes check is only meaningful after
    requests ran — a fresh gateway trivially passes it."""
    if not gw.warmup_s:
        gw.warmup()
    violations = []
    missing = [b for b in gw.buckets if b not in gw.warmup_s]
    if missing:
        violations.append(_violation(
            entry, "warmup coverage hole: buckets whose prefill never ran "
                   "in warmup", f"missing={missing}"))
    if "decode" not in gw.warmup_s:
        violations.append(_violation(
            entry, "warmup coverage hole: the decode step never ran in "
                   "warmup"))
    off = _off_buckets(gw.prefill_shapes, gw.buckets)
    if off:
        violations.append(_violation(
            entry, f"prefill shapes past the buckets: {off} (a prompt "
                   f"escaped the bucketing)", f"buckets={list(gw.buckets)}"))
    return {
        "entry": entry, "ok": not violations, "violations": violations,
        "buckets": list(gw.buckets),
        "warmed_buckets": sorted(b for b in gw.warmup_s if b != "decode"),
        "warmed_decode": "decode" in gw.warmup_s,
        "prefill_shapes": sorted(gw.prefill_shapes),
    }


def audit_batcher(b, entry: str = "batcher", step: bool = True) -> dict:
    """In-place state + prefill shapes of a live ContinuousBatcher.

    With ``step=True`` (a request must be in flight) the audit runs one
    decode step and checks that every state tensor kept its storage.  A
    bucketed batcher's prefills must all be at its buckets."""
    violations: list[dict] = []
    in_place: dict = {"checked": False}
    if step:
        before = [t.data_ptr() for t in tensors_of(b.state)]
        if not b.step():
            raise ValueError(f"{entry}: no request in flight, so no decode "
                             f"step ran to audit")
        after = [t.data_ptr() for t in tensors_of(b.state)]
        moved = sum(x != y for x, y in zip(before, after)) \
            + abs(len(before) - len(after))
        in_place = {"checked": True, "n_leaves": len(before),
                    "n_kept": len(before) - moved}
        if moved:
            violations.append(_violation(
                entry, "slot state was NOT updated in place: state "
                       "tensors moved to new storage in a decode step "
                       "(copy-per-step)",
                f"moved={moved}/{len(before)} leaves"))
    buckets = getattr(b, "_buckets", None)
    off = _off_buckets(b.prefill_shapes, buckets) if buckets else []
    if off:
        violations.append(_violation(
            entry, f"prefill shapes past the buckets: {off} (a prompt "
                   f"escaped the bucketing)", f"buckets={list(buckets)}"))
    return {"entry": entry, "ok": not violations, "violations": violations,
            "in_place": in_place, "bucketed": bool(buckets),
            "prefill_shapes": sorted(b.prefill_shapes)}
