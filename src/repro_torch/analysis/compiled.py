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

The reference's ``donation_report`` / ``parse_input_output_alias`` read
XLA's alias map from the compiled module; eager torch has no such
artifact, and the storage check replaces them.
"""

from __future__ import annotations

from repro_torch.analysis.exactness import tensors_of

__all__ = ["audit_gateway", "audit_batcher"]


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
