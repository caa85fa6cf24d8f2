"""l2r-lint for the port: the exactness, overflow, serving and sharding
audits over the registered entries.

    python -m repro_torch.analysis.lint [--device cuda|cpu] [--sharding]
        [--allow-skips] [--json PATH]

The port of ``tools/l2r_lint.py`` (which stays the JAX package's).  Four
passes over analysis/registry.py's entries:

1. **exactness** — run every registered entry once under the taint walk
   (analysis/exactness.py): integer ops only between plane extraction and
   the accumulator, >= 32-bit integer contractions, the guarded f32 fast
   path only where the guard holds and TF32 is off, each kernel one node
   with int8 / int16 operands and int32 outputs.  A ``cuda`` entry's
   result must also equal the same entry's run on the CPU bit for bit.
2. **overflow** — certify the worst-case int32 accumulator of every
   entry's digit config and of every config in the arch registry.
3. **compiled** — serve a few requests through the smoke SmolLM gateway
   and batcher and audit them (analysis/compiled.py): warmup coverage,
   in-place decode state, no prefill shapes past the buckets.
4. **sharding** (``--sharding``) — spawn four gloo ranks on a 2 x 2
   (data x model) mesh; every rank runs the split entries under the
   collective recorder and audits their schedules against their
   contracts (analysis/sharding.py, with the sync-cost certificate), and
   the exactness pass of the split entries that have a contract.

``--device`` (default ``cuda``) is where the ``cuda`` entries, the split
entries and the serving pass run; ``cuda`` raises without a card.  On
``cpu`` the ``cuda`` entries are skipped.  A skipped registered entry is
a FAILURE unless ``--allow-skips``.  Exit status 1 on any violation;
``--json`` writes the full report.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

__all__ = ["pass_exactness", "pass_overflow", "pass_compiled",
           "pass_sharding", "rank_pass", "smoke_model", "smoke_requests",
           "main"]


def _skip_row(e, reason: str, allow_skips: bool) -> dict:
    """A skipped registered entry: a failure unless ``allow_skips``."""
    row = {"entry": e.name, "tags": list(e.tags)}
    if allow_skips:
        row.update(status="skip", reason=reason)
    else:
        row.update(status="violation", ok=False, violations=[{
            "entry": e.name, "primitive": "registry",
            "reason": f"registered entry SKIPPED ({reason}) — pass "
                      "--allow-skips for a host that cannot run it",
            "detail": ""}])
    return row


def _same(a, b) -> bool:
    """Bit-for-bit equality of two results (tensors or tuples of them)."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def pass_exactness(entries, device: str = "cuda",
                   allow_skips: bool = False, mesh=None) -> list[dict]:
    """The exactness rows of ``entries`` (split entries only on a mesh).
    A ``cuda`` entry's row also holds ``matches_cpu``: its result against
    the same entry run on CPU tensors (the plain versions)."""
    from repro_torch.analysis.exactness import audit_exactness

    rows = []
    for e in entries:
        if e.contract is None:
            continue  # sharding-only entry: audited by the sharding pass
        dev = e.device or device
        reason = e.skip or ("--device cpu" if dev == "cuda"
                            and device != "cuda" else None)
        if reason:
            rows.append(_skip_row(e, reason, allow_skips))
            continue
        fn, args = e.build(device=dev, mesh=mesh)
        rep = audit_exactness(fn, args, e.contract, entry=e.name)
        row = {"entry": e.name, "tags": list(e.tags), "device": dev,
               **rep.to_json()}
        if dev == "cuda":
            cpu_fn, cpu_args = e.build(device="cpu", mesh=mesh)
            row["matches_cpu"] = _same(rep.output, cpu_fn(*cpu_args))
            if not row["matches_cpu"]:
                row["ok"] = False
                row["violations"].append({
                    "entry": e.name, "primitive": "result",
                    "reason": "the card's result differs from the same "
                              "entry on the CPU", "detail": ""})
        row["status"] = "ok" if row["ok"] else "violation"
        rows.append(row)
    return rows


def pass_overflow(entries) -> list[dict]:
    from repro_torch.analysis import overflow

    rows = []
    for e in entries:
        c = e.contract
        if c is None:
            continue  # sharding-only entry: no digit config to certify
        cert = overflow.certify(c.n_bits, c.log2_radix, c.k, levels=c.levels)
        rows.append({"entry": e.name, "status": "ok" if cert.sound
                     else "violation", **cert.to_json()})
    for row in overflow.audit_registry():
        rows.append({"entry": f"configs/{row['arch']}/{row['site']}",
                     "status": "ok" if row["sound"] else "violation", **row})
    return rows


def smoke_model(device: str):
    """The smoke SmolLM with L2R serving params (seed 0) on ``device``."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.common import materialize
    from repro_torch.models.transformer import lm_build
    from repro_torch.serve.engine import prepare_params

    dev = torch.device(device)
    cfg = dataclasses.replace(get_smoke("smollm-135m"), l2r=QuantConfig())
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, prepare_params(cfg, materialize(lm_build(cfg), gen,
                                                device=dev))


def smoke_requests(cfg, n: int = 3, max_new: int = 3, seed: int = 0,
                   lengths=(3, 20)) -> list:
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(
                0, cfg.vocab, (int(n_),)).astype(np.int32),
                max_new_tokens=max_new)
            for i, n_ in enumerate(rng.integers(*lengths, n))]


def pass_compiled(device: str = "cuda") -> list[dict]:
    from repro_torch.analysis import compiled as C
    from repro_torch.serve import ContinuousBatcher, ServingGateway

    cfg, params = smoke_model(device)
    gw = ServingGateway(cfg, params, n_slots=2, max_len=32, device=device)
    try:
        gw.run(smoke_requests(cfg))
        gw_rep = C.audit_gateway(gw)
    finally:
        gw.close()
    b = ContinuousBatcher(cfg, params, n_slots=2, max_len=32, device=device)
    for r in smoke_requests(cfg, 2):
        b.submit(r)
    b.step()  # prefill + first decode; the audited step is the next
    b_rep = C.audit_batcher(b)
    for rep in (gw_rep, b_rep):
        rep["status"] = "ok" if rep["ok"] else "violation"
    return [gw_rep, b_rep]


def rank_pass(device: str, allow_skips: bool, mesh=None) -> dict:
    """One rank of the sharding pass: the split entries on the 2 x 2
    ``mesh`` (made over the running process group when None), their
    exactness rows and their schedule audits."""
    from repro_torch.analysis import registry
    from repro_torch.analysis.sharding import audit_sharded_registry
    from repro_torch.launch.mesh import make_local_mesh

    if device == "cuda":
        torch.cuda.set_device(0)
    if mesh is None:
        mesh = make_local_mesh(*registry.MESH_SHAPE)
    entries = [e for e in registry.iter_entries(mesh=mesh)
               if e.sharding is not None]
    return {"exactness": pass_exactness(entries, device, allow_skips, mesh),
            "sharding": audit_sharded_registry(
                entries, allow_skips=allow_skips, device=device, mesh=mesh)}


def pass_sharding(device: str = "cuda", allow_skips: bool = False
                  ) -> dict:
    """Four gloo ranks on a 2 x 2 mesh run :func:`rank_pass`; rank 0's
    rows are the report, and a rank whose rows differ in status from
    rank 0's turns its row into a violation."""
    from repro_torch.analysis import registry
    from repro_torch.launch.mesh import spawn_local

    world = registry.MESH_SHAPE[0] * registry.MESH_SHAPE[1]
    ranks = spawn_local(world, rank_pass, device, allow_skips, threads=1,
                        deadline_s=900)
    out = ranks[0]
    for key in ("exactness", "sharding"):
        for i, row in enumerate(out[key]):
            bad = [r for r, got in enumerate(ranks)
                   if got[key][i]["status"] != row["status"]]
            if bad:
                row["status"] = "violation"
                row.setdefault("violations", []).append({
                    "entry": row["entry"], "primitive": "ranks",
                    "reason": f"ranks {bad} audit it otherwise than rank 0",
                    "detail": ""})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="static L2R invariant linter "
                                             "of the PyTorch port")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the cuda entries, the split entries and "
                         "the serving pass run (cuda raises without a card)")
    ap.add_argument("--json", default=None, help="write JSON report here")
    ap.add_argument("--sharding", action="store_true",
                    help="audit the split entries on a spawned 2 x 2 mesh "
                         "of four gloo ranks")
    ap.add_argument("--allow-skips", action="store_true",
                    help="report skipped registry entries as SKIP instead "
                         "of FAIL")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "False on this host; pass --device cpu")

    from repro_torch.analysis import registry

    entries = registry.iter_entries()
    split = [e for e in entries if e.sharding is not None]
    report = {
        "exactness": pass_exactness(
            [e for e in entries if e.sharding is None], args.device,
            args.allow_skips),
        "overflow": pass_overflow(entries),
        "compiled": pass_compiled(args.device),
    }
    if args.sharding:
        ranks = pass_sharding(args.device, args.allow_skips)
        report["exactness"] += ranks["exactness"]
        report["sharding"] = ranks["sharding"]
    else:
        report["exactness"] += pass_exactness(split, args.device,
                                              args.allow_skips)

    n_bad = 0
    for pass_name, rows in report.items():
        for row in rows:
            mark = {"ok": "PASS", "skip": "SKIP"}.get(row["status"], "FAIL")
            if mark == "FAIL":
                n_bad += 1
            print(f"[{pass_name:9s}] {mark} {row['entry']}")
            for v in row.get("violations", []):
                reason = v["reason"] if isinstance(v, dict) else v
                print(f"            - {reason}")
    report["n_violations"] = n_bad
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, default=str)
    print(f"l2r-lint: {n_bad} violation(s) across "
          f"{sum(len(r) for r in report.values() if isinstance(r, list))} "
          f"checks")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
