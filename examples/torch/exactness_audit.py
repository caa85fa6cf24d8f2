"""Exactness auditing on the PyTorch port: prove the L2R walks are exact,
not just test them.

    python examples/torch/exactness_audit.py [--device cuda|cpu]

Five acts using the port's auditors (``repro_torch.analysis``; the CLI is
``python -m repro_torch.analysis.lint``):

1. audit a registered claimed-exact walk (a taint walk over one recorded
   run; on the card the level-stacked GEMM is kernel B1, one opaque
   node),
2. catch a seeded violation (a bf16 product on the exact path),
3. certify int32 non-overflow for a digit config, and find the exact
   contraction length where the certificate flips to unsound,
4. sweep every arch in the config registry,
5. the sharding audit: sweep the split entries (on a spawned mesh the
   whole schedule and its sync-cost certificate; here they skip), and
   catch a float cross-rank sum on an exact path from the collective
   recorder alone: one rank's step on ``meta`` tensors under a 2 x 2
   mesh of shapes only, no process started.

Runs on the card unless ``--device cpu``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis.exactness import (ExactnessContract,  # noqa
                                            audit_exactness)
from repro_torch.analysis.overflow import audit_registry, certify  # noqa
from repro_torch.analysis.registry import iter_entries  # noqa: E402
from repro_torch.analysis.sharding import (ShardingContract,  # noqa: E402
                                           audit_records,
                                           audit_sharded_registry)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.mesh import make_shape_mesh  # noqa: E402
from repro_torch.sharding import collectives  # noqa: E402


def buggy_walk(aq, bq):
    # the bug class the pass exists for: a bf16 product rounds the digit
    # products; bit-exactness silently gone
    return (aq.to(torch.bfloat16) @ bq.to(torch.bfloat16)).to(torch.int32)


def buggy_split_head(x, group):
    # one rank's dequantized partial logits summed over the model axis in
    # f32: the sum's order reassociates them across ranks
    logits = (x.to(torch.int32) * 3).to(torch.float32) * 0.5
    return collectives.all_reduce(logits, "sum", group)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    print("=" * 70)
    print("1) Audit a registered claimed-exact entry point")
    name = f"gemm/stacked/{dev.type}"
    entry = next(e for e in iter_entries() if e.name == name)
    fn, args = entry.build(device=dev)
    rep = audit_exactness(fn, args, entry.contract, entry=entry.name)
    print(f"   {entry.name}: ok={rep.ok}  ops={rep.eqns_checked} "
          f"tainted={rep.tainted_eqns} int_dots={rep.int_dots} "
          f"f32_fastpath_dots={rep.f32_fastpath_dots} "
          f"kernel_nodes={rep.kernel_nodes}")
    assert rep.ok, rep.violations

    print("=" * 70)
    print("2) Seeded violation: a bf16 product on the exact path")
    rng = np.random.default_rng(0)
    aq = torch.from_numpy(rng.integers(-128, 128, (4, 24)).astype(np.int8))
    bq = torch.from_numpy(rng.integers(-128, 128, (24, 16)).astype(np.int8))
    rep = audit_exactness(buggy_walk, (aq.to(dev), bq.to(dev)),
                          ExactnessContract(k=24))
    assert not rep.ok
    for v in rep.violations:
        print(f"   CAUGHT {v.primitive}: {v.reason}")

    print("=" * 70)
    print("3) Overflow certification (n_bits=8, radix-4)")
    cert = certify(n_bits=8, log2_radix=2, k=512)
    print(f"   k=512: bound={cert.bound} (exact={cert.exact}) "
          f"sound={cert.sound} headroom={cert.headroom_bits:.1f} bits")
    k_max = cert.limit // cert.per_element
    for k in (k_max, k_max + 1):
        c = certify(8, 2, k)
        print(f"   k={k}: bound={c.bound} sound={c.sound}")
    assert certify(8, 2, k_max).sound and not certify(8, 2, k_max + 1).sound
    x, y, t = certify(8, 2, 1).witness
    print(f"   witness: x={x}, y={y} achieve the per-element bound "
          f"after {t} level(s)")

    print("=" * 70)
    print("4) Registry sweep: every arch, head + attention sites")
    rows = audit_registry()
    for r in rows[:4]:
        print(f"   {r['arch']:>18} {r['site']:<10} k={r['k']:<5} "
              f"bound={r['bound']:<12} sound={r['sound']}")
    print(f"   ... {len(rows)} sites total, "
          f"{sum(r['sound'] for r in rows)} sound")
    assert all(r["sound"] for r in rows)

    print("=" * 70)
    print("5) Sharding audit: the split entries and the recorder")
    # without a mesh the split entries skip (allow_skips keeps this
    # example runnable anywhere; `python -m repro_torch.analysis.lint
    # --sharding` spawns the 2 x 2 mesh and a skip there FAILS)
    for row in audit_sharded_registry(allow_skips=True, device=dev):
        print(f"   {row['entry']}: {row['status']}")
    # the float-reassociation class needs no ranks to demonstrate: one
    # rank's step on meta tensors under a mesh of shapes only records its
    # collectives as a running rank does
    mesh = make_shape_mesh({"data": 2, "model": 2})
    with collectives.recording() as records:
        buggy_split_head(torch.empty(4, 16, dtype=torch.int8,
                                     device="meta"), mesh.group("model"))
    rep = audit_records(records, ShardingContract(
        mesh_axes=(("data", 2), ("model", 2)),
        kinds=(("all_reduce", 1),)), "buggy_split_head")
    assert not rep.ok
    for v in rep.violations:
        print(f"   CAUGHT {v.primitive}: {v.reason} ({v.detail})")

    print("=" * 70)
    print("all audits behaved as expected; CLI equivalent:")
    print("    PYTHONPATH=src python -m repro_torch.analysis.lint "
          "--sharding")


if __name__ == "__main__":
    main()
