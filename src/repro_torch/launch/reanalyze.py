"""Re-run the graph analysis over the dry run's archived graphs
(``*.graph.json.xz``) and refresh the artifact JSONs, with no capture.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze [--dir artifacts/dryrun]

The port of ``repro/launch/reanalyze.py``: for each ``<cell>.json`` with
its archive beside it, ``collectives``, ``roofline`` and
``useful_compute_ratio`` come anew from launch/graph_analysis.py:analyze
of the archived records (launch/dryrun.py:graph_roofline, the roofline at
the peak the artifact names).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import graph_roofline
from repro_torch.launch.graph_analysis import load_graph


def refresh(jpath: str) -> dict | None:
    """The artifact at ``jpath`` refreshed from its archived graph and
    written back; None where it has no archive."""
    gpath = jpath[:-len(".json")] + ".graph.json.xz"
    if not os.path.exists(gpath):
        return None
    with open(jpath) as fh:
        rec = json.load(fh)
    peak = (rec.get("roofline") or {}).get("peak") or (
        "int8" if rec.get("l2r") or rec.get("opts", {}).get("wq")
        else "bf16")
    part = graph_roofline(load_graph(gpath), rec["chips"], peak,
                          rec.get("model_flops_per_chip"))
    if "unavailable" in part:
        rec.setdefault("unavailable", {})["graph"] = part.pop("unavailable")
    rec.update(part)
    with open(jpath, "w") as fh:
        json.dump(rec, fh, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="artifacts/dryrun")
    args = ap.parse_args(argv)
    for jpath in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        rec = refresh(jpath)
        name = os.path.basename(jpath)
        if rec is None:
            print(f"[skip] {name}: no archived graph")
        elif rec["roofline"] is None:
            print(f"[null] {name}: {rec['unavailable'].get('graph')}")
        else:
            rl = rec["roofline"]
            print(f"[ok] {name}: dominant={rl['dominant']} "
                  f"bound={rl['bound_s'] * 1e3:.2f}ms")


if __name__ == "__main__":
    main()
