"""Dry run: every (arch x shape) cell on the production meshes, sized and
priced without a card, one JSON artifact per cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out artifacts/dryrun

The port of ``repro/launch/dryrun.py``, with its CLI.  Where the
reference lowers and compiles each cell under a mesh of 256 (or 512)
devices and reads the compiled module, the port captures one rank's step
as an ATen graph (launch/graph_analysis.py) and reads that:

* **the layout**: the bytes one rank holds, from the port's layouts
  (params under sharding/axes.py:held_layouts, the serving state under
  serve/engine.py:state_specs and the port's own ``local_state``, the
  AdamW moments under ``zero1_specs``, the inputs under ``batch_spec``),
  for rank 0 and the largest over the ranks, beside the reference's
  ``param_specs`` arithmetic;
* **one captured step of rank 0 on the ``meta`` device** at the rank's
  local shapes, through the step factories a rank runs
  (``make_prefill_step``, ``make_decode_step``, ``make_train_step(
  mesh=)``) under a mesh of shapes only (launch/mesh.py:make_shape_mesh).
  Each kernel is one node (its custom op: kernels/_build.py:as_op), each
  collective one node carrying its group and tag
  (sharding/collectives.py).  ``analyze`` of the graph gives the cell's
  ``roofline`` and ``collectives`` as the reference's HLO analysis gives
  them (a fused program's traffic: views, pointwise ops and casts free;
  products and kernels at their operands and result), archived as
  ``<cell>.graph.json.xz`` (launch/reanalyze.py re-reads it);
  ``capture_s`` and ``graph_nodes`` are the counterparts of
  ``compile_s`` and ``hlo_bytes``.  The same run, meanwhile, is metered
  as eager torch runs it: ``cost_analysis_raw`` (the counterpart of
  XLA's raw cost analysis) holds its FLOPs
  (``torch.utils.flop_counter.FlopCounterMode``, kernels by their
  formulas) and the bytes of every op's operands and results (eager
  unfused traffic), and ``memory_analysis`` the peak of live storage (the
  rank's inputs plus the most the step holds at once).

launch/roofline.py turns the graph's FLOPs, bytes and wire bytes into the
three roofline terms at the H100 data sheet's rates: the compute term at
the bf16 peak, or the int8 peak where ``--l2r`` / ``--wq`` puts the
products on kernel B1.  Nothing is launched and no card is needed.

Where the capture cannot go, the artifact gives that part as null with
the reason, never a guessed number; the layout bytes are always given.
Two cases are expected: a read of a tensor's value on the host (MoE
dispatch counts, an early-exit walk, the ``L2R_CERTIFY`` guard), and
decode over a cache split by sequence (``--kv-seq-shard``), which the
port has no code for.  ``lower_s`` has no meaning here and is absent.
``--moe-hints`` raises: the port has no interior sharding hints to turn
on (eager torch has no partitioner).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (SHAPES, all_cells, cell_supported,
                                 get_config)
from repro_torch.configs.registry import input_specs
from repro_torch.launch import graph_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (model_flops, parse_collectives,
                                         roofline_terms)
from repro_torch.models.common import (abstract, count_params,
                                       quantize_desc)
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import collectives, ctx
from repro_torch.sharding.axes import (P, _desc, _paths, _spec_leaves,
                                       batch_rows, batch_spec, held_layouts,
                                       param_specs, shard_params,
                                       zero1_specs)

__all__ = ["MeterMode", "meter", "meta_step", "layout_bytes", "tree_bytes",
           "cell_config", "dry_cell", "run_cell",
           "rank_gb", "graph_roofline", "main", "BYTES_NOTE"]

BYTES_NOTE = ("bytes_moved: each op's operands plus its results as eager "
              "PyTorch runs them, unfused (views move nothing); a fused "
              "program moves less")
SEQ_DECODE = ("decode over a KV cache split by sequence "
              "(state_specs(kv_shard='seq')): the port has no decode "
              "attention for that layout")


# ------------------------------------------------------------ the meter
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _flat(v)]
    return []


class MeterMode(TorchDispatchMode):
    """Bytes moved and live storage of the ops run inside.

    ``moved``: the bytes of every non-view op's tensor operands and
    results.  ``live``/``peak``: the storage held by the tensors the ops
    made, from the op that makes a storage to the death of the last
    tensor on it (a weakref finalizer); storages that exist before the
    mode (the inputs) count nothing here."""

    def __init__(self, inputs=()):
        super().__init__()
        self.moved = 0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self._refs: dict = {}  # storage key -> [tensors alive, bytes]
        self._base = {self._key(t) for t in inputs}

    @staticmethod
    def _key(t: torch.Tensor):
        return t.untyped_storage()._cdata

    def _drop(self, key) -> None:
        ref = self._refs[key]
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def _track(self, t: torch.Tensor) -> None:
        key = self._key(t)
        if key in self._base:
            return
        if key not in self._refs:
            size = t.untyped_storage().nbytes()
            self._refs[key] = [0, size]
            self.live += size
            self.peak = max(self.peak, self.live)
        self._refs[key][0] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _flat(out)
        self.ops += 1
        if not func.is_view:
            self.moved += sum(_nbytes(t) for t in _flat(args) + _flat(kwargs)
                              + outs)
        for t in outs:
            self._track(t)
        return out


def meter(fn, args: tuple, inputs: list[torch.Tensor],
          measure: bool = True, graph: bool = False) -> dict:
    """Run ``fn(*args)`` on meta tensors under the FLOP counter, the
    :class:`MeterMode` and the collective recorder: ``{"out", "flops",
    "bytes_moved", "temp_peak_bytes", "records", "ops"}`` (the peak of
    the storage the step made, over the ``inputs`` already held); with
    ``measure=False`` under the recorder alone (``{"out", "records"}``).
    With ``graph`` the step is also captured
    (launch/graph_analysis.py:capture), given as ``"graph"``: in a run of
    its own where it is metered (a trace holds its tensors longer than the
    step does, so the peak is the eager run's), else in the recorded run
    itself."""
    def captured():
        cap = graph_analysis.capture(fn, args)
        out, cap.output = cap.output, None
        return out, cap

    if not measure:
        with collectives.recording() as records:
            out, cap = captured() if graph else (fn(*args), None)
        return {"out": out, "records": list(records), "graph": cap}
    flops = FlopCounterMode(display=False)
    with collectives.recording() as records:
        with flops, MeterMode(inputs) as m:
            out = fn(*args)
    res = {"out": out, "flops": flops.get_total_flops(),
           "bytes_moved": m.moved, "temp_peak_bytes": m.peak,
           "records": list(records), "ops": m.ops, "graph": None}
    if graph:
        res["graph"] = captured()[1]
    return res


# ------------------------------------------------------------ the layout
def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors (a view of
    another's storage counts once): what the tree holds on its device."""
    from repro_torch.analysis.exactness import tensors_of

    seen: dict = {}
    for t in tensors_of(tree):
        seen[t.untyped_storage()._cdata] = t.untyped_storage().nbytes()
    return sum(seen.values())


def _block_numel(shape: tuple, index: tuple) -> int:
    n = 1
    for i, dim in enumerate(shape):
        ix = index[i] if i < len(index) else slice(None)
        n *= ix.numel() if isinstance(ix, torch.Tensor) \
            else len(range(*ix.indices(dim)))
    return n


def _spec_numel(shape: tuple, spec: tuple, mesh) -> int:
    """A rank's block of a ``shape`` tensor under ``spec`` (even splits:
    safe_spec keeps only the axes that divide)."""
    n = math.prod(shape)
    for ax in spec:
        n //= ctx.mesh_axis_size(mesh, ax)
    return n


def _model_ranks(mesh) -> list[int]:
    """One rank of each model coordinate (the others at 0): the rows
    split evenly, so the ranks of one model coordinate hold alike."""
    m = mesh.shape.get("model", 1)
    return list(range(m)) if "model" in mesh.axis_names else [0]


def layout_bytes(cfg: ModelConfig, mesh, desc, kind: str, batch: int,
                 seq_len: int, kv_shard: str, inputs: dict,
                 param_dtype: torch.dtype = torch.bfloat16,
                 cache_dtype: torch.dtype = torch.bfloat16) -> dict:
    """The bytes a rank holds, from the layouts (no step is run):
    ``params`` (held_layouts; ``specs`` the reference's param_specs
    arithmetic, ``held_leaves`` the leaves where they differ), ``state``
    (serving: state_specs with ``kv_shard``; ``held`` the port's own
    layout, engine.local_state, None with "seq"), ``opt_state`` (train:
    the f32 AdamW moments under zero1_specs) and ``inputs`` (batch_spec),
    each for this rank (``rank``, ``mesh.rank``'s: the rows split evenly,
    so only its model coordinate tells it from rank 0), as the largest
    over the ranks (``max``) and for one process (``whole``)."""
    from repro_torch.serve.batching import _tensors
    from repro_torch.serve.engine import (abstract_state, local_state,
                                          state_specs)

    leaves = _paths(desc)
    specs = _spec_leaves(param_specs(desc, mesh))
    layouts = held_layouts(cfg, mesh, desc)
    sizes = [(param_dtype if p.dtype == torch.float32 else p.dtype).itemsize
             for _, p in leaves]
    spec_bytes = sum(_spec_numel(p.shape, s, mesh) * z
                     for (_, p), s, z in zip(leaves, specs, sizes))
    per_rank, held = [], set()
    for r in _model_ranks(mesh):
        coords = mesh.coords(r)
        tot = 0
        for (path, p), s, lay, z in zip(leaves, specs, layouts, sizes):
            n = _block_numel(p.shape, lay.index(coords))
            if n != _spec_numel(p.shape, s, mesh):
                held.add(path)
            tot += n * z
        per_rank.append(tot)
    mine = mesh.coords().get("model", 0)
    out = {"params": {"rank": per_rank[mine], "max": max(per_rank),
                      "specs": spec_bytes,
                      "whole": sum(math.prod(p.shape) * z
                                   for (_, p), z in zip(leaves, sizes)),
                      "held_leaves": sorted(held)}}

    rows = batch_spec(mesh, batch)[0]
    n_rows = ctx.mesh_axis_size(mesh, rows)
    ins = sum(_nbytes(v) // n_rows for v in inputs.values())
    out["inputs"] = {"rank": ins, "max": ins,
                     "whole": sum(_nbytes(v) for v in inputs.values())}

    if kind == "train":
        z = [_spec_numel(p.shape, s, mesh) * 4
             for (_, p), s in zip(leaves,
                                  _spec_leaves(zero1_specs(desc, mesh)))]
        out["opt_state"] = {"rank": 2 * sum(z), "max": 2 * sum(z),
                            "whole": 2 * sum(math.prod(p.shape) * 4
                                             for _, p in leaves)}
        return out

    whole = abstract_state(cfg, batch, seq_len, cache_dtype)
    st = _tensors(whole)
    sp = _tensors(state_specs(cfg, mesh, batch, seq_len, kv_shard), leaf=P)
    assert len(st) == len(sp), (len(st), len(sp))
    s_bytes = sum(_spec_numel(tuple(t.shape), s, mesh) * t.element_size()
                  for t, s in zip(st, sp))
    held_state = None
    if kv_shard == "heads":
        held_state = []
        for r in _model_ranks(mesh):
            held_state.append(sum(_nbytes(t) for t in _tensors(
                local_state(cfg, _at(mesh, r), whole))))
    out["state"] = {"rank": s_bytes, "max": s_bytes,
                    "held_rank": held_state[mine] if held_state else None,
                    "held_max": max(held_state) if held_state else None,
                    "whole": sum(_nbytes(t) for t in st),
                    "kv_shard": kv_shard}
    return out


def _at(mesh, rank: int):
    """``mesh`` seen from ``rank`` (a mesh of shapes only)."""
    from repro_torch.launch.mesh import make_shape_mesh

    return mesh if rank == mesh.rank else make_shape_mesh(mesh.shape, rank)


# ------------------------------------------------------------ the cell
def cell_config(arch: str, l2r: bool = False, score_bf16: bool = False,
                head_shard: bool = False, moe_dp_local: bool = False
                ) -> ModelConfig:
    """``arch``'s config with the dry run's switches (the reference's
    ``lower_cell``)."""
    cfg = get_config(arch)
    if l2r:
        from repro_torch.core.quant import QuantConfig

        cfg = dataclasses.replace(cfg, l2r=QuantConfig())
    if score_bf16:
        cfg = dataclasses.replace(cfg, attn_score_dtype="bfloat16")
    if head_shard:
        cfg = dataclasses.replace(cfg, attn_head_shard=True)
    if moe_dp_local:
        cfg = dataclasses.replace(cfg, moe_dp_local=True)
    return cfg


def _reason(exc: BaseException) -> str:
    """Where in the port the meta run stopped, and why."""
    where = ""
    for fr in reversed(traceback.extract_tb(exc.__traceback__)):
        if "repro_torch" in fr.filename and \
                not fr.filename.endswith("dryrun.py"):
            where = (f"{fr.filename.split('src/')[-1]}:{fr.lineno} "
                     f"({fr.name}): ")
            break
    msg = str(exc).strip().split(". ")[0] if str(exc).strip() else ""
    values = any(s in msg for s in ("meta tensor", "Cannot copy out of meta",
                                    "data-dependent", "data-independent",
                                    "Meta kernel", "value out of a tracing"))
    return (("an op that needs a tensor's values on the host, at "
             if values else "") + f"{where}{type(exc).__name__}: {msg}"
            )[:400]


def _fresh(t: torch.Tensor) -> torch.Tensor:
    """A contiguous meta tensor of ``t``'s shape and dtype with a storage
    of its own (a rank holds its blocks as tensors of their own)."""
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def meta_step(cfg: ModelConfig, mesh, kind: str, params, batch: dict,
              max_len: int, tcfg=None,
              cache_dtype: torch.dtype = torch.bfloat16,
              measure: bool = True, graph: bool = False) -> dict:
    """One step of the rank ``mesh.rank`` (one process where ``mesh`` is
    None) on meta tensors (:func:`meter`):
    ``params`` the rank's (sharding/axes.py:shard_params of meta
    params), ``batch`` the global batch on meta (this rank takes its rows
    as a running rank does).  Returns :func:`meter`'s dict (``measure``
    and ``graph`` as there)."""
    from repro_torch.analysis.exactness import tensors_of
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.serve.batching import _map, _tensors
    from repro_torch.serve.engine import (abstract_state, local_state,
                                          make_decode_step,
                                          make_prefill_step)
    from repro_torch.train.step import (TrainConfig, _batch_size,
                                        make_train_step, zero1_layout)

    inputs = tensors_of(params) + list(batch.values())
    if kind == "train":
        step = make_train_step(cfg, AdamWConfig(), tcfg or TrainConfig(),
                               mesh)
        opt = adamw_init(params, None if mesh is None
                         else zero1_layout(cfg, mesh))
        return meter(step, (params, opt, batch), inputs + _tensors(opt),
                     measure, graph)
    bsz = _batch_size(batch)
    axes, r0, n = batch_rows(mesh, bsz)
    rows = {k: v.narrow(1 if k == "rope_positions" else 0, r0, n)
            for k, v in batch.items()}
    if kind == "prefill":
        step = make_prefill_step(cfg, max_len, cache_dtype)

        def prefill(p, b):
            with ctx.row_shard(mesh, axes):
                return step(p, b)

        return meter(prefill, (params, rows), inputs, measure, graph)
    state = abstract_state(cfg, bsz, max_len, cache_dtype)
    if mesh is not None:
        state = _map(_fresh, local_state(cfg, mesh, state))
    step = make_decode_step(cfg)

    def decode(p, s, b):
        with ctx.row_shard(mesh, axes):
            return step(p, s, b["tokens"], b.get("rope_positions"))

    return meter(decode, (params, state, rows), inputs + _tensors(state),
                 measure, graph)


def rank_gb(rec: dict) -> float:
    """GB the largest rank holds in a cell (its params, the port's state
    layout where it has one, else state_specs', the AdamW moments and the
    inputs)."""
    by = rec["bytes_per_rank"]
    tot = by["params"]["max"] + by["inputs"]["max"] + \
        by.get("opt_state", {}).get("max", 0)
    if "state" in by:
        st = by["state"]
        tot += st["held_max"] if st["held_max"] is not None else st["max"]
    return tot / 1e9


def graph_roofline(records: list[dict], chips: int, peak: str,
                   model_flops_per_chip: float | None) -> dict:
    """The graph's part of an artifact (launch/graph_analysis.py:analyze
    of its records): ``collectives``, ``roofline`` and
    ``useful_compute_ratio``, as the reference derives them from its HLO
    (launch/reanalyze.py refreshes them from an archive the same way);
    a loop of unknown trip count makes them null with the reason."""
    try:
        ana = graph_analysis.analyze(records)
    except graph_analysis.UnknownTripCount as e:
        return {"collectives": None, "roofline": None,
                "useful_compute_ratio": None, "graph_cost": None,
                "unavailable": str(e)}
    rl = roofline_terms(ana["flops"], ana["bytes"], ana["total_wire_bytes"],
                        chips, peak)
    return {"collectives": parse_collectives(records),
            "roofline": {**rl.asdict(), "peak": peak},
            "useful_compute_ratio": (model_flops_per_chip / ana["flops"]
                                     if model_flops_per_chip
                                     and ana["flops"] else None),
            "graph_cost": {k: ana[k] for k in ("flops", "bytes",
                                               "flops_by_peak",
                                               "weight_bytes")}}


def dry_cell(arch: str, cfg: ModelConfig, sp, mesh, tcfg=None,
             l2r: bool = False, wq: bool = False, kv_shard: str = "heads",
             opts: dict | None = None,
             graph_path: str | None = None) -> dict:
    """The artifact of ``arch`` at ``cfg`` (its switches applied) and the
    cell ``sp`` (configs/registry.py:ShapeSpec) on ``mesh`` (a mesh of
    shapes only seen from the rank the step is captured for): the layout
    bytes, then the captured step (its graph archived at ``graph_path``
    unless None), or its reason for null."""
    t0 = time.time()
    desc = _desc(cfg, None)
    if wq:
        assert sp.kind != "train", "int8 weight storage is a serving mode"
        desc = quantize_desc(desc)
    specs = input_specs(arch, sp, cfg)
    n_tokens = sp.global_batch * (sp.seq_len if sp.kind != "decode" else 1)
    rec = dict(arch=arch, shape=sp.name, kind=sp.kind,
               multi_pod="pod" in mesh.axis_names, chips=mesh.size,
               mesh=dict(mesh.shape), rank=mesh.rank,
               params=count_params(desc), n_tokens=n_tokens, l2r=l2r,
               kv_shard=kv_shard, opts=dict(opts or {}, wq=wq))
    rec["bytes_per_rank"] = layout_bytes(cfg, mesh, desc, sp.kind,
                                         sp.global_batch, sp.seq_len,
                                         kv_shard, specs)
    rec["layout_s"] = time.time() - t0
    mf = model_flops(cfg, _desc(cfg, None), n_tokens, sp.kind)
    rec["model_flops_per_chip"] = mf / mesh.size
    peak = "int8" if (l2r or wq) else "bf16"
    unavailable = {}
    t1 = time.time()
    try:
        if sp.kind == "decode" and kv_shard == "seq":
            raise _Unavailable(SEQ_DECODE)
        if wq and mesh.shape.get("model", 1) > 1:
            raise _Unavailable(
                "int8-stored weights ({'q', 'scale'} records) serve whole: "
                "sharding/axes.py:shard_params does not cut them")
        params = abstract(desc, torch.bfloat16)
        with ctx.restored((None, (), None)):
            params = shard_params(cfg, params, mesh, desc)
            res = meta_step(cfg, mesh, sp.kind, params, specs, sp.seq_len,
                            tcfg, graph=True)
    except _Unavailable as e:
        res, unavailable["meta_run"] = None, str(e)
    except Exception as e:  # noqa: BLE001 - reported in the artifact
        res, unavailable["meta_run"] = None, _reason(e)
    rec["meta_s"] = time.time() - t1
    rec["unavailable"] = unavailable
    if res is None:
        rec.update(memory_analysis=None, cost_analysis_raw=None,
                   collectives=None, roofline=None,
                   useful_compute_ratio=None, capture_s=None,
                   graph_nodes=None, graph_cost=None)
        return rec
    by = rec["bytes_per_rank"]
    base = by["params"]["rank"] + by["inputs"]["rank"] + \
        by.get("opt_state", {}).get("rank", 0)
    if "state" in by:
        base += by["state"]["held_rank"]
    rec["memory_analysis"] = {
        "argument_size_in_bytes": base,
        "temp_size_in_bytes": res["temp_peak_bytes"],
        "peak_bytes": base + res["temp_peak_bytes"]}
    rec["cost_analysis_raw"] = {
        "flops": res["flops"], "bytes_moved": res["bytes_moved"],
        "ops": res["ops"], "note": BYTES_NOTE}
    records = graph_analysis.to_records(res["graph"].gm)
    rec["capture_s"] = res["graph"].seconds
    rec["graph_nodes"] = graph_analysis.node_count(records)
    if graph_path:
        rec["graph_bytes"] = graph_analysis.save_graph(graph_path, records)
        rec["graph_archive"] = os.path.basename(graph_path)
    part = graph_roofline(records, mesh.size, peak,
                          rec["model_flops_per_chip"])
    if "unavailable" in part:
        unavailable["graph"] = part.pop("unavailable")
    rec.update(part)
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str | None,
             tcfg=None, l2r: bool = False, tag: str = "",
             skip_existing: bool = False, score_bf16: bool = False,
             wq: bool = False, kv_shard: str = "heads",
             moe_dp_local: bool = False, head_shard: bool = False) -> dict:
    """One cell of :data:`SHAPES` on the production mesh of ``multi_pod``
    seen from rank 0 (:func:`dry_cell`), its artifact written to
    ``out_dir`` unless None; prints the reference's ``[OK]`` line."""
    mp_name = "2pod" if multi_pod else "1pod"
    name = f"{arch}_{shape}_{mp_name}{tag}.json"
    path = os.path.join(out_dir, name) if out_dir else None
    if skip_existing and path and os.path.exists(path):
        with open(path) as fh:
            rec = json.load(fh)
        print(f"[CACHED] {arch} x {shape} x {mp_name}{tag}")
        return rec
    cfg = cell_config(arch, l2r, score_bf16, head_shard, moe_dp_local)
    if path:
        os.makedirs(out_dir, exist_ok=True)
    rec = dry_cell(arch, cfg, SHAPES[shape],
                   make_production_mesh(multi_pod=multi_pod, rank=0), tcfg,
                   l2r, wq, kv_shard,
                   dict(score_bf16=score_bf16, moe_dp_local=moe_dp_local,
                        head_shard=head_shard),
                   graph_path=path and path.replace(".json", ".graph.json.xz"))
    if path:
        with open(path, "w") as fh:
            json.dump(rec, fh, indent=1)
    head = f"[OK] {arch} x {shape} x {mp_name}{tag}: {rank_gb(rec):.2f} GB " \
        f"a rank"
    if rec["roofline"] is None:
        print(f"{head}; roofline null: "
              f"{'; '.join(rec['unavailable'].values())}")
    else:
        rl, u = rec["roofline"], rec["useful_compute_ratio"]
        print(f"{head}, captured {rec['graph_nodes']} nodes in "
              f"{rec['capture_s']:.1f}s dominant={rl['dominant']} "
              f"bound={rl['bound_s'] * 1e3:.2f}ms "
              f"useful={u and round(u, 3)}")
    return rec


class _Unavailable(Exception):
    """A part of the cell the meta run does not reach, by design."""


def main(argv=None) -> None:
    from repro_torch.train.step import TrainConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default="off")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--l2r", action="store_true",
                    help="the paper's digit-plane arithmetic in matmuls")
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--xent-chunk", type=int, default=512)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--score-bf16", action="store_true",
                    help="bf16 attention score blocks")
    ap.add_argument("--moe-hints", action="store_true",
                    help="the reference's interior MoE sharding hints: "
                         "raises, the port has none")
    ap.add_argument("--wq", action="store_true",
                    help="int8-stored weights: W8A8 L2R serving")
    ap.add_argument("--kv-seq-shard", action="store_true",
                    help="KV caches split on the sequence dim")
    ap.add_argument("--moe-dp-local", action="store_true",
                    help="DP-local-capacity MoE dispatch")
    ap.add_argument("--head-shard", action="store_true",
                    help="attention split on the KV-head dim")
    args = ap.parse_args(argv)
    if args.moe_hints:
        raise ValueError(
            "--moe-hints: the reference's interior sharding hints on the "
            "MoE dispatch have no meaning in eager PyTorch, which has no "
            "partitioner (sharding/ctx.py: the hints return their input)")

    tcfg = TrainConfig(remat=not args.no_remat,
                       seq_shard=not args.no_seq_shard,
                       xent_chunk=args.xent_chunk)
    pods = {"off": [False], "on": [True], "both": [False, True]}[
        args.multi_pod]
    cells = []
    if args.all:
        for a, s, ok, why in all_cells():
            if ok:
                cells.append((a, s))
            else:
                print(f"[SKIP] {a} x {s}: {why}")
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        ok, why = cell_supported(args.arch, args.shape)
        if not ok:
            print(f"[SKIP] {args.arch} x {args.shape}: {why}")
            return
        cells.append((args.arch, args.shape))

    failures, rows = [], []
    for a, s in cells:
        for mp in pods:
            try:
                rec = run_cell(a, s, mp, args.out, tcfg, args.l2r, args.tag,
                               args.skip_existing, args.score_bf16, args.wq,
                               "seq" if args.kv_seq_shard else "heads",
                               args.moe_dp_local, args.head_shard)
                rl = rec["roofline"]
                rows.append(f"| {a} | {s} | {'2pod' if mp else '1pod'} | "
                            f"{rank_gb(rec):.2f} | "
                            + (f"{rl['dominant']} | {rl['bound_s'] * 1e3:.2f} |"
                               if rl else "null | null |"))
            except Exception:  # noqa: BLE001 - counted, then raised
                failures.append((a, s, mp))
                print(f"[FAIL] {a} x {s} x {'2pod' if mp else '1pod'}")
                traceback.print_exc()
    print("| arch | shape | mesh | GB a rank | dominant | bound ms |")
    print("|---|---|---|---|---|---|")
    print("\n".join(rows))
    if failures:
        raise SystemExit(f"{len(failures)} cell(s) failed: {failures}")
    print("dry-run complete")


if __name__ == "__main__":
    main()
