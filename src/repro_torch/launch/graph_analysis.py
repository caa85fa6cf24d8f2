"""Trip-count-aware cost analysis of a captured step.

The port of ``repro/launch/hlo_analysis.py``.  The reference reads the
compiled HLO text of a jitted step; the port captures the step's ATen
graph (``torch.fx.experimental.proxy_tensor.make_fx`` in ``real`` mode:
the step runs once, on ``meta`` tensors for the dry run or on the card's
own tensors, and every ATen op it dispatches is one node) and reads that.

* :func:`capture` — the step ``fn(*args)`` with the tensor leaves of its
  argument trees (params, state, batch: tuples, lists, dicts, named tuples
  and dataclasses) flattened into the graph's inputs and the trees rebuilt
  inside, so the placeholders are those tensors and the graph can be
  replayed on others of the same shapes (:class:`Captured`).  While it
  traces, kernels/_build.py:CAPTURE is set: every kernel wrapper calls its
  kernel as its custom op (``repro_torch::l2r_stacked_gemm``, ...), one
  node, and a collective over a mesh of shapes only is its custom op too
  (sharding/collectives.py).  A read of a tensor's value on the host
  (``.item()``, a Python ``if`` on a tensor) stops the trace with make_fx's
  error: no value is ever traced into a constant.
* :func:`to_records` — one JSON-able dict a node: its op, target, operand
  names and literals, result dtypes and shapes, the class of its cost,
  the collective's fields, and a loop's body with its trip count.  This is
  the port's "HLO text": what is archived (:func:`save_graph`) and what
  :func:`analyze` reads.
* :func:`analyze` — the reference's keys (``flops``, ``bytes``,
  ``collective_wire_bytes``, ``collective_counts``, ``total_wire_bytes``)
  under its rules: FLOPs of the products (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolution, ...) and of each kernel node by its kernel
  module's formula; the body of a ``higher_order.scan`` or ``map``
  weighted by its trip count, nested loops multiplying, and a
  ``while_loop`` (no count known) refused (:class:`UnknownTripCount`); 2 x
  the result of every materialized op, with views and the ops ATen tags
  ``pointwise`` (and casts, copies and fills: the reference's
  ``_SKIP_BYTES_OPS``) free, as a fused backend fuses them into their
  consumers; a product or kernel node its operands in their stored dtype
  plus its result, once; an in-place slice write (``copy_``,
  ``index_put_``, ``slice_scatter``, ``scatter``) its update region, not
  the buffer; the step's inputs and constants once each, as weight reads
  (an operand that is one of them, or a view of one, is not charged
  again).  Collective wire bytes follow the ring models
  (analysis/collective_cost.py:ring_wire_bytes).
* :func:`collective_records` — every collective node with the reference's
  record fields, and the recorder's (sharding/collectives.py:Record).

Like the reference, a traffic model, not a simulator: it counts what a
fused program must move at least, so its roofline is a floor for the
step it describes.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import lzma
import operator
import time
from typing import Any

import torch

from repro_torch.analysis.collective_cost import ring_wire_bytes

__all__ = ["Captured", "capture", "to_records", "analyze",
           "collective_records", "recorded", "kernel_nodes", "node_count",
           "written_inputs", "output_aliases",
           "save_graph", "load_graph", "UnknownTripCount", "KERNELS",
           "COLLECTIVES"]

#: kernel ops (repro_torch::<library>) -> the kernel's id
KERNELS = {"l2r_stacked_gemm": "B1", "l2r_streaming_gemm": "B2",
           "l2r_pairs_gemm": "B3", "flash_attention_l2r": "B4",
           "flash_attention": "B5", "cipu_array": "B6"}
#: collective ops (repro_torch::<op>) -> the reference's kind
COLLECTIVES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
               "all_to_all": "all-to-all"}
_REDUCE = {"sum": "add", "max": "maximum", "min": "minimum"}
_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")

#: products: aten op -> FLOPs from the operand shapes and the result's
_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "convolution", "_int_mm",
             "mv", "addmv", "dot", "addbmm"}
#: ops that move nothing a fused backend keeps (besides views and the ops
#: ATen tags pointwise): casts, copies, fills, factories
_FREE = {"_to_copy", "clone", "copy", "detach", "alias", "lift_fresh_copy",
         "zeros", "ones", "full", "empty", "empty_like", "zeros_like",
         "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
         "new_empty", "empty_strided", "new_empty_strided", "arange",
         "scalar_tensor", "fill_", "zero_", "fill", "flip", "_unsafe_view",
         "view", "reshape", "_local_scalar_dense", "sym_size", "getitem"}
#: in-place slice writes: op -> the position of the update operand
_UPDATES = {"copy_": 1, "index_put_": 2, "index_put": 2,
            "_unsafe_index_put": 2, "slice_scatter": 1, "select_scatter": 1,
            "scatter": 3, "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
            "index_copy": 3, "index_copy_": 3}
_DTYPE_CLASS = {"int8": "int8", "uint8": "int8", "bfloat16": "bf16",
                "float16": "bf16", "float32": "f32", "float64": "f64"}


class UnknownTripCount(ValueError):
    """A loop whose trip count the graph does not carry (``while_loop``):
    its cost is unknown, so the cell's cost is null with this reason."""


# ------------------------------------------------------------ the trees
#: a tensor leaf's place in a tree kept as a template
_LEAF = object()


def _is_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) or x is _LEAF


def _walk(tree, out: list) -> None:
    if _is_leaf(tree):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _walk(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _walk(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _walk(getattr(tree, f.name), out)


def _leaves(tree) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _walk(tree, out)
    return out


def _rebuild(tree, it):
    """``tree`` with its tensor leaves replaced, in order, by ``it``'s."""
    if _is_leaf(tree):
        return next(it)
    if isinstance(tree, dict):
        return type(tree)((k, _rebuild(v, it)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        new = copy.copy(tree)
        for f in dataclasses.fields(tree):
            object.__setattr__(new, f.name, _rebuild(getattr(tree, f.name),
                                                     it))
        return new
    return tree


@dataclasses.dataclass
class Captured:
    """A captured step: ``gm`` takes the distinct tensor leaves of the
    argument trees (a tensor that appears twice is one input) and returns
    the output tree's tensor leaves.  Calling it replays the graph on
    argument trees of the same structure."""

    gm: torch.fx.GraphModule
    slots: list            # each leaf position -> its input's index
    firsts: list           # each input -> the first leaf position it is
    out_tree: Any          # the output tree, its tensors as templates
    seconds: float         # the trace's wall time
    output: Any = None     # what the traced run returned

    def inputs(self, *args) -> list[torch.Tensor]:
        leaves = _leaves(args)
        if len(leaves) != len(self.slots):
            raise ValueError(f"replay takes trees of {len(self.slots)} "
                             f"tensors, got {len(leaves)}")
        return [leaves[i] for i in self.firsts]

    def __call__(self, *args):
        outs = self.gm(*self.inputs(*args))
        return _rebuild(self.out_tree, iter(outs))


def capture(fn, args: tuple) -> Captured:
    """``fn(*args)`` traced once in ``real`` mode (it runs: on ``meta``
    tensors nothing is computed, on the card every kernel launches) into
    a :class:`Captured` graph whose inputs are the tensor leaves of
    ``args``.  Kernel wrappers call their custom ops meanwhile
    (kernels/_build.py:CAPTURE)."""
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.kernels import _build

    leaves = _leaves(args)
    index: dict[int, int] = {}
    slots, firsts = [], []
    for pos, t in enumerate(leaves):
        if id(t) not in index:
            index[id(t)] = len(firsts)
            firsts.append(pos)
        slots.append(index[id(t)])
    box: dict = {}

    def flat(*inputs):
        tree = _rebuild(args, iter(inputs[s] for s in slots))
        out = fn(*tree)
        box["out"] = out
        return _leaves(out)

    was = _build.CAPTURE
    _build.CAPTURE = True
    t0 = time.perf_counter()
    try:
        # one fake mode for every node's shape record (make_fx otherwise
        # makes a mode a node)
        with tracing(TracingContext(FakeTensorMode(
                allow_fallback_kernels=True))):
            gm = make_fx(flat, tracing_mode="real")(
                *[leaves[p] for p in firsts])
    finally:
        _build.CAPTURE = was
    seconds = time.perf_counter() - t0
    out = box.pop("out")
    return Captured(gm, slots, firsts, _rebuild(out, iter(lambda: _LEAF, 0)),
                    seconds, out)


# ------------------------------------------------------------ records
def _arg(a):
    if isinstance(a, torch.fx.Node):
        return {"node": a.name}
    if isinstance(a, (list, tuple)):
        return [_arg(x) for x in a]
    if isinstance(a, dict):
        return {str(k): _arg(v) for k, v in a.items()}
    if a is None or isinstance(a, (bool, int, float, str)):
        return a
    if isinstance(a, torch.dtype):
        return str(a).replace("torch.", "")
    return str(a)


def _vals(v) -> list:
    if isinstance(v, torch.Tensor):
        return [{"dtype": str(v.dtype).replace("torch.", ""),
                 "shape": [int(d) for d in v.shape]}]
    if isinstance(v, (list, tuple)):
        return [x for e in v for x in _vals(e)]
    return []


def _target_name(t) -> tuple[str, str]:
    """(namespace, op name) of a node's target."""
    if isinstance(t, torch._ops.OpOverload):
        return t.namespace, t._schema.name.split("::")[-1]
    if isinstance(t, torch._ops.HigherOrderOperator):
        return "higher_order", t.name()
    if t is operator.getitem:
        return "", "getitem"
    return "", getattr(t, "__name__", str(t))


def _kind(node, ns: str, name: str) -> str:
    t = node.target
    if ns == "repro_torch" and name in KERNELS:
        return "kernel"
    if ns == "repro_torch" and name in COLLECTIVES:
        return "collective"
    if ns == "higher_order":
        return "loop" if name in ("scan", "map_impl", "while_loop") \
            else "op"
    if name in _UPDATES:
        return "update"
    if name in _PRODUCTS:
        return "product"
    if isinstance(t, torch._ops.OpOverload) and (
            t.is_view or torch.Tag.pointwise in t.tags):
        return "free"
    if name in _FREE or not isinstance(t, torch._ops.OpOverload):
        return "free"
    return "op"


def _loop(gm, node, name: str) -> dict:
    """A loop node's body records and trip count (None: not known)."""
    if name == "while_loop":
        cond, body = node.args[0], node.args[1]
        return {"loop": "while_loop", "trip": None,
                "body": to_records(getattr(gm, body.target))}
    f = node.args[0]
    xs = node.args[2] if name == "scan" else node.args[1]
    xs = xs if isinstance(xs, (list, tuple)) else [xs]
    trip = int(xs[0].meta["val"].shape[0]) if xs else 0
    return {"loop": name, "trip": trip,
            "body": to_records(getattr(gm, f.target))}


def to_records(gm: torch.fx.GraphModule) -> list[dict]:
    """One dict a node of ``gm`` (:class:`Captured`'s ``gm`` or a loop's
    body): ``name``, ``op`` (placeholder, get_attr, call_function,
    output), ``target``, ``kind`` (placeholder, constant, free, product,
    kernel, collective, update, loop, op, output), ``args`` / ``kwargs``
    (a node as ``{"node": name}``, literals as they are), ``out`` (each
    result tensor's dtype and shape), and for a loop its ``loop``,
    ``trip`` and ``body``."""
    recs = []
    for n in gm.graph.nodes:
        if n.op == "get_attr" and isinstance(getattr(gm, n.target, None),
                                             torch.fx.GraphModule):
            continue  # a loop's body: recorded under the loop
        ns, name = _target_name(n.target) if n.op == "call_function" \
            else ("", n.op)
        kind = {"placeholder": "placeholder", "get_attr": "constant",
                "output": "output"}.get(n.op) or _kind(n, ns, name)
        val = n.meta.get("val")
        if n.op == "get_attr" and val is None:
            val = getattr(gm, n.target, None)
        rec = {"name": n.name, "op": n.op,
               "target": f"{ns}.{name}" if ns else name, "kind": kind,
               "args": _arg(n.args), "kwargs": _arg(n.kwargs),
               "out": _vals(val)}
        if isinstance(n.target, torch._ops.OpOverload):
            if n.target.is_view:
                rec["view"] = True
            writes = [i for i, a in enumerate(n.target._schema.arguments)
                      if a.alias_info is not None and a.alias_info.is_write]
            if writes:
                rec["writes"] = writes
        if kind == "loop":
            rec.update(_loop(gm, n, name))
        recs.append(rec)
    return recs


def written_inputs(records: list[dict]) -> list[int]:
    """The inputs (placeholders, by position) an op of the graph writes in
    place, directly or through a view of them."""
    by = {r["name"]: r for r in records}
    inputs = [r["name"] for r in records if r["kind"] == "placeholder"]
    hit = set()
    for r in records:
        for pos in r.get("writes", ()):
            names = _nodes_in(r["args"][pos]) if pos < len(r["args"]) \
                else []
            cur = by.get(names[0]) if names else None
            while cur is not None and cur.get("view"):
                src = _nodes_in(cur["args"])
                cur = by.get(src[0]) if src else None
            if cur is not None and cur["kind"] == "placeholder":
                hit.add(cur["name"])
    return [i for i, n in enumerate(inputs) if n in hit]


def output_aliases(records: list[dict]) -> list[dict]:
    """Each output that is an input of the graph itself: ``{"output_index",
    "param"}`` (the input's position), XLA's input-output alias map."""
    inputs = {r["name"]: i for i, r in enumerate(
        r for r in records if r["kind"] == "placeholder")}
    out = next(r for r in records if r["kind"] == "output")
    return [{"output_index": i, "param": inputs[n]}
            for i, n in enumerate(_nodes_in(out["args"])) if n in inputs]


def node_count(records: list[dict]) -> int:
    """The nodes of a graph, its loops' bodies included."""
    return sum(1 + node_count(r.get("body", [])) for r in records)


def kernel_nodes(records: list[dict]) -> dict[str, int]:
    """Kernel nodes by library name, each loop's weighted by its trip."""
    out: dict[str, int] = {}
    for r in records:
        if r["kind"] == "kernel":
            lib = r["target"].split(".")[-1]
            out[lib] = out.get(lib, 0) + 1
        elif r["kind"] == "loop":
            for lib, c in kernel_nodes(r["body"]).items():
                out[lib] = out.get(lib, 0) + c * (r["trip"] or 0)
    return out


# ------------------------------------------------------------ the costs
_ITEMSIZE = {"bool": 1, "int8": 1, "uint8": 1, "int16": 2, "int32": 4,
             "int64": 8, "float16": 2, "bfloat16": 2, "float32": 4,
             "float64": 8, "complex64": 8, "float8_e4m3fn": 1,
             "float8_e5m2": 1, "uint16": 2, "uint32": 4, "uint64": 8}


def _nbytes(v: dict) -> int:
    n = _ITEMSIZE.get(v["dtype"], 4)
    for d in v["shape"]:
        n *= d
    return n


def _out_bytes(rec: dict) -> int:
    return sum(_nbytes(v) for v in rec["out"])


def _nodes_in(a) -> list[str]:
    if isinstance(a, dict) and set(a) == {"node"}:
        return [a["node"]]
    if isinstance(a, list):
        return [x for e in a for x in _nodes_in(e)]
    if isinstance(a, dict):
        return [x for e in a.values() for x in _nodes_in(e)]
    return []


def _dtype_of(by: dict, a) -> str | None:
    names = _nodes_in(a)
    rec = by.get(names[0]) if names else None
    return rec["out"][0]["dtype"] if rec and rec["out"] else None


def _shape_of(by: dict, a) -> list[int]:
    rec = by[_nodes_in(a)[0]]
    return rec["out"][0]["shape"]


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


def _product_flops(rec: dict, by: dict) -> tuple[float, str]:
    name = rec["target"].split(".")[-1]
    args = rec["args"]
    out = rec["out"][0]["shape"]
    if name in ("mm", "_int_mm", "bmm", "mv", "dot"):
        a = _shape_of(by, args[0])
    else:  # addmm, baddbmm, addmv, addbmm: (bias, a, b)
        a = _shape_of(by, args[1])
    if name == "convolution":
        w = _shape_of(by, args[1])
        flops = 2.0 * _prod(out) * _prod(w[1:])
        cls = _DTYPE_CLASS.get(_dtype_of(by, args[0]) or "", "f32")
        return flops, cls
    if name == "addbmm":
        flops = 2.0 * a[0] * _prod(out) * a[-1]
    else:
        flops = 2.0 * _prod(out) * a[-1]
    lhs = args[1] if name in ("addmm", "baddbmm", "addmv", "addbmm") \
        else args[0]
    return flops, _DTYPE_CLASS.get(_dtype_of(by, lhs) or "", "f32")


def _kernel_ops(rec: dict, by: dict) -> dict:
    """A kernel node's operations by peak class, from its kernel module's
    formula (the one PERF.md's bound column uses)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.l2r_gemm import kernel as gemm
    from repro_torch.kernels.msdf_ipu import kernel as ipu

    lib = rec["target"].split(".")[-1]
    a = rec["args"]
    if lib == "l2r_stacked_gemm":
        (m, dk), n = _shape_of(by, a[0]), _shape_of(by, a[1])[1]
        d = a[3] // a[4]
        return gemm.stacked_cost(m, dk // d, n, d, a[5], a[6])[0]
    if lib == "l2r_streaming_gemm":
        (m, dk), n = _shape_of(by, a[0]), _shape_of(by, a[1])[1]
        d = a[3] // a[4]
        return gemm.streaming_cost(m, dk // d, n, d,
                                   _shape_of(by, a[2])[0], a[8])[0]
    if lib == "l2r_pairs_gemm":
        (m, k), n = _shape_of(by, a[0]), _shape_of(by, a[1])[1]
        return gemm.pairs_cost(m, k, n, a[2] // a[3], a[4])[0]
    if lib == "cipu_array":
        m, k = _shape_of(by, a[0])
        return ipu.cipu_cost(m, k, a[2])[0]
    dtype = getattr(torch, rec["out"][0]["dtype"])
    if lib == "flash_attention":
        b, sq, h, dh = _shape_of(by, a[0])
        _, skv, kvh, _ = _shape_of(by, a[1])
        return fa.flash_cost(b, sq, skv, h, kvh, dh, a[3], a[4], dtype)[0]
    b, sq, h, _ = _shape_of(by, a[0])  # flash_attention_l2r
    _, skv, kvh, _ = _shape_of(by, a[2])
    return fa.flash_cost(b, sq, skv, h, kvh, a[5], a[9], a[10], dtype,
                         qk_int8=True)[0]


_HOPS = ("_to_copy", "clone", "copy")


def _stored(name: str, by: dict) -> tuple[int, bool]:
    """(bytes of an operand as stored, is it an input or constant of the
    step): through views and casts at most four hops back; a cast from a
    narrower dtype is charged at that dtype (the reference's one-hop
    convert)."""
    cur = by.get(name)
    if cur is None:
        return 0, False
    own = _out_bytes(cur)
    for _ in range(4):
        if cur["kind"] in ("placeholder", "constant"):
            return own, True
        src = _nodes_in(cur["args"])
        if not src or src[0] not in by:
            break
        if cur["target"].split(".")[-1] in _HOPS:
            own = min(own, _out_bytes(by[src[0]]))
        elif not cur.get("view"):
            break
        cur = by[src[0]]
    return own, False


def _zero_coll() -> tuple[dict, dict]:
    return {k: 0.0 for k in _KINDS}, {k: 0 for k in _KINDS}


def _cost(records: list[dict], top: bool) -> tuple:
    by = {r["name"]: r for r in records}
    used = {x for r in records for x in _nodes_in(r["args"])
            + _nodes_in(r["kwargs"])} if top else set()
    flops: dict[str, float] = {}
    bytes_ = 0.0
    weights = 0.0
    coll, coll_n = _zero_coll()

    def add(cls, f):
        flops[cls] = flops.get(cls, 0.0) + f

    for r in records:
        kind = r["kind"]
        if kind in ("placeholder", "constant"):
            if r["name"] in used:  # read once, as the reference's weights
                weights += _out_bytes(r)
            continue
        if kind in ("free", "output"):
            continue
        if kind in ("product", "kernel"):
            if kind == "product":
                f, cls = _product_flops(r, by)
                add(cls, f)
                operands = _nodes_in(r["args"])
            else:
                for cls, f in _kernel_ops(r, by).items():
                    add(cls, float(f))
                name = r["target"].split(".")[-1]
                operands = _nodes_in(r["args"])
                if name in ("l2r_stacked_gemm", "l2r_streaming_gemm"):
                    out_name = operands[2]
                    operands = operands[:2] + operands[3:]
                    # the result it writes (and with out=, reads)
                    bytes_ += _out_bytes(by[out_name])
            seen = set()
            for o in operands:
                if o in seen:
                    continue
                seen.add(o)
                b, weight = _stored(o, by)
                if not weight:
                    bytes_ += b
            bytes_ += _out_bytes(r)
            continue
        if kind == "collective":
            c = r["target"].split(".")[-1]
            kname = COLLECTIVES[c]
            size = _out_bytes(r)
            gsz = r["args"][2 if c == "all_to_all" else 3]
            coll[kname] += ring_wire_bytes(kname, size, gsz)
            coll_n[kname] += 1
            bytes_ += 2.0 * size
            continue
        if kind == "update":
            pos = _UPDATES[r["target"].split(".")[-1]]
            args = r["args"]
            upd = args[pos] if len(args) > pos else None
            names = _nodes_in(upd) if upd is not None else []
            if names:
                bytes_ += 2.0 * _out_bytes(by[names[0]])
            continue
        if kind == "loop":
            if r["trip"] is None:
                raise UnknownTripCount(
                    f"{r['name']}: a {r['loop']} with no known trip count "
                    f"(the graph does not say how often its body runs)")
            f2, b2, _, c2, n2 = _cost(r["body"], False)
            for cls, f in f2.items():
                add(cls, r["trip"] * f)
            bytes_ += r["trip"] * b2
            for k in _KINDS:
                coll[k] += r["trip"] * c2[k]
                coll_n[k] += r["trip"] * n2[k]
            continue
        bytes_ += 2.0 * _out_bytes(r)  # a materialized op: written + read
    return flops, bytes_, weights, coll, coll_n


def analyze(records: list[dict]) -> dict[str, Any]:
    """The reference's cost keys of a captured graph's records
    (:func:`to_records`): ``flops``, ``bytes`` (the step's inputs and
    constants read once included), ``collective_wire_bytes`` and
    ``collective_counts`` by kind, ``total_wire_bytes``; besides them
    ``flops_by_peak`` (the FLOPs by the peak they run at:
    launch/roofline.py:PEAKS) and ``weight_bytes``.  Raises
    :class:`UnknownTripCount` for a loop of unknown trip count."""
    flops, bytes_, weights, coll, coll_n = _cost(records, True)
    return {
        "flops": sum(flops.values()),
        "bytes": bytes_ + weights,
        "collective_wire_bytes": coll,
        "collective_counts": coll_n,
        "total_wire_bytes": sum(coll.values()),
        "flops_by_peak": flops,
        "weight_bytes": weights,
    }


def _collectives(records: list[dict], where: str, in_body: bool
                 ) -> list[dict]:
    by = {r["name"]: r for r in records}
    out = []
    for r in records:
        if r["kind"] == "loop":
            out += _collectives(r["body"], f"{where}/{r['name']}", True)
        if r["kind"] != "collective":
            continue
        c = r["target"].split(".")[-1]
        a = r["args"]
        x = by[_nodes_in(a[0])[0]]
        if c == "all_reduce":
            red, (group, size, count, in_loop, walk, tag) = a[1], a[2:8]
        elif c == "all_gather":
            red, (group, size, count, in_loop, walk, tag) = None, a[2:8]
        else:
            red, (group, size, count, in_loop, walk, tag) = None, a[1:7]
        kind = COLLECTIVES[c]
        result = _out_bytes(r)
        out.append({
            "name": r["name"], "computation": where, "kind": kind,
            "dtype": r["out"][0]["dtype"], "result_bytes": result,
            "wire_bytes": ring_wire_bytes(kind, result, size),
            "group_size": size, "n_groups": count,
            "reduce_op": _REDUCE.get(red, "") if red else "",
            "op_name": tag, "is_async": False,
            # the recorder's fields (sharding/collectives.py:Record)
            "op": c, "port_reduce_op": red, "nbytes": _out_bytes(x),
            "group": group, "in_loop": bool(in_loop),
            "walk": None if walk < 0 else walk, "tag": tag,
            "in_graph_loop": in_body})
    return out


def collective_records(records: list[dict]) -> list[dict]:
    """Every collective node of the graph (a loop's body once, as the
    reference lists a ``while`` body's instructions once), with the
    reference's fields (``name``, ``computation``, ``kind``, ``dtype``,
    ``result_bytes``, ``wire_bytes``, ``group_size``, ``n_groups``,
    ``reduce_op`` as ``add`` / ``maximum`` / ``minimum``, ``op_name``: the
    tag, ``is_async``) and the recorder's (``op``, ``nbytes``, ``group``,
    ``in_loop``, ``walk``, ``tag``)."""
    return _collectives(records, "main", False)


def recorded(crec: dict) -> dict:
    """A :func:`collective_records` record as the recorder records it
    (sharding/collectives.py:Record.to_json, no taint)."""
    return {"op": crec["op"], "reduce_op": crec["port_reduce_op"],
            "dtype": crec["dtype"], "nbytes": crec["nbytes"],
            "group": crec["group"], "group_size": crec["group_size"],
            "in_loop": crec["in_loop"], "walk": crec["walk"],
            "tag": crec["tag"], "taint": None}


# ------------------------------------------------------------ the archive
def save_graph(path: str, records: list[dict]) -> int:
    """Write ``records`` as ``lzma``-compressed JSON (``<cell>.graph.json.xz``);
    returns the bytes written."""
    blob = lzma.compress(json.dumps(records, separators=(",", ":")).encode(),
                         preset=1)
    with open(path, "wb") as fh:
        fh.write(blob)
    return len(blob)


def load_graph(path: str) -> list[dict]:
    """The records :func:`save_graph` wrote."""
    with open(path, "rb") as fh:
        return json.loads(lzma.decompress(fh.read()).decode())
