"""Exactness audit of the L2R walks: a taint walk over one recorded run.

The port of ``repro/analysis/exactness.py``.  The repo's bit-exactness
claims (streaming prefix == truncated stacked, committed token == full
depth, a split run == one process) reduce to one structural invariant:
**between digit-plane extraction and the level accumulator, every op is
exact**.  On the claimed-exact path

* every op is integer-typed (or the guarded f32 fast path below),
* every integer contraction accumulates in at least 32 bits (on the CPU
  ``int8 @ int8`` returns int8 and wraps),
* no float op touches a value derived from the digit planes before the
  integer accumulator is dequantized (``int32 -> float`` is the
  legitimate region exit),
* the only float excursion allowed is the guarded fast path
  (core/l2r_gemm.py:_f32_dot_exact): int8 / int16 digits converted to
  f32 feeding an f32 ``mm`` with TF32 off, whose products fit the f32
  mantissa, converted straight back to an integer.

The reference traces a jaxpr.  The port's walks read the host once a
level (their control flow depends on data), which ``torch.fx`` cannot
trace, so the audit records ONE real run of the entry at small shapes
under a :class:`~torch.utils._python_dispatch.TorchDispatchMode`: it
sees every aten op with its real dtypes and follows Python loops for
free.  Taint lives on a tensor's storage, so a view, a ``.cpu()`` or a
same-dtype copy keeps it (layout ops), and an in-place op merges into
it.  Every tensor the run makes is kept alive until the audit ends, so a
storage is never reused under another value's taint.

The hand-written kernels are ctypes calls the dispatch mode does not
see.  Each one goes through kernels/_build.py:launch, whose hook
:data:`~repro_torch.kernels._build.AUDIT` is None unless an audit
records; the wrapper names the tensors the kernel read and wrote, and
the audit sees the kernel as ONE opaque node (the reference sees a
Pallas call so in ``kernel-int`` mode): its integer operands must be
int8 or int16 and its accumulator outputs int32.  A ``kernel-int``
entry that launched no kernel (a plain version ran instead) is a
violation.

The f32 rule on the card: an f32 ``mm`` or convolution on the path is a
violation when TF32 is allowed at that op
(``torch.backends.cuda.matmul.allow_tf32`` /
``torch.backends.cudnn.allow_tf32`` as the op is recorded), when one of
its float operands is not an int8 / int16 digit converted to f32, or
when the guard fails for the contract's K.  A bf16 or f16 contraction
on the path is always a violation.

Taint per storage: None (not derived from the digit stream), ``"int"``
(on the exact integer path), ``"f32exact"`` (inside the guarded fast
path: only layout ops, the guarded product and the convert back to an
integer are allowed).  Exits: ``int32 / int64 -> float`` (the
dequantization, also when an arithmetic op promotes the accumulator),
comparisons (bool decisions), and argmax / argmin (index decisions).

The reference's ``audit_hlo_text`` re-checks XLA's compiled module after
its rewrites.  Its counterpart, :func:`audit_graph`, re-checks a claimed
entry's captured ATen graph (launch/graph_analysis.py): the only float
contractions in it are f32, and those only where the contract's guard
holds.  Eager torch runs the ops it records, so the graph holds the ops
the taint walk saw; the graph check is the artifact-level one.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.l2r_gemm import _f32_dot_exact
from repro_torch.core.online import msdf_level_slices
from repro_torch.kernels import _build

__all__ = [
    "ExactnessContract",
    "Violation",
    "ExactnessReport",
    "f32_guard_holds",
    "audit_exactness",
    "audit_graph",
    "tensors_of",
]

#: value-preserving / value-selecting ops: the only ops (besides the
#: guarded product and the converts) allowed to touch fast-path f32
#: values — they move digits around without rounding
_LAYOUT = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
    "slice", "select", "index", "index_select", "gather", "cat", "stack",
    "clone", "alias", "squeeze", "unsqueeze", "flip", "narrow",
    "constant_pad_nd", "copy", "copy_", "detach", "where", "_to_copy",
    "lift_fresh", "lift_fresh_copy", "as_strided", "unbind", "split",
    "split_with_sizes", "chunk", "contiguous", "repeat", "roll", "movedim",
    "_reshape_alias", "unfold", "masked_fill",
}

#: contractions: integer ones must accumulate in >= 32 bits, float ones
#: are the guarded fast path or a violation
_MM = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
       "vdot", "_int_mm", "linear"}
_CONV = {"convolution", "_convolution", "conv1d", "conv2d", "conv3d",
         "cudnn_convolution"}

#: index decisions: outputs are positions, not accumulator values
_DECISION = {"argmax", "argmin"}
#: (values, indices) ops: the indices are decisions
_WITH_INDICES = {"max", "min", "topk", "sort", "kthvalue", "mode", "median",
                 "nanmedian", "cummax", "cummin"}
#: arithmetic whose type promotion of an int32 / int64 accumulator to
#: float is the dequantization (jnp inserts an explicit convert there)
_PROMOTING = {"mul", "div", "add", "sub", "rsub", "true_divide"}

_LOW_FLOATS = (torch.bfloat16, torch.float16)


def f32_guard_holds(n_bits: int, log2_radix: int, k: int,
                    levels: int | None = None) -> bool:
    """Recompute the f32 fast-path guard for a walk's widest level."""
    d = n_bits // log2_radix
    slices = msdf_level_slices(d, levels)
    if not slices:
        return True
    width = max(hi - lo + 1 for _, lo, hi in slices)
    return _f32_dot_exact(k, width, log2_radix)


@dataclasses.dataclass(frozen=True)
class ExactnessContract:
    """What a claimed-exact entry point promises.

    ``mode="taint"`` is the forward-taint audit of the plain walks;
    ``mode="kernel-int"`` additionally requires the run to have gone
    through at least one hand-written kernel node (the reference scans
    its Pallas bodies for float ops in that mode; the port's kernels are
    opaque, and their node rule holds in both modes).  ``allow_f32``
    permits the guarded fast path — the auditor still recomputes the
    guard from (k, levels) and rejects f32 products when it fails.
    """

    n_bits: int = 8
    log2_radix: int = 2
    k: int = 0
    levels: int | None = None
    allow_f32: bool = True
    mode: str = "taint"  # taint | kernel-int

    @property
    def f32_ok(self) -> bool:
        return self.allow_f32 and f32_guard_holds(
            self.n_bits, self.log2_radix, self.k, self.levels)


@dataclasses.dataclass(frozen=True)
class Violation:
    entry: str
    primitive: str
    reason: str
    detail: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ExactnessReport:
    entry: str
    violations: list
    eqns_checked: int = 0
    tainted_eqns: int = 0
    int_dots: int = 0
    f32_fastpath_dots: int = 0
    kernel_nodes: dict = dataclasses.field(default_factory=dict)
    #: what the audited run returned (not part of the JSON report)
    output: object = dataclasses.field(default=None, repr=False,
                                       compare=False)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        return {
            "entry": self.entry, "ok": self.ok,
            "eqns_checked": self.eqns_checked,
            "tainted_eqns": self.tainted_eqns,
            "int_dots": self.int_dots,
            "f32_fastpath_dots": self.f32_fastpath_dots,
            "kernel_nodes": dict(self.kernel_nodes),
            "violations": [v.to_json() for v in self.violations],
        }


# ------------------------------------------------------------------ util
def tensors_of(tree) -> list[torch.Tensor]:
    """The tensors of a nest of tuples, lists, dicts, named tuples and
    dataclasses (PlaneOperands, QuantizedWeights), in order."""
    out: list[torch.Tensor] = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif dataclasses.is_dataclass(t) and not isinstance(t, type):
            for f in dataclasses.fields(t):
                walk(getattr(t, f.name))

    walk(tree)
    return out


def _is_int(dt: torch.dtype) -> bool:
    return not dt.is_floating_point and not dt.is_complex \
        and dt != torch.bool


_RANKS = {"int": 3, "f32exact": 2, "deq": 1, None: 0}


def _merge(a, b):
    return a if _RANKS[a] >= _RANKS[b] else b


def _dt(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


# ------------------------------------------------------------ taint walk
class _Recorder(TorchDispatchMode):
    def __init__(self, auditor: "_Auditor"):
        super().__init__()
        self.aud = auditor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.aud.op(func, args, kwargs, out)
        return out


class _Auditor:
    """One recorded run: taint per storage, the rules per op."""

    def __init__(self, contract: ExactnessContract, entry: str):
        self.c = contract
        self.entry = entry
        self.rep = ExactnessReport(entry=entry, violations=[])
        self.taint: dict = {}
        self.keep: list = []  # every tensor of the run, alive to the end

    # ---- taint per storage
    @staticmethod
    def _key(x: torch.Tensor):
        if x.device.type == "meta" or x.numel() == 0:
            return None
        return (x.device.type, x.device.index,
                x.untyped_storage().data_ptr())

    def taint_of(self, x: torch.Tensor):
        key = self._key(x)
        return None if key is None else self.taint.get(key)

    def _write(self, x: torch.Tensor, t) -> None:
        key = self._key(x)
        if key is None:
            return
        self.keep.append(x)
        if t is not None:
            self.taint[key] = _merge(self.taint.get(key), t)

    def dequant_taint(self):
        """Taint past the dequantization exit: None here (the region
        ends); the sharding auditor keeps ``"deq"`` provenance."""
        return None

    def flag(self, prim: str, reason: str, ins=(), outs=()) -> None:
        self.rep.violations.append(Violation(
            entry=self.entry, primitive=prim, reason=reason,
            detail=f"in=({','.join(_dt(x.dtype) for x in ins)}) "
                   f"out=({','.join(_dt(x.dtype) for x in outs)})"))

    # ---- the run
    def run(self, fn: Callable, args: tuple):
        """``fn(*args)`` under the recorder; every integer tensor of
        ``args`` seeds the taint (the walks take quantized operands and
        plane stacks)."""
        if _build.AUDIT is not None:
            raise RuntimeError("an exactness audit is already recording")
        for x in tensors_of(args):
            self._write(x, "int" if _is_int(x.dtype) else None)
        _build.AUDIT = self.kernel
        try:
            with self.context(), _Recorder(self):
                return fn(*args)
        finally:
            _build.AUDIT = None

    def context(self):
        """A context the run is recorded in (the sharding auditor's
        collective recording)."""
        return contextlib.nullcontext()

    # ---- one kernel launch: an opaque node
    def kernel(self, name: str, reads: tuple, writes: tuple) -> None:
        self.rep.eqns_checked += 1
        self.rep.kernel_nodes[name] = self.rep.kernel_nodes.get(name, 0) + 1
        in_t = [self.taint_of(x) for x in reads]
        tainted = any(t is not None for t in in_t)
        if not tainted:
            for x in writes:
                self._write(x, None)
            return
        self.rep.tainted_eqns += 1
        for x in reads:
            if x.dtype.is_floating_point:
                self.flag(name, "float operand in an all-integer kernel "
                                "node", reads, writes)
            elif x.dtype not in (torch.int8, torch.int16):
                self.flag(name, f"kernel operand is {_dt(x.dtype)}: the "
                                f"digit-plane kernels take int8 / int16 "
                                f"operands", reads, writes)
        for x in writes:
            if x.dtype == torch.int32:
                self.rep.int_dots += 1
                self._write(x, "int")
            elif _is_int(x.dtype):
                self.flag(name, f"kernel accumulator output is "
                                f"{_dt(x.dtype)}, not int32", reads, writes)
                self._write(x, "int")
            else:
                self.flag(name, "kernel writes a float from digit-stream "
                                "operands (not an all-integer node)",
                          reads, writes)
                self._write(x, self.dequant_taint())

    # ---- one aten op
    def op(self, func, args, kwargs, out) -> None:
        self.rep.eqns_checked += 1
        name = func.overloadpacket.__name__
        ins = tensors_of((args, kwargs))
        outs = tensors_of(out)
        if name in ("copy_", "copy") and len(ins) >= 2:
            ins = ins[1:2]  # the source; the destination is the output
        in_t = [self.taint_of(x) for x in ins]
        taints = self.op_taint(name, ins, in_t, outs, out)
        for x, t in zip(outs, taints):
            self._write(x, t)

    def op_taint(self, name: str, ins, in_t, outs, out) -> list:
        n_out = len(outs)
        any_int = "int" in in_t
        any_f32x = "f32exact" in in_t
        if not (any_int or any_f32x):
            return [None] * n_out
        self.rep.tainted_eqns += 1

        if name in ("_to_copy", "copy_", "copy") and ins and outs \
                and ins[0].dtype != outs[0].dtype:
            return [self.convert(name, ins[0], outs[0], any_int)]

        if name in _MM or name in _CONV:
            return [self.contraction(name, ins, in_t, outs, any_int,
                                     any_f32x)] * n_out

        if all(x.dtype == torch.bool for x in outs):
            return [None] * n_out  # comparisons: decision exit
        if name in _DECISION:
            return [None] * n_out  # index decisions: exit
        if name in _WITH_INDICES and isinstance(out, (tuple, list)) \
                and n_out == 2:
            first = self.op_taint("_values", ins, in_t, outs[:1], out[0])
            return first + [None]

        if any_f32x and not any_int:
            if name in _LAYOUT:
                return ["f32exact" if x.dtype == torch.float32 else None
                        for x in outs]
            self.flag(name, "inexact op on a guarded f32 fast-path value",
                      ins, outs)
            return [None] * n_out

        # integer path: int-out ops propagate, float-out ops are the bug
        taints = []
        for x in outs:
            if _is_int(x.dtype):
                taints.append("int")
            elif x.dtype.is_floating_point:
                wide = all(y.dtype.itemsize >= 4
                           for y, t in zip(ins, in_t) if t == "int")
                if name in _PROMOTING and wide:
                    # the accumulator promoted to float: dequantized
                    taints.append(self.dequant_taint())
                    continue
                self.flag(name, "float-producing op on the claimed-exact "
                                "integer path", ins, outs)
                taints.append(None)
            else:
                taints.append(None)
        return taints

    def convert(self, name: str, src: torch.Tensor, dst: torch.Tensor,
                any_int: bool):
        sdt, ddt = src.dtype, dst.dtype
        if any_int:
            if _is_int(ddt) or ddt == torch.bool:
                return "int"
            if sdt.itemsize >= 4:
                return self.dequant_taint()  # the accumulator dequantized
            if self.c.f32_ok and ddt == torch.float32:
                return "f32exact"
            self.flag(name, f"digit-stream int converted to {_dt(ddt)} "
                            f"outside the guarded f32 fast path", (src,),
                      (dst,))
            # still the digits: a product of them is flagged in its turn
            return "f32exact" if ddt in _LOW_FLOATS else None
        if _is_int(ddt):
            return "int"  # the fast path's accumulator back to an integer
        if ddt == torch.float32:
            return "f32exact"
        self.flag(name, f"guarded f32 fast-path value converted to "
                        f"{_dt(ddt)} (loses exactness)", (src,), (dst,))
        return None

    def contraction(self, name: str, ins, in_t, outs, any_int: bool,
                    any_f32x: bool):
        if any_int and any_f32x:
            self.flag(name, "contraction mixes integer-path and "
                            "f32-fast-path operands", ins, outs)
            return None
        out_dt = outs[0].dtype if outs else None
        if any_int:
            if all(_is_int(x.dtype) for x in ins) and out_dt is not None \
                    and _is_int(out_dt) and out_dt.itemsize >= 4:
                self.rep.int_dots += 1
                return "int"
            self.flag(name, "integer contraction without int32 "
                            "accumulation (the output is "
                            f"{_dt(out_dt) if out_dt else '?'})", ins, outs)
            return None
        floats = [(x, t) for x, t in zip(ins, in_t)
                  if x.dtype.is_floating_point]
        if any(x.dtype in _LOW_FLOATS for x, _ in floats) \
                or out_dt in _LOW_FLOATS:
            self.flag(name, "bf16/f16 contraction on the claimed-exact path "
                            "(sub-f32 floats round digit products)", ins,
                      outs)
            return None
        tf32 = torch.backends.cudnn.allow_tf32 if name in _CONV \
            else torch.backends.cuda.matmul.allow_tf32
        ok = True
        if tf32:
            self.flag(name, "f32 fast-path contraction with TF32 allowed "
                            "(not bit-exact)", ins, outs)
            ok = False
        if any(t != "f32exact" for _, t in floats):
            self.flag(name, "f32 fast-path contraction whose operands are "
                            "not int8/int16 digits converted to f32", ins,
                      outs)
            ok = False
        if not self.c.f32_ok:
            self.flag(name, "f32 contraction but the f32 fast-path guard "
                            "does not hold for this contract", ins, outs)
            ok = False
        if ok:
            self.rep.f32_fastpath_dots += 1
            return "f32exact"
        return None

    def finish(self) -> None:
        if self.c.mode == "kernel-int" and not self.rep.kernel_nodes:
            self.rep.violations.append(Violation(
                entry=self.entry, primitive="kernel",
                reason="kernel-int entry launched no kernel: its run took "
                       "a plain version"))


# ------------------------------------------------------------ public API
def audit_exactness(fn: Callable, args: tuple,
                    contract: ExactnessContract,
                    entry: str = "") -> ExactnessReport:
    """Run ``fn(*args)`` once under the recorder and audit what ran
    against ``contract``.  The result of the run is ``report.output``."""
    name = entry or getattr(fn, "__name__", "<fn>")
    aud = _Auditor(contract, name)
    aud.rep.output = aud.run(fn, args)
    aud.finish()
    aud.keep.clear()
    return aud.rep


def audit_graph(records: list, contract: ExactnessContract,
                entry: str = "<graph>") -> list[Violation]:
    """The counterpart of the reference's ``audit_hlo_text`` on a captured
    graph's records (launch/graph_analysis.py:to_records): every float
    contraction (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolution,
    ...), loop bodies included, must be f32 (a bf16 / f16 one silently
    rounds digit products), and an f32 one is allowed only where the
    contract's f32 guard holds.  Integer contractions and kernel nodes
    (integer by construction, opaque) pass."""
    violations: list[Violation] = []

    def walk(recs, where):
        for r in recs:
            if r.get("body"):
                walk(r["body"], f"{where}/{r['name']}")
            name = r["target"].split(".")[-1]
            if r["kind"] != "product" or not r["out"]:
                continue
            dt = getattr(torch, r["out"][0]["dtype"])
            if not dt.is_floating_point:
                continue  # integer contraction: exact by construction
            if dt != torch.float32:
                violations.append(Violation(
                    entry=entry, primitive=name,
                    reason=f"captured graph contains a {_dt(dt)} "
                           f"contraction (sub-f32 floats round digit "
                           f"products)", detail=f"{where}::{r['name']}"))
            elif not contract.f32_ok:
                violations.append(Violation(
                    entry=entry, primitive=name,
                    reason="captured graph contains an f32 contraction but "
                           "the f32 fast-path guard does not hold for this "
                           "contract", detail=f"{where}::{r['name']}"))

    walk(records, "main")
    return violations
