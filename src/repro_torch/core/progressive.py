"""Streaming progressive precision: the MSDF prefix stream and its folds.

The port of ``repro/core/progressive.py``.  The walk over
significance levels s = 2D-2 .. 0, most significant first, emits after
every level a prefix that is bit-identical to the stacked schedule
truncated at that depth (``l2r_matmul_int_stacked(..., levels=t+1)``).
Consumers fold over the stream (``fold(carry, partial, level_index)``)
and may stop it early once their decision is made.

Two control flows share the per-level arithmetic:

* :func:`streaming_matmul_scan` runs every level (the oracle);
* :func:`streaming_matmul_while` stops once ``done_fn(carry)`` is true.

Routes follow the operands' device; there is no backend switch:

* **CPU tensors** take the reference's plain walk: both operands as
  raw-digit plane stacks zero-padded by D-1 blocks, one fixed-width
  window dot per level (true f32 under the exactness guard, int64
  narrowed to int32 otherwise), shifted and added in wrapping int32.
* **CUDA tensors** take the :class:`LevelWalk` the caller passes as
  ``cuda_walk`` (the kernels' walk is
  ``repro_torch.kernels.l2r_gemm.ops.CUDA_WALK``; this module imports
  no kernel), and raise without one.  With the kernels' walk the scan
  is ONE launch of kernel B2, which writes all L snapshot planes; the
  fold then runs over them on the card.  So on the card the scan holds
  the L planes at once (L*M*N*4 bytes: 7*8*1000*4 B = 224 KB for the
  VGG-16 fc8 head at batch 8), where the reference carries only the
  accumulator.  The while loop runs one level per iteration (one
  launch of kernel B1 over that level's slab into a copy of the running
  accumulator), then the fold, then one host read of the done flag
  (``bool(done_fn(carry))``, a device sync), at most once per level.

Decision bounds: :func:`level_bounds` gives per-level hard bounds on the
unseen tail (core/online.py:tail_bound) as an up-rounded float32, an
int32 with an exactness guard (``decidable``) and Python ints.

Under a mesh (launch/mesh.py) :func:`streaming_argmax` runs the
reference's consensus walk on ``torch.distributed``: each rank walks its
rows against its slice of the columns and the decision fold reduces
across ranks (:func:`sharded_walk_axes`, :func:`_streaming_argmax_sharded`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.device import no_tf32
from repro_torch.sharding import ctx
from repro_torch.sharding.axes import dp_axes
from repro_torch.sharding.collectives import (TAG_GATHER, all_gather,
                                              level_loop, tag)

from .l2r_gemm import _f32_dot_exact, _int_dot, wrap_int32
from .online import msdf_levels, tail_bound
from .policy import LevelPolicy, decision_state, head_walk_machinery
from .quant import PlaneOperands, plane_count

__all__ = [
    "ProgressiveResult",
    "LevelBounds",
    "LevelWalk",
    "level_bounds",
    "progressive_matmul",
    "streaming_matmul_scan",
    "streaming_matmul_while",
    "l2r_matmul_int_streaming",
    "streaming_argmax",
    "sharded_walk_axes",
    "sharded_walk_collectives",
    "decision_state",
    "earliest_decision_level",
    "scan_plain",
]

# int32 decision clip: bounds above this cannot be compared exactly in
# int32 (2*bound must not overflow), so those levels are undecidable
_BOUND_CLIP = (2**31 - 1) // 2


class ProgressiveResult(NamedTuple):
    """Stacked per-level prefix results of the MSDF stream.

    partial:    (L, ..., M, N) int32 prefix sums; level l holds the top
                l+1 significance levels.
    tail_bound: (L,) float32 hard bound on |exact - partial[l]|, rounded
                toward +inf.
    bound_i32:  (L,) int32, the same bound where it fits the int32
                decision range (clipped otherwise).
    decidable:  (L,) bool, True iff bound_i32 is the exact bound.
    """

    partial: torch.Tensor
    tail_bound: torch.Tensor
    bound_i32: torch.Tensor
    decidable: torch.Tensor


class LevelWalk(NamedTuple):
    """The level walk on CUDA operands (either may be a
    :class:`PlaneOperands`), given by the caller.

    stream:  ``stream(aq, bq, n_bits, log2_radix, levels)`` -> the
             ``(L, ..., M, N)`` int32 prefix stream, every level at once
             (the scan).
    stepper: ``stepper(aq, bq, n_bits, log2_radix, levels)`` ->
             ``advance(acc, t)``, the prefix after level t from the
             prefix before it, as a new tensor (the while loop).
    """

    stream: Callable
    stepper: Callable


class LevelBounds(NamedTuple):
    """Per-level tail bounds in the three dtypes consumers need."""

    f32: torch.Tensor        # (L,) float32, rounded toward +inf
    i32: torch.Tensor        # (L,) int32, clipped at the decision range
    decidable: torch.Tensor  # (L,) bool, True iff i32 is exact
    exact: tuple             # Python ints (host-side reporting)


def _f32_up(b: int) -> np.float32:
    """Smallest float32 >= the exact integer bound (inf if out of range)."""
    v = np.float32(b)
    if np.isinf(v):
        return v
    if int(v) < b:
        v = np.nextafter(v, np.float32(np.inf))
    return v


def level_bounds(d: int, log2_radix: int, k: int, levels: int | None = None,
                 device: str | torch.device = "cpu") -> LevelBounds:
    """Hard tail bounds after each of the first ``levels`` MSDF levels,
    as tensors on ``device``."""
    n_levels = len(msdf_levels(d)[:levels])
    exact = tuple(tail_bound(d, t + 1, log2_radix, k)
                  for t in range(n_levels))
    f32 = np.asarray([_f32_up(b) for b in exact], np.float32)
    fits = np.asarray([b <= _BOUND_CLIP for b in exact], bool)
    i32 = np.asarray([b if f else _BOUND_CLIP for b, f in zip(exact, fits)],
                     np.int32)
    return LevelBounds(*(torch.from_numpy(x).to(device)
                         for x in (f32, i32, fits)), exact)


# ------------------------------------------------------- streaming emitter
def _contract_k(x) -> int:
    """Contraction length of a raw operand or a pre-stacked PlaneOperands."""
    return x.k if isinstance(x, PlaneOperands) else x.shape[-1]


def _lhs_lead(aq) -> tuple[int, ...]:
    """Leading (…, M) output shape contributed by the LHS operand."""
    return tuple(aq.stack.shape[:-1] if isinstance(aq, PlaneOperands)
                 else aq.shape[:-1])


def _rhs_n(bq) -> int:
    return bq.stack.shape[-1] if isinstance(bq, PlaneOperands) \
        else bq.shape[-1]


def _device(x) -> torch.device:
    return x.stack.device if isinstance(x, PlaneOperands) else x.device


def _check_operands(aq, bq, n_bits: int, log2_radix: int) -> None:
    """A stack built for another digit config or side would walk the
    level schedule wrong: refuse it."""
    for op, want, other in ((aq, "lhs", bq), (bq, "rhs", aq)):
        if isinstance(op, PlaneOperands) \
                and not op.matches(n_bits, log2_radix, side=want):
            other_desc = other.describe() if isinstance(other, PlaneOperands) \
                else f"tensor(shape={tuple(other.shape)}, dtype={other.dtype})"
            raise ValueError(
                f"{op.describe()} cannot feed the {want} slot "
                f"of a streaming walk with n_bits={n_bits}, "
                f"log2_radix={log2_radix} (other operand: {other_desc}); "
                f"re-prepare the stack for this config")


def _streaming_operands(aq, bq, n_bits: int, log2_radix: int):
    """Zero-padded raw-digit plane stacks of the plain fixed-width walk.
    A :class:`PlaneOperands` side feeds its window stack directly, the
    very stack inline extraction builds."""
    if not isinstance(aq, PlaneOperands):
        aq = PlaneOperands.prepare_lhs(aq, n_bits, log2_radix)
    if not isinstance(bq, PlaneOperands):
        bq = PlaneOperands.prepare_rhs(bq, n_bits, log2_radix)
    return aq.window_stack(), bq.window_stack()


def _cuda_route(aq, cuda_walk: LevelWalk | None) -> LevelWalk | None:
    """The walk the operands take: None (the plain walk) off CUDA, else
    the caller's ``cuda_walk``; CUDA operands without one raise."""
    if _device(aq).type != "cuda":
        return None
    if cuda_walk is None:
        raise ValueError(
            "CUDA operands take the kernels' level walk: pass "
            "cuda_walk=repro_torch.kernels.l2r_gemm.ops.CUDA_WALK")
    return cuda_walk


def _level_walk(d: int, levels: int | None):
    """Per-step (a_off, b_off, s) block offsets of the fixed-width window.

    Level s reads LHS blocks [i_lo, i_lo+D) and RHS (reversed) blocks
    [d-1-s+i_lo, d-1-s+i_lo+D); the window positions past the level's
    true pair range hit zero padding on exactly one side.
    """
    svals = msdf_levels(d)[:levels]
    a_off = [max(0, s - d + 1) for s in svals]
    b_off = [d - 1 - s + a for s, a in zip(svals, a_off)]
    return a_off, b_off, svals


def _stream_setup(aq, bq, n_bits: int, log2_radix: int):
    """The plain walk's per-level term ``term(ao, bo) -> int32``: the
    window dot both control flows call, same slices and same dtypes."""
    d = plane_count(n_bits, log2_radix)
    k = _contract_k(aq)
    a_pad, b_pad = _streaming_operands(aq, bq, n_bits, log2_radix)
    # a window spans up to D real pairs: the f32 guard for depth D*K
    use_f32 = _f32_dot_exact(k, d, log2_radix)
    if use_f32:
        a_pad = a_pad.to(torch.float32)
        b_pad = b_pad.to(torch.float32)
    w = d * k

    def term(ao: int, bo: int) -> torch.Tensor:
        return _window_dot(a_pad[..., ao * k:ao * k + w],
                           b_pad[bo * k:bo * k + w])

    return term


def _window_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One level's window contraction as int32: a true-f32 dot when the
    operands were cast to f32 under the exactness guard, else an int64
    dot narrowed to int32 (the reference's wrapping int32 dot)."""
    if a.is_floating_point():
        with no_tf32():
            return torch.matmul(a, b).to(torch.int32)
    return wrap_int32(_int_dot(a, b))


def _shift_add(acc: torch.Tensor, term: torch.Tensor, shift: int
               ) -> torch.Tensor:
    """``acc + (term << shift)`` in wrapping int32, as the reference's
    int32 arithmetic (computed in int64, narrowed on purpose)."""
    return wrap_int32(acc.to(torch.int64) + (term.to(torch.int64) << shift))


def scan_plain(aq, bq, fold: Callable | None = None, init=None,
               n_bits: int = 8, log2_radix: int = 2,
               levels: int | None = None, emit: bool = False):
    """The plain scan on any device: the reference's fixed-width window
    walk (the CPU route of :func:`streaming_matmul_scan`, and kernel B2's
    plain version on any device)."""
    a_off, b_off, svals = _level_walk(plane_count(n_bits, log2_radix),
                                      levels)
    acc = torch.zeros((*_lhs_lead(aq), _rhs_n(bq)), dtype=torch.int32,
                      device=_device(aq))
    fold_c, snaps = init, []
    if svals:
        term = _stream_setup(aq, bq, n_bits, log2_radix)
    with level_loop():
        for t, (ao, bo, s) in enumerate(zip(a_off, b_off, svals)):
            acc = _shift_add(acc, term(ao, bo), log2_radix * s)
            if fold is not None:
                fold_c = fold(fold_c, acc, t)
            if emit:
                snaps.append(acc)
    stack = None
    if emit:
        stack = torch.stack(snaps) if snaps else \
            torch.zeros((0, *acc.shape), dtype=torch.int32, device=acc.device)
    return acc, fold_c, stack


def streaming_matmul_scan(
    aq,
    bq,
    fold: Callable | None = None,
    init=None,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
    emit: bool = False,
    cuda_walk: LevelWalk | None = None,
):
    """Scan the per-level MSDF prefix stream, folding over every prefix.

    ``fold(carry, partial, level_index) -> carry`` consumes each prefix.
    With ``emit=True`` the per-level prefixes are also returned stacked
    (``(L, …, M, N)``).  Returns ``(final_partial, final_fold_carry,
    stack_or_None)``; each prefix is bit-identical to
    ``l2r_matmul_int_stacked(..., levels=t+1)``.  Either operand may be
    a pre-stacked :class:`PlaneOperands`.

    CUDA tensors take ``cuda_walk.stream`` (with the kernels' walk, one
    launch of kernel B2), and the fold runs over its L planes (all held
    at once, see the module docstring).
    """
    _check_operands(aq, bq, n_bits, log2_radix)
    walk = _cuda_route(aq, cuda_walk)
    if walk is None:
        return scan_plain(aq, bq, fold, init, n_bits, log2_radix, levels,
                          emit)
    stream = walk.stream(aq, bq, n_bits, log2_radix, levels)
    lead, n = _lhs_lead(aq), _rhs_n(bq)
    fold_c = init
    if fold is not None:
        with level_loop():
            for t in range(stream.shape[0]):
                fold_c = fold(fold_c, stream[t], t)
    if stream.shape[0] == 0:
        acc = torch.zeros((*lead, n), dtype=torch.int32,
                          device=stream.device)
    else:
        acc = stream[-1] if emit else stream[-1].clone()
    return acc, fold_c, (stream if emit else None)


def _while_emitter(advance: Callable, n_steps: int, acc0: torch.Tensor,
                   fold: Callable | None, init, done_fn: Callable | None):
    """The early-exit level loop shared by the GEMM and the fused conv:
    ``advance(acc, t)`` adds level t, the fold runs, and the done flag is
    read on the host before each further level.  Returns ``(levels_run,
    acc, fold_carry)``."""
    t, acc, fold_c = 0, acc0, init
    with level_loop():
        while t < n_steps and not (done_fn is not None
                                   and bool(done_fn(fold_c))):
            acc = advance(acc, t)
            if fold is not None:
                fold_c = fold(fold_c, acc, t)
            t += 1
    return t, acc, fold_c


def _plain_stepper(aq, bq, n_bits: int, log2_radix: int,
                   levels: int | None) -> Callable:
    """``advance(acc, t)`` of the plain walk: the prefix after level t
    from the prefix before it (a new tensor; the fold may keep the old
    one)."""
    a_off, b_off, svals = _level_walk(plane_count(n_bits, log2_radix),
                                      levels)
    term = _stream_setup(aq, bq, n_bits, log2_radix)
    return lambda acc, t: _shift_add(acc, term(a_off[t], b_off[t]),
                                     log2_radix * svals[t])


def streaming_matmul_while(
    aq,
    bq,
    fold: Callable | None = None,
    init=None,
    done_fn: Callable | None = None,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
    cuda_walk: LevelWalk | None = None,
):
    """Early-exit streaming emitter: the same level walk as
    :func:`streaming_matmul_scan`, stopping as soon as
    ``done_fn(fold_carry)`` is true.  With ``done_fn=None`` every level
    runs.  After ``levels_run`` levels the accumulator is bit-identical
    to the scan's prefix at that depth, and so are the fold's decisions.
    CUDA tensors take ``cuda_walk.stepper`` (with the kernels' walk, one
    B1 launch per level).

    Returns ``(partial, fold_carry, levels_run)`` (``levels_run`` an int).
    """
    _check_operands(aq, bq, n_bits, log2_radix)
    walk = _cuda_route(aq, cuda_walk)
    n_steps = len(msdf_levels(plane_count(n_bits, log2_radix))[:levels])
    acc0 = torch.zeros((*_lhs_lead(aq), _rhs_n(bq)), dtype=torch.int32,
                       device=_device(aq))
    if n_steps == 0:  # levels=0: empty MSDF prefix
        return acc0, init, 0
    stepper = _plain_stepper if walk is None else walk.stepper
    advance = stepper(aq, bq, n_bits, log2_radix, levels)
    t, acc, fold_c = _while_emitter(advance, n_steps, acc0, fold, init,
                                    done_fn)
    return acc, fold_c, t


def l2r_matmul_int_streaming(aq, bq, n_bits: int = 8, log2_radix: int = 2,
                             levels: int | None = None,
                             early_exit: bool = False,
                             cuda_walk: LevelWalk | None = None
                             ) -> torch.Tensor:
    """Final (or ``levels``-truncated) result via the streaming schedule,
    bit-identical to ``l2r_matmul_int_stacked``.  ``early_exit=True``
    runs the while emitter (with no fold it still runs every level)."""
    if early_exit:
        acc, _, _ = streaming_matmul_while(aq, bq, None, None, None,
                                           n_bits, log2_radix, levels,
                                           cuda_walk)
        return acc
    acc, _, _ = streaming_matmul_scan(aq, bq, None, None, n_bits,
                                      log2_radix, levels,
                                      cuda_walk=cuda_walk)
    return acc


def progressive_matmul(aq, bq, n_bits: int = 8, log2_radix: int = 2,
                       levels: int | None = None,
                       cuda_walk: LevelWalk | None = None
                       ) -> ProgressiveResult:
    """Full per-level snapshot stack of the MSDF stream with its tail
    bounds (on CUDA tensors ``cuda_walk.stream``: with the kernels'
    walk, one launch of kernel B2)."""
    _, _, stack = streaming_matmul_scan(aq, bq, None, None, n_bits,
                                        log2_radix, levels, emit=True,
                                        cuda_walk=cuda_walk)
    bounds = level_bounds(plane_count(n_bits, log2_radix), log2_radix,
                          _contract_k(aq), levels, device=stack.device)
    return ProgressiveResult(partial=stack, tail_bound=bounds.f32,
                             bound_i32=bounds.i32, decidable=bounds.decidable)


# ------------------------------------------------------ decision machinery
def streaming_argmax(
    xq,
    wq,
    xs: torch.Tensor,
    ws: torch.Tensor,
    n_bits: int = 8,
    log2_radix: int = 2,
    levels: int | None = None,
    bias: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.float32,
    safety: float = 1e-5,
    early_exit: bool = False,
    policy: LevelPolicy | None = None,
    cuda_walk: LevelWalk | None = None,
    mesh=None,
):
    """Stream a quantized classifier/LM-head matmul, committing the argmax
    of the *dequantized* scores at the earliest sound level.

    xq (M, K) int row activations with per-row scales xs (M, 1); wq (K, N)
    int weights with per-out-channel scales ws (1, N); either side may be
    a pre-stacked :class:`PlaneOperands`.  ``levels`` truncates the
    stream.  The decision runs in the scaled domain with the per-entry
    bound ``tail * xs * ws`` widened by a relative ``safety`` and a few
    ulps of the row's largest score.  Undecided rows fall back to the
    final argmax, so the committed index always equals the
    full-precision (or ``levels``-truncated) argmax.

    ``early_exit=True`` runs the while emitter, which stops once every
    row has decided: tokens and exit levels are bit-identical to the
    scan, and the logits are the dequantized prefix at the exit level.
    With ``early_exit=False`` the logits reproduce ``l2r_matmul_f``'s
    dequantization bit for bit.  ``policy`` gives each row its own
    precision class (core/policy.py).  CUDA operands need ``cuda_walk``
    (``repro_torch.kernels.l2r_gemm.ops.CUDA_WALK``).

    Returns ``(logits (M, N) out_dtype, tok (M,) int32, exit_level (M,)
    int32)``; exit_level L-1 means the full stream.

    **Sharded walk.**  With a mesh (``mesh=``, else the installed one,
    sharding/ctx.py) whose ``model`` axis divides N or whose data axes
    divide M, every rank of the mesh calls this with the same arguments
    and the walk runs as the consensus walk
    (:func:`_streaming_argmax_sharded`); every rank gets the global
    result, bit-identical to the single-device walk's.  ``wq`` may then
    be this rank's slice of a vocab-sharded cache (a PlaneOperands with a
    ``shard``, ``ws`` its scales).

    Within a :func:`~repro_torch.sharding.ctx.row_shard` scope ``xq`` and
    ``xs`` already hold this rank's rows of the global batch, split evenly
    over the scope's row axes in rank order (the ``"batch"`` slot-state
    layout); the walk then takes them as its row slice, and ``policy``
    still covers the global rows.  The results are global all the same.
    """
    axes = sharded_walk_axes(_lhs_lead(xq), _n_total(wq), mesh)
    if axes is not None:
        return _streaming_argmax_sharded(
            xq, wq, xs, ws, n_bits, log2_radix, levels, bias, out_dtype,
            safety, early_exit, policy, cuda_walk, *axes)
    if _shard(wq) is not None:
        raise ValueError(f"{wq.describe()} holds one rank's slice of the "
                         f"columns ({wq.shard.n_total} in all): walk it on "
                         f"the mesh it was built on (mesh=)")
    d = plane_count(n_bits, log2_radix)
    bounds = level_bounds(d, log2_radix, _contract_k(xq), levels)
    n_levels = len(bounds.exact)
    wsr = ws.reshape(1, -1).to(torch.float32)
    xsf = xs.to(torch.float32)
    m = _lhs_lead(xq)[-1]
    if policy is not None:
        if tuple(policy.mode.shape) != (m,):
            raise ValueError(f"policy rows {tuple(policy.mode.shape)} != "
                             f"batch rows ({m},)")
        policy = policy.to(xsf.device)
    fold, init, done_fn, finalize = head_walk_machinery(
        bounds.f32, xsf, wsr, bias, out_dtype, safety=safety,
        n_levels=n_levels, m_global=m, policy=policy, early_exit=early_exit)
    if early_exit:
        acc, carry, _ = streaming_matmul_while(
            xq, wq, fold, init, done_fn, n_bits, log2_radix, levels,
            cuda_walk)
    else:
        acc, carry, _ = streaming_matmul_scan(
            xq, wq, fold, init, n_bits, log2_radix, levels,
            cuda_walk=cuda_walk)
    return finalize(acc, carry)


# ------------------------------------------------- sharded streaming walk
def _shard(wq):
    return wq.shard if isinstance(wq, PlaneOperands) else None


def _n_total(wq) -> int:
    """The walk's global column count: a sharded cache's whole N."""
    shard = _shard(wq)
    return shard.n_total if shard is not None else _rhs_n(wq)


def sharded_walk_axes(lead: tuple[int, ...], n: int, mesh=None):
    """Mesh routing of the streaming walk: ``(mesh, dp_axes, model_axis)``
    when the consensus walk applies, None otherwise.

    ``mesh`` defaults to the installed mesh (sharding/ctx.py).  The walk
    splits the rows (M) over the data-parallel axes and the columns (N)
    over ``model``; an axis that does not divide its dim is dropped (that
    side is replicated), and when neither is usable (or the mesh is
    trivial) the caller takes the single-device walk.  Only 2-D tiles
    (one lead dim) are sharded.  Rows that are already this rank's slice
    (``ctx.row_axes()``) keep the axes they are split over.
    """
    mesh = mesh if mesh is not None else ctx.get_mesh()
    if mesh is None or len(lead) != 1:
        return None
    m = lead[0]
    dp = ctx.row_axes()
    if not dp:
        dp = dp_axes(mesh)
        dp_size = ctx.mesh_axis_size(mesh, dp)
        if dp_size <= 1 or m % dp_size:
            dp = ()
    model = "model" if "model" in mesh.axis_names else None
    if model is not None and (mesh.shape["model"] <= 1
                              or n % mesh.shape["model"]):
        model = None
    if not dp and model is None:
        return None
    return mesh, dp, model


def sharded_walk_collectives(levels_run: int, model_sharded: bool,
                             rows_sharded: bool, early_exit: bool) -> dict:
    """The collectives of one consensus walk that ran ``levels_run``
    levels (sharding/collectives.py counts): over the model group three
    all-reduces a level and two in the final fallback, and one gather of
    the logits; over the data group one all-reduce a level with
    ``early_exit``, and two gathers (logits; tokens with exit levels)."""
    reduces = 3 * levels_run + 2 if model_sharded else 0
    if rows_sharded and early_exit:
        reduces += levels_run
    return {"all_reduce": reduces,
            "all_gather": int(model_sharded) + 2 * int(rows_sharded),
            "all_to_all": 0}


def _row_slice(xq, r0: int, rows: int):
    if isinstance(xq, PlaneOperands):
        return dataclasses.replace(xq, stack=xq.stack[r0:r0 + rows])
    return xq[r0:r0 + rows]


def _col_slice(wq, c0: int, cols: int):
    """Columns [c0, c0 + cols) of a (K, N) operand or (D*K, N) stack, as
    a view (a K-major cache stays K-major)."""
    if isinstance(wq, PlaneOperands):
        if wq.stack.ndim != 2 or wq.axis % 2 != 0:
            raise ValueError(f"the sharded walk splits the columns of a "
                             f"(D*K, N) stack, got {wq.describe()}")
        return dataclasses.replace(wq, stack=wq.stack[:, c0:c0 + cols])
    return wq[:, c0:c0 + cols]


def _local_cols(x: torch.Tensor | None, n_total: int, c0: int, cols: int):
    """This rank's columns of a per-column vector whose last dim is
    global (``n_total``); a local or broadcast one is returned as is."""
    if x is None or x.shape[-1] != n_total:
        return x
    return x[..., c0:c0 + cols]


def _streaming_argmax_sharded(xq, wq, xs, ws, n_bits, log2_radix, levels,
                              bias, out_dtype, safety, early_exit, policy,
                              cuda_walk, mesh, dp, model_ax):
    """The consensus level walk behind :func:`streaming_argmax`.

    Each rank takes rows ``[i * M/dp, (i+1) * M/dp)`` of the activations
    (i its index over the ``dp`` axes) and columns ``[j * N/m, (j+1) *
    N/m)`` of the weights (j its index over ``model_ax``): a global
    operand is sliced here (a view), a vocab-sharded cache must hold
    exactly that slice.  K is never split, so each rank's accumulator is
    the integer-exact block of the single-device one at every level, and
    the shared decision fold (core/policy.py:head_walk_machinery) reduces
    its per-level decisions across ranks.  With ``early_exit`` the rows
    decided are summed over the data axes every level and every rank
    stops at the same level, the slowest row's.  Then the tokens and exit
    levels are gathered over the data axes and the logits over both, so
    every rank returns the global ``(logits (M, N), tok (M,), exit_level
    (M,))``.  Within a ``ctx.row_shard`` scope the operands already hold
    this rank's rows (M/dp of them) and are not sliced.
    """
    d = plane_count(n_bits, log2_radix)
    bounds = level_bounds(d, log2_radix, _contract_k(xq), levels)
    n_levels = len(bounds.exact)
    m = _lhs_lead(xq)[-1]
    local_rows = bool(ctx.row_axes())
    if local_rows:
        m *= ctx.mesh_axis_size(mesh, dp)
    n_total = _n_total(wq)
    if policy is not None:
        if tuple(policy.mode.shape) != (m,):
            raise ValueError(f"policy rows {tuple(policy.mode.shape)} != "
                             f"batch rows ({m},)")
    if dp:
        m_l = m // ctx.mesh_axis_size(mesh, dp)
        r0 = mesh.index(dp) * m_l
        if not local_rows:
            xq, xs = _row_slice(xq, r0, m_l), xs[r0:r0 + m_l]
        if policy is not None:
            policy = LevelPolicy(*(t[r0:r0 + m_l] for t in policy))
    shard = _shard(wq)
    if model_ax:
        n_l = n_total // mesh.shape[model_ax]
        c0 = mesh.index(model_ax) * n_l
        if shard is None:
            wq = _col_slice(wq, c0, n_l)
        elif (shard.axis, shard.offset, _rhs_n(wq)) != (model_ax, c0, n_l):
            raise ValueError(f"{wq.describe()} holds columns [{shard.offset}"
                             f", {shard.offset + _rhs_n(wq)}) over "
                             f"{shard.axis!r}; this rank walks [{c0}, "
                             f"{c0 + n_l}) over {model_ax!r}")
        ws = _local_cols(ws.reshape(1, -1), n_total, c0, n_l)
        bias = _local_cols(bias, n_total, c0, n_l)
    elif shard is not None:
        raise ValueError(f"{wq.describe()} holds one rank's slice of the "
                         f"columns, but the mesh's model axis does not "
                         f"split them")
    wsr = ws.reshape(1, -1).to(torch.float32)
    xsf = xs.to(torch.float32)
    if policy is not None:
        policy = policy.to(xsf.device)
    fold, init, done_fn, finalize = head_walk_machinery(
        bounds.f32, xsf, wsr, bias, out_dtype, safety=safety,
        n_levels=n_levels, m_global=m, n_total=n_total, policy=policy,
        early_exit=early_exit, mesh=mesh, model_ax=model_ax, dp=dp)
    if early_exit:
        acc, carry, _ = streaming_matmul_while(
            xq, wq, fold, init, done_fn, n_bits, log2_radix, levels,
            cuda_walk)
    else:
        acc, carry, _ = streaming_matmul_scan(
            xq, wq, fold, init, n_bits, log2_radix, levels,
            cuda_walk=cuda_walk)
    logits, tok, lv = finalize(acc, carry)
    with tag(TAG_GATHER):
        if model_ax:
            logits = all_gather(logits, mesh.group(model_ax), dim=-1)
        if dp:
            logits = all_gather(logits, mesh.group(dp), dim=0)
            tok, lv = all_gather(torch.stack([tok, lv]), mesh.group(dp),
                                 dim=1)
    return logits, tok, lv


def earliest_decision_level(result: ProgressiveResult) -> torch.Tensor:
    """Earliest MSDF level at which greedy argmax over the last axis is
    already decided (top-1 margin exceeds twice the tail bound), compared
    in int32 under the ``decidable`` guard.  Returns (...,) int32 per
    row; L-1 means the full stream was needed."""
    partial = result.partial  # (L, ..., N)
    extra = (1,) * (partial.ndim - 2)
    b32 = result.bound_i32.to(partial.device).reshape((-1,) + extra)
    ok = result.decidable.to(partial.device).reshape((-1,) + extra)
    top2 = torch.topk(partial, 2, dim=-1).values  # (L, ..., 2)
    margin = top2[..., 0] - top2[..., 1]  # int32, exact
    decided = ok & (margin > 2 * b32)  # 2*b32 <= 2^31-2: no overflow
    lv = decided.to(torch.int32).argmax(0)  # first True (0 if none)
    return torch.where(decided.any(0), lv, partial.shape[0] - 1) \
        .to(torch.int32)
