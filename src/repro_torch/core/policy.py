"""Per-request precision classes: the one decision fold of every
streaming walk.

The port of ``repro/core/policy.py``.  A row of a streaming walk commits
by its class:

  * ``exact``      — never early-commits; the walk runs full depth for
                     it and the committed value is the full-precision
                     fallback;
  * ``budget(L)``  — force-commits after L levels: the argmax of the
                     dequantized prefix, bit-identical to a run
                     truncated at ``levels=L``;
  * ``bounded(tol)`` — margin early exit: commits once the top-1 lower
                     confidence bound beats every other entry's upper
                     bound minus ``tol`` (``tol=0`` is the plain
                     early-exit walk bit for bit).

:class:`LevelPolicy` holds per-row ``(mode, clamp, tol)`` tensors, so one
mixed batch serves each row by its own rule inside one level loop.
:func:`head_walk_machinery` builds the head-argmax fold that
``core/progressive.py:streaming_argmax`` runs over the MSDF prefix
stream, and :func:`attn_walk_machinery` the decode-attention fold that
``models/attention.py:decode_attention`` runs over the score stream.
With a mesh the head fold reduces across the ranks that hold the head's
column slices (the reference's consensus walk).

Every float operation keeps the reference's operands and order, so the
decisions, committed classes and exit levels are bit-identical to it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.sharding.collectives import (TAG_CONSENSUS, TAG_MAX,
                                              TAG_MIN, all_reduce, tag)

__all__ = [
    "MODE_EXACT",
    "MODE_BUDGET",
    "MODE_BOUNDED",
    "NO_CLAMP",
    "PrecisionClass",
    "LevelPolicy",
    "decision_state",
    "policy_commit",
    "head_walk_machinery",
    "attn_walk_machinery",
]

MODE_EXACT = 0
MODE_BUDGET = 1
MODE_BOUNDED = 2
# BUDGET clamp sentinel for non-budget rows: larger than any level index
# a walk can reach, so `idx >= clamp - 1` never fires
NO_CLAMP = 2**31 - 1

# |fl(v) - v| <= ~3 ulp(|v|) across the cast, the two scale products and
# the bias add; 8 ulp of the row max is the reference's envelope
_EPS = np.float32(8.0 * np.finfo(np.float32).eps)


@dataclasses.dataclass(frozen=True)
class PrecisionClass:
    """Host-side precision class of one request.

    ``kind`` is "exact" | "budget" | "bounded"; ``levels`` is the budget
    clamp, ``tol`` the bounded margin slack in the scaled score domain.
    """

    kind: str
    levels: int | None = None
    tol: float = 0.0

    def __post_init__(self):
        if self.kind not in ("exact", "budget", "bounded"):
            raise ValueError(f"unknown precision class kind: {self.kind!r}")
        if self.kind == "budget" and (self.levels is None or self.levels < 1):
            raise ValueError("budget class needs levels >= 1 "
                             f"(got {self.levels})")

    @classmethod
    def exact(cls) -> "PrecisionClass":
        return cls("exact")

    @classmethod
    def budget(cls, levels: int) -> "PrecisionClass":
        return cls("budget", levels=int(levels))

    @classmethod
    def bounded(cls, tol: float = 0.0) -> "PrecisionClass":
        return cls("bounded", tol=float(tol))

    def label(self) -> str:
        """Stable string key of the per-class exit histograms."""
        if self.kind == "exact":
            return "exact"
        if self.kind == "budget":
            return f"budget({self.levels})"
        return f"bounded({self.tol:g})"

    def row(self) -> tuple[int, int, float]:
        """(mode, clamp, tol) row values of this class."""
        if self.kind == "exact":
            return MODE_EXACT, NO_CLAMP, 0.0
        if self.kind == "budget":
            return MODE_BUDGET, int(self.levels), 0.0
        return MODE_BOUNDED, NO_CLAMP, float(self.tol)


class LevelPolicy(NamedTuple):
    """Per-row precision policy of one streaming walk.

    mode:  (rows,) int32 — MODE_EXACT / MODE_BUDGET / MODE_BOUNDED.
    clamp: (rows,) int32 — budget rows force-commit at level index
           ``clamp - 1``; NO_CLAMP on other rows.
    tol:   (rows,) float32 — bounded rows' margin slack; 0 elsewhere.
    """

    mode: torch.Tensor
    clamp: torch.Tensor
    tol: torch.Tensor

    @classmethod
    def from_classes(cls, classes, device: str | torch.device = "cpu"
                     ) -> "LevelPolicy":
        rows = [c.row() for c in classes]
        return cls(
            torch.tensor([r[0] for r in rows], dtype=torch.int32,
                         device=device),
            torch.tensor([r[1] for r in rows], dtype=torch.int32,
                         device=device),
            torch.from_numpy(np.asarray([r[2] for r in rows], np.float32))
            .to(device))

    @classmethod
    def exact(cls, rows: int) -> "LevelPolicy":
        return cls.from_classes([PrecisionClass.exact()] * rows)

    @classmethod
    def budget(cls, levels: int, rows: int) -> "LevelPolicy":
        return cls.from_classes([PrecisionClass.budget(levels)] * rows)

    @classmethod
    def bounded(cls, rows: int, tol: float = 0.0) -> "LevelPolicy":
        return cls.from_classes([PrecisionClass.bounded(tol)] * rows)

    @property
    def rows(self) -> int:
        return int(self.mode.shape[0])

    def set_row(self, i: int, pc: PrecisionClass) -> "LevelPolicy":
        """Row ``i`` becomes class ``pc`` (a new policy; this one is
        unchanged)."""
        m, c, t = pc.row()
        mode, clamp, tol = (x.clone() for x in self)
        mode[i], clamp[i], tol[i] = m, c, float(np.float32(t))
        return LevelPolicy(mode, clamp, tol)

    def to(self, device: str | torch.device) -> "LevelPolicy":
        return LevelPolicy(*(x.to(device) for x in self))

    def reshape(self, shape) -> "LevelPolicy":
        """Broadcast helper for walks whose decision rows are not (rows,)
        (decode attention reshapes to (B, 1, 1) against its (B, Kv, G)
        rows)."""
        return LevelPolicy(*(x.reshape(shape) for x in self))


def decision_state(values: torch.Tensor, bvec: torch.Tensor):
    """Is the argmax of ``values`` invariant to any ±bvec perturbation?

    values: (..., N) scores; bvec: per-entry bound, broadcastable to
    values.  Decided iff the top-1 lower confidence bound strictly beats
    every other entry's upper bound.  Returns (decided (...,), argmax).
    """
    top = values.argmax(-1)  # first maximal index, as jnp.argmax
    lb = values - bvec
    ub = values + bvec
    lb_top = torch.gather(lb, -1, top[..., None])[..., 0]
    one_hot = torch.nn.functional.one_hot(top, values.shape[-1]).bool()
    ub_others = torch.where(one_hot, -torch.inf, ub)
    return lb_top > ub_others.amax(-1), top.to(torch.int32)


def policy_commit(policy: LevelPolicy | None, decided: torch.Tensor,
                  idx: int, done: torch.Tensor):
    """The one mode/clamp gate of every policy walk.

    ``decided`` is this level's margin decision per row, ``done`` the
    rows already committed.  Returns ``(newly, forced)``: rows committing
    by margin this level (never exact rows), and budget rows reaching
    their clamp without a margin decision (the caller commits them from
    the dequantized prefix).  Both imply ``~done``.
    """
    if policy is None:
        newly = decided & ~done
        return newly, torch.zeros_like(newly)
    eligible = policy.mode != MODE_EXACT
    newly = decided & eligible & ~done
    forced = (policy.mode == MODE_BUDGET) & (idx >= policy.clamp - 1) \
        & ~done & ~newly
    return newly, forced


def head_walk_machinery(bounds_f32, xsf, wsr, bias, out_dtype, *,
                        safety: float, n_levels: int, m_global: int,
                        n_total: int | None = None,
                        policy: LevelPolicy | None = None,
                        early_exit: bool = False, mesh=None,
                        model_ax: str | None = None, dp: tuple = ()):
    """The head-argmax decision fold: local and sharded are one fold.

    Returns ``(fold, init, done_fn, finalize)`` for the streaming
    emitters (``streaming_matmul_scan`` / ``streaming_matmul_while``):
    ``fold`` carries ``(tok, lv, done, all_done)``, ``done_fn`` reads
    ``all_done`` (a 0-d bool tensor on the walk's device), and
    ``finalize(acc, carry)`` dequantizes exactly like ``l2r_matmul_f``
    and falls undecided rows back to the full argmax, returning
    ``(logits, tok, lv)``.

    ``bounds_f32`` (L,) float32 tail bounds, ``xsf`` (M, 1) row scales
    and ``wsr`` (1, N) column scales share the device of the stream.
    Float order follows the reference: ``values = acc * xsf * wsr (+
    bias)``, ``bvec = bound * xsf * wsr * f32(1 + safety) + 8 eps *
    max|values|``.

    **Sharded.**  With ``mesh``, ``model_ax`` names the mesh axis the
    columns are split over (``xsf``, ``wsr``, ``bias`` and the stream are
    this rank's slices; column ``j`` is global column ``index(model_ax) *
    n_l + j`` of ``n_total``) and ``dp`` the axes the rows are split over
    (``m_global`` rows in all).  Each level's decision then comes from
    exact reductions over the ``model_ax`` group (sharding/collectives.py):
    one MAX of the row maxima (of ``|values|``, of ``values``, and with a
    policy of the dequantized prefix), one MIN of the candidate first
    indices, one MAX of the owner's lower bound and the runner-up's upper
    bound.  Max and min of the same floats are exact in any order, so
    decisions, committed tokens and exit levels are the single-device
    walk's bit for bit.  With ``early_exit`` the rows decided are summed
    over the ``dp`` group each level, so every rank stops at the same
    level (core/progressive.py:sharded_walk_collectives counts them).
    """
    dev = xsf.device
    m_l = xsf.shape[0]
    n_l = wsr.shape[-1]
    n_total = n_l if n_total is None else n_total
    bounds_f32 = bounds_f32.to(dev)
    # JAX folds the Python scalar 1 + safety into float32 once
    widen = torch.tensor(np.float32(1.0 + safety), device=dev)
    eps = torch.tensor(_EPS, device=dev)
    off = mesh.index(model_ax) * n_l if model_ax else 0
    col = off + torch.arange(n_l, dtype=torch.int32, device=dev)
    model_group = mesh.group(model_ax) if model_ax else None
    dp_group = mesh.group(dp) if dp else None

    def reduce(op: str, *rows):
        """``rows`` (each (M_l,)) reduced over the model group at once,
        tagged ``l2r_coll_max`` / ``l2r_coll_min``."""
        if model_group is None:
            return rows
        with tag(TAG_MAX if op == "max" else TAG_MIN):
            return tuple(all_reduce(torch.stack(rows), op, model_group))

    def first_index(vals, vmax_l, vmax):
        """The first index achieving the row maximum ``vmax``
        (jnp.argmax's tie-break): sharded, this shard's first one as a
        global index, or n_total where it holds none, to be MIN-reduced."""
        amax_l = vals.argmax(-1).to(torch.int32)
        if model_group is None:
            return amax_l
        return torch.where(vmax_l == vmax, amax_l + off,
                           torch.full_like(amax_l, n_total))

    def dequant_roundtrip(partial):
        """The l2r_matmul_f dequantization: f32 product, output cast,
        back to f32 for the argmax."""
        logits = (partial.to(torch.float32) * xsf * wsr).to(out_dtype)
        full = logits.to(torch.float32)
        if bias is not None:
            logits = logits + bias.to(logits.dtype)
            full = full + bias.to(torch.float32)
        return logits, full

    def fold(carry, partial, idx):
        tok, lv, done, _ = carry
        values = partial.to(torch.float32) * xsf * wsr
        if bias is not None:
            values = values + bias.to(torch.float32)
        vmax_l = values.amax(-1)
        maxima = [values.abs().amax(-1), vmax_l]
        if policy is not None:
            # budget clamp: commit the row from the out_dtype round-trip
            # of THIS prefix, the value a levels=clamp run would commit
            _, full = dequant_roundtrip(partial)
            fmax_l = full.amax(-1)
            maxima.append(fmax_l)
        maxima = reduce("max", *maxima)
        vmax_abs = maxima[0][:, None]
        cands = [first_index(values, vmax_l, maxima[1])]
        if policy is not None:
            cands.append(first_index(full, fmax_l, maxima[2]))
        cands = reduce("min", *cands)
        gtop = cands[0]
        bvec = bounds_f32[idx] * xsf * wsr * widen + eps * vmax_abs
        own = col[None, :] == gtop[:, None]
        lb_top, ub_others = reduce(
            "max", torch.where(own, values - bvec, -torch.inf).amax(-1),
            torch.where(own, -torch.inf, values + bvec).amax(-1))
        if policy is None:
            decided = lb_top > ub_others
        else:
            decided = lb_top > ub_others - policy.tol
        newly, forced = policy_commit(policy, decided, idx, done)
        tok = torch.where(newly, gtop, tok)
        if policy is not None:
            tok = torch.where(forced, cands[1], tok)
        commit = newly | forced
        lv = torch.where(commit, idx, lv)
        done = done | commit
        # only the early-exit loop reads the flag; the scan skips the sum
        if early_exit:
            n_done = done.sum().to(torch.int32)
            if dp_group is not None:
                with tag(TAG_CONSENSUS):
                    n_done = all_reduce(n_done, "sum", dp_group)
            all_done = n_done == m_global
        else:
            all_done = torch.zeros((), dtype=torch.bool, device=dev)
        return tok, lv, done, all_done

    init = (torch.zeros((m_l,), dtype=torch.int32, device=dev),
            torch.full((m_l,), max(n_levels - 1, 0), dtype=torch.int32,
                       device=dev),
            torch.zeros((m_l,), dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))

    def done_fn(carry):
        return carry[3]

    def finalize(acc, carry):
        # whenever an undecided row exists the loop exhausted its stream,
        # so `acc` is the full (or levels-truncated) result on both flows
        tok, lv, done, _ = carry
        logits, full = dequant_roundtrip(acc)
        fmax_l = full.amax(-1)
        (fmax,) = reduce("max", fmax_l)
        (fallback,) = reduce("min", first_index(full, fmax_l, fmax))
        tok = torch.where(done, tok, fallback)
        return logits, tok, lv

    return fold, init, done_fn, finalize


# ------------------------------------------------------ decode attention walk
def attn_walk_machinery(bounds_f32, dequant, valid_b, scale_row, *,
                        rows_shape: tuple, n_levels: int,
                        safety: float = 1e-5, exit_tol: float = 1e-4,
                        policy: LevelPolicy | None = None,
                        score_shape: tuple | None = None):
    """The decode-attention decision fold (models/attention.py).

    ``dequant(partial)`` maps the int32 score prefix (B, Kv, G, 1, S) to
    scaled scores; ``valid_b`` is the (B, 1, 1, 1, S) slot-validity mask;
    ``scale_row`` the per-entry scale product ``q_scale * k_scale *
    softmax_scale`` on the (B, Kv, G, S) row layout (broadcastable);
    ``rows_shape`` = (B, Kv, G), the decision rows.  ``bounds_f32`` (L,)
    lies on the walk's device.

    A row is decided when BOTH its running max is invariant to the tail
    (:func:`decision_state`) and its normalizer is pinned (every unmasked
    score known to within the tolerance: the row's ``tol`` for a policy,
    ``exit_tol`` otherwise).  Returns ``(fold, init, done_fn)``; without
    a policy the carry is ``(done, lv)``, with one ``(done, lv, forced,
    s_commit)``, where budget rows snapshot their int32 prefix at the
    clamp, so that ``torch.where(forced[..., None, None], s_commit, acc)``
    feeds softmax the exact ``levels=clamp`` scores even when batch-mates
    stream deeper.  Bounded rows keep the batch-coupled semantics of the
    reference (softmax over the prefix at the global stop level).
    ``done_fn`` returns a 0-d bool tensor on the walk's device.
    """
    dev = bounds_f32.device
    neg = torch.tensor(np.float32(-1e30), device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    eps = torch.tensor(_EPS, device=dev)
    # JAX folds the Python scalars 1 + safety and exit_tol into float32
    widen = torch.tensor(np.float32(1.0 + safety), device=dev)
    valid_row = valid_b[:, :, :, 0, :]  # (B, 1, 1, S)
    pol = policy.reshape((-1, 1, 1)) if policy is not None else None
    tol = pol.tol if pol is not None \
        else torch.tensor(np.float32(exit_tol), device=dev)

    def decide(partial, idx, done):
        values = torch.where(valid_b, dequant(partial), neg)[:, :, :, 0, :]
        vmax = torch.where(valid_row, values, zero).abs().amax(-1,
                                                              keepdim=True)
        # per-entry bound on the unseen tail in the scaled score domain;
        # masked slots are exact (-1e30 by fiat): bound 0
        bvec = bounds_f32[idx] * scale_row * widen + eps * vmax
        bvec = torch.where(valid_row, bvec, zero)
        max_decided, _ = decision_state(values, bvec)
        norm_decided = bvec.amax(-1) <= tol
        return policy_commit(pol, max_decided & norm_decided, idx, done)

    lv0 = torch.full(rows_shape, max(n_levels - 1, 0), dtype=torch.int32,
                     device=dev)
    done0 = torch.zeros(rows_shape, dtype=torch.bool, device=dev)
    if policy is None:
        def fold(carry, partial, idx):
            done, lv = carry
            newly, _ = decide(partial, idx, done)
            lv = torch.where(newly, idx, lv)
            return done | newly, lv

        init = (done0, lv0)
    else:
        def fold(carry, partial, idx):
            done, lv, forced_any, s_commit = carry
            newly, forced = decide(partial, idx, done)
            commit = newly | forced
            lv = torch.where(commit, idx, lv)
            s_commit = torch.where(forced[..., None, None], partial,
                                   s_commit)
            return done | commit, lv, forced_any | forced, s_commit

        if score_shape is None:
            raise ValueError("policy attention walk: pass the (B, Kv, G, 1, "
                             "S) score shape")
        init = (done0, lv0, torch.zeros_like(done0),
                torch.zeros(score_shape, dtype=torch.int32, device=dev))

    def done_fn(carry):
        return carry[0].all()

    return fold, init, done_fn
