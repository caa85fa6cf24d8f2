"""Static int32 overflow certification for the L2R digit walks.

Every schedule in this repo (pairs / stacked / streaming, dense / conv /
attention) folds plane-pair partial products into **one int32
accumulator** per output element:

    acc = sum_{s in processed levels} sum_{i+j=s} <x_i, y_j> * radix**s

The walks are bit-identical to each other *modulo 2^32* no matter what —
int32 wraparound is deterministic and schedule-independent — but the
repo's headline claim is exactness against unbounded integer arithmetic,
and that only holds while ``|acc| < 2**31`` at **every** prefix of the
MSDF walk (progressive truncation commits from prefixes, so intermediate
magnitudes matter, not just the final value).

This module certifies that statically from the digit configuration:

* :func:`per_element_extremes` — for each MSDF prefix length, the exact
  min/max of the per-(x, y)-element partial sum over all representable
  n-bit operand pairs, found by exhaustive (vectorized) enumeration for
  ``n_bits <= 8`` and by a sound digit-interval bound above that.
* :func:`certify` — scales the per-element extreme by the contraction
  length ``k`` (and ``taps``, the conv window multiplier) and returns an
  :class:`OverflowCertificate` with the worst-case magnitude, whether it
  is exact (achievable, with a witness operand pair) or merely an upper
  bound, and whether it fits int32.
* :func:`check_or_raise` — the call-time guard wired into the
  ``l2r_gemm`` dispatcher, ``l2r_conv2d`` and ``quantize_weights``.
  Mode comes from the ``L2R_CERTIFY`` env var: ``warn`` (default) emits an
  :class:`AccumulatorOverflowWarning` once per config, ``strict`` raises
  with the computed bound in the message, ``off`` skips the check.
* :func:`audit_registry` — sweeps every config in
  ``repro_torch.configs.registry`` and certifies each L2R contraction it
  declares (head walk over ``d_model``, attention score walk over
  ``head_dim``).

Exactness of the k * M scaling: the per-element extreme M is achieved by
some representable operand pair (x*, y*) at some prefix t*; aligning all
``k`` contraction entries at (x*, y*) achieves k * M at the same prefix,
because every level's contribution scales linearly in the number of
aligned entries.  So for ``n_bits <= 8`` the certificate is *tight* — an
adversarial operand set achieving it exists (see
tests/test_torch_quant.py::test_certificate_tightness_pair).

A numpy-only copy of ``repro/analysis/overflow.py``.

``window_pad`` is accepted for interface completeness: window padding
contributes all-zero digit planes, which add nothing to any level, so it
never changes the bound.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from functools import lru_cache

import numpy as np

from repro_torch.core.online import msdf_levels

__all__ = [
    "AccumulatorOverflowWarning",
    "OverflowCertificate",
    "PerElementExtremes",
    "per_element_extremes",
    "certify",
    "check_or_raise",
    "audit_registry",
    "certify_mode",
    "INT32_LIMIT",
]

INT32_LIMIT = 2**31 - 1

#: configs at or below this operand width are certified by exhaustive
#: enumeration (2^n x 2^n pairs); wider ones fall back to a sound
#: digit-interval bound.
_EXACT_MAX_BITS = 8


class AccumulatorOverflowWarning(UserWarning):
    """A digit config whose worst-case int32 accumulator can overflow."""


# --------------------------------------------------------------- extremes
@dataclasses.dataclass(frozen=True)
class PerElementExtremes:
    """Per-MSDF-prefix extremes of the single-element partial sum.

    ``lo[t]`` / ``hi[t]`` bound the partial sum after the first ``t + 1``
    significance levels, over all representable (x, y) operand pairs.
    When ``exact``, the bounds are achieved and ``witness(t)`` returns an
    achieving integer pair.
    """

    n_bits: int
    log2_radix: int
    lo: tuple  # per prefix, descending-level MSDF order
    hi: tuple
    exact: bool
    # achieving (x, y) per prefix; empty when not exact
    lo_wit: tuple = ()
    hi_wit: tuple = ()

    def magnitude(self, levels: int | None = None) -> int:
        """Max |partial sum| over the first ``levels`` prefixes (all
        2D-1 when None)."""
        t = len(self.lo) if levels is None else min(levels, len(self.lo))
        if t <= 0:
            return 0
        return max(max(abs(v) for v in self.lo[:t]),
                   max(abs(v) for v in self.hi[:t]))

    def witness(self, levels: int | None = None):
        """(x, y, prefix_levels) achieving :meth:`magnitude`; None when
        the extremes are interval bounds rather than enumerated."""
        if not self.exact:
            return None
        t_max = len(self.lo) if levels is None else min(levels, len(self.lo))
        best, arg = -1, None
        for t in range(t_max):
            for v, wit in ((self.lo[t], self.lo_wit[t]),
                           (self.hi[t], self.hi_wit[t])):
                if abs(v) > best:
                    best, arg = abs(v), (wit[0], wit[1], t + 1)
        return arg


def _digit_table(n_bits: int, log2_radix: int):
    """(D, 2**n) digit planes of every representable value, plus the
    value vector — same convention as core.quant.digit_planes (low
    planes masked-unsigned, top plane arithmetic shift)."""
    d = n_bits // log2_radix
    q = np.arange(-(1 << (n_bits - 1)), 1 << (n_bits - 1), dtype=np.int64)
    mask = (1 << log2_radix) - 1
    planes = [(q >> (log2_radix * i)) & mask for i in range(d - 1)]
    planes.append(q >> (log2_radix * (d - 1)))  # arithmetic: signed top
    return np.stack(planes), q


def _digit_ranges(n_bits: int, log2_radix: int):
    """[lo, hi] per digit plane (interval fallback for wide operands)."""
    d = n_bits // log2_radix
    r = 1 << log2_radix
    lo = [0] * (d - 1) + [-(r // 2)]
    hi = [r - 1] * (d - 1) + [r // 2 - 1]
    return lo, hi


@lru_cache(maxsize=None)
def per_element_extremes(n_bits: int, log2_radix: int) -> PerElementExtremes:
    if n_bits % log2_radix:
        raise ValueError(f"n_bits={n_bits} not divisible by "
                         f"log2_radix={log2_radix}")
    d = n_bits // log2_radix
    r = 1 << log2_radix
    if n_bits <= _EXACT_MAX_BITS:
        digs, q = _digit_table(n_bits, log2_radix)
        p = np.zeros((q.size, q.size), np.int64)
        lo, hi, lo_wit, hi_wit = [], [], [], []
        for s in msdf_levels(d):
            lvl = np.zeros_like(p)
            for i in range(d):
                j = s - i
                if 0 <= j < d:
                    lvl += np.outer(digs[i], digs[j])
            p += lvl * (r ** s)
            a_min = np.unravel_index(int(p.argmin()), p.shape)
            a_max = np.unravel_index(int(p.argmax()), p.shape)
            lo.append(int(p[a_min]))
            hi.append(int(p[a_max]))
            lo_wit.append((int(q[a_min[0]]), int(q[a_min[1]])))
            hi_wit.append((int(q[a_max[0]]), int(q[a_max[1]])))
        return PerElementExtremes(n_bits, log2_radix, tuple(lo), tuple(hi),
                                  exact=True, lo_wit=tuple(lo_wit),
                                  hi_wit=tuple(hi_wit))
    # interval fallback: digits vary independently inside their plane
    # ranges — sound (contains every representable pair) but the corners
    # need not correspond to a single representable operand.
    dlo, dhi = _digit_ranges(n_bits, log2_radix)
    acc_lo = acc_hi = 0
    lo, hi = [], []
    for s in msdf_levels(d):
        lvl_lo = lvl_hi = 0
        for i in range(d):
            j = s - i
            if 0 <= j < d:
                cands = [dlo[i] * dlo[j], dlo[i] * dhi[j],
                         dhi[i] * dlo[j], dhi[i] * dhi[j]]
                lvl_lo += min(cands) * (r ** s)
                lvl_hi += max(cands) * (r ** s)
        acc_lo += lvl_lo
        acc_hi += lvl_hi
        lo.append(acc_lo)
        hi.append(acc_hi)
    return PerElementExtremes(n_bits, log2_radix, tuple(lo), tuple(hi),
                              exact=False)


# ------------------------------------------------------------ certificate
@dataclasses.dataclass(frozen=True)
class OverflowCertificate:
    """Worst-case int32 accumulator magnitude for one digit config.

    ``bound = k * taps * per_element`` — the max |accumulator| over every
    MSDF prefix of the walk, every representable operand set, and every
    output element.  ``exact`` means the bound is achieved by a concrete
    operand pair (``witness``); otherwise it is a sound over-estimate.
    """

    n_bits: int
    log2_radix: int
    levels: int
    k: int
    taps: int
    per_element: int
    bound: int
    exact: bool
    witness: tuple | None  # (x, y, prefix_levels) achieving per_element
    limit: int = INT32_LIMIT

    @property
    def sound(self) -> bool:
        return self.bound <= self.limit

    @property
    def headroom_bits(self) -> float:
        """log2(limit / bound); negative when unsound."""
        if self.bound == 0:
            return float("inf")
        return float(np.log2(self.limit / self.bound))

    def describe(self) -> str:
        kind = "exact worst case" if self.exact else "interval bound"
        state = "fits int32" if self.sound else "OVERFLOWS int32"
        return (f"l2r config n_bits={self.n_bits} log2_radix="
                f"{self.log2_radix} levels={self.levels} k={self.k}"
                f"{f' taps={self.taps}' if self.taps != 1 else ''}: "
                f"worst-case |accumulator| = {self.bound} ({kind}) "
                f"vs limit {self.limit} -> {state}")

    def to_json(self) -> dict:
        return {
            "n_bits": self.n_bits, "log2_radix": self.log2_radix,
            "levels": self.levels, "k": self.k, "taps": self.taps,
            "per_element": self.per_element, "bound": self.bound,
            "limit": self.limit, "exact": self.exact, "sound": self.sound,
            "witness": list(self.witness) if self.witness else None,
        }


def certify(n_bits: int, log2_radix: int, k: int, levels: int | None = None,
            taps: int = 1, window_pad: int = 0) -> OverflowCertificate:
    """Certify the int32 accumulator of a (config, contraction) pair.

    ``k`` is the contraction length; ``taps`` multiplies it for conv
    windows (kh * kw); ``levels`` truncates the walk (None = full 2D-1).
    ``window_pad`` is bound-neutral (zero planes) and accepted only so
    call sites can forward their full config.
    """
    del window_pad  # zero digit planes: contributes nothing to any level
    if k < 0 or taps < 1:
        raise ValueError(f"need k >= 0 and taps >= 1, got k={k} taps={taps}")
    ext = per_element_extremes(n_bits, log2_radix)
    n_levels = len(ext.lo)
    lv = n_levels if levels is None else max(0, min(levels, n_levels))
    per = ext.magnitude(lv)
    return OverflowCertificate(
        n_bits=n_bits, log2_radix=log2_radix, levels=lv, k=k, taps=taps,
        per_element=per, bound=k * taps * per, exact=ext.exact,
        witness=ext.witness(lv))


# ------------------------------------------------------------- call guard
def certify_mode() -> str:
    """Guard mode from ``L2R_CERTIFY``: off | warn (default) | strict."""
    mode = os.environ.get("L2R_CERTIFY", "warn").strip().lower()
    if mode not in ("off", "warn", "strict"):
        raise ValueError(f"L2R_CERTIFY must be off/warn/strict, got {mode!r}")
    return mode


_WARNED: set = set()


def check_or_raise(n_bits: int, log2_radix: int, k: int,
                   levels: int | None = None, taps: int = 1,
                   where: str = "l2r", mode: str | None = None,
                   ) -> OverflowCertificate | None:
    """Call-time overflow guard for dispatch/quantize entry points.

    Returns the certificate (None in ``off`` mode).  Unsound configs
    raise OverflowError in ``strict`` mode and warn once per config in
    ``warn`` mode — warn is the default so existing mod-2^32 parity
    workloads (e.g. 16-bit schedule-equivalence tests) keep running
    while still surfacing that their exactness claim does not hold.
    """
    mode = certify_mode() if mode is None else mode
    if mode == "off":
        return None
    cert = certify(n_bits, log2_radix, k, levels=levels, taps=taps)
    if not cert.sound:
        msg = f"{where}: {cert.describe()}"
        if mode == "strict":
            raise OverflowError(msg)
        key = (where, n_bits, log2_radix, cert.levels, k, taps)
        if key not in _WARNED:
            _WARNED.add(key)
            warnings.warn(msg, AccumulatorOverflowWarning, stacklevel=3)
    return cert


# ---------------------------------------------------------- config sweep
def audit_registry() -> list[dict]:
    """Certify the L2R contractions of every config in the arch registry.

    For each arch this certifies the digit config its ``l2r`` /
    ``attn_l2r`` switch runs — the declared ``QuantConfig`` when set, the
    default otherwise (``declared`` records which) — at the arch's real
    contraction lengths: the head walk over ``d_model`` (serve/engine.py
    quantizes head weights with ``k = d_model``) and the attention score
    walk over ``head_dim``.  Returns one report row per (arch, site).
    """
    # deferred: the configs pull in the models
    from repro_torch.configs import registry
    from repro_torch.core.quant import QuantConfig

    rows = []
    for arch in registry.ARCHS:
        cfg = registry.get_config(arch)
        sites = [
            ("head", cfg.l2r, cfg.l2r_levels, cfg.d_model),
            ("attention", cfg.attn_l2r, cfg.attn_levels, cfg.head_dim),
        ]
        for site, qc, levels, k in sites:
            declared = qc is not None
            if qc is None:
                qc = QuantConfig()
            cert = certify(qc.n_bits, qc.log2_radix, k, levels=levels)
            rows.append({"arch": arch, "site": site, "declared": declared,
                         **cert.to_json()})
    return rows
