"""Continuous batching: slot-based request scheduling over the decode step.

The port of ``repro/serve/batching.py`` on one card.  The engine keeps a
fixed-size slot array (the decode step always sees the same batch
shape), tracks per-slot positions in the LMState, and:

  * admits queued requests into free slots by running a one-row prefill
    (through its power-of-2 length bucket) and splicing its caches and
    position into the live batch state, in place;
  * steps all slots with one decode call (idle slots ride along);
  * retires slots on EOS, on the token budget or at the cache bound.

The reference donates the state to its jitted decode step; here the
decode step updates the state in place, and ``donate_state=True``
asserts that every state tensor keeps its storage across a step.

With a mesh every rank runs the same host schedule.  In the reference's
``state_sharding="replicated"`` every rank holds the whole slot state and
only the progressive head walk is sharded; in ``"batch"`` each rank holds
and decodes only its contiguous block of slots over the data axes
(``sharding/axes.py:batch_rows``), stepping them in a ``ctx.row_shard``
scope so that the head walk takes those rows; in ``"specs"`` (params
from ``sharding/axes.py:shard_params``) the backbone is split over
``model`` and each rank holds its part of its slots' state: its kv heads,
or in the head_dim layout its values' slice of every head, its SSD
heads, its RG-LRU channels
(:func:`~repro_torch.serve.engine.local_state`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.policy import LevelPolicy, PrecisionClass
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_lm_state
from repro_torch.sharding import ctx
from repro_torch.sharding.axes import (batch_rows, params_split,
                                       splits_anything)

from .engine import (bucket_for, make_bucket_prefill_step, make_decode_step,
                     make_prefill_step, prefill_buckets,
                     supports_bucketed_prefill)

__all__ = ["Request", "ContinuousBatcher", "infer_batch_axes",
           "state_batch_axes", "latency_percentiles", "progressive_stats",
           "check_state_sharding", "init_sharded_state"]


def latency_percentiles(ttft: list, tpot: list) -> dict:
    """p50/p99 over per-request latency samples (seconds); 0.0 when no
    samples — the stats() schema stays fixed from construction on."""
    def p(xs, q):
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    return {"ttft_p50_s": p(ttft, 50), "ttft_p99_s": p(ttft, 99),
            "tpot_p50_s": p(tpot, 50), "tpot_p99_s": p(tpot, 99)}


def progressive_stats(n_levels: int, exit_hist, prefill_exit_hist,
                      exit_hist_by_class: dict,
                      prefill_exit_hist_by_class: dict) -> dict:
    """The progressive saved-levels stats block, shared by
    `ContinuousBatcher.stats` and `ServingGateway.stats` so the schema
    cannot drift between the two engines:

      * level histograms are positional lists indexed by 0-based MSDF
        exit level (``hist[l]`` = tokens committed after ``l + 1``
        levels);
      * per-class maps key on the precision class's
        :meth:`~repro_torch.core.policy.PrecisionClass.label` string
        ("exact", "budget(3)", "bounded(0.0001)"), sorted, each value a
        positional level-hist list of the same length.
    """
    levels = np.arange(n_levels)
    total = int(np.sum(exit_hist))
    mean_exit = (float((exit_hist * levels).sum() / total)
                 if total else 0.0)
    total_p = int(np.sum(prefill_exit_hist))
    return dict(
        n_levels=n_levels,
        exit_level_hist=np.asarray(exit_hist).tolist(),
        mean_exit_level=mean_exit,
        mean_levels_saved=(float(n_levels - 1 - mean_exit)
                           if total else 0.0),
        prefill_exit_level_hist=np.asarray(prefill_exit_hist).tolist(),
        mean_prefill_exit_level=(
            float((prefill_exit_hist * levels).sum() / total_p)
            if total_p else 0.0),
        exit_level_hist_by_class={
            k: np.asarray(v).tolist()
            for k, v in sorted(exit_hist_by_class.items())},
        prefill_exit_level_hist_by_class={
            k: np.asarray(v).tolist()
            for k, v in sorted(prefill_exit_hist_by_class.items())},
    )


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (prompt_len,)
    max_new_tokens: int
    eos_id: int | None = None
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    # progressive mode: MSDF exit level of each decoded token
    exit_levels: list = dataclasses.field(default_factory=list)
    # progressive mode: exit level of the streamed prefill head (the
    # first generated token, from the LAST prompt position's stream)
    prefill_exit_level: int | None = None
    # progressive mode: this request's precision class (None = the
    # engine's default class)
    precision: PrecisionClass | None = None
    done: bool = False
    # latency stamps (time.perf_counter seconds): ``t_arrival`` at
    # submit() unless pre-stamped (traffic replay), ``t_first_token``
    # when the first token is committed, ``t_complete`` at retirement.
    # TTFT = t_first_token - t_arrival, mean TPOT = (t_complete -
    # t_first_token) / (len(output) - 1).
    t_arrival: float | None = None
    t_first_token: float | None = None
    t_complete: float | None = None


# ------------------------------------------------------------ state trees
def _map(fn, tree, *rest):
    """``fn`` over the leaves of a state tree (LMState, KVCache, dicts,
    lists; None fields stay None), with same-structure ``rest`` trees
    riding along."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, getattr(tree, f),
                                 *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name),
                         *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def _tensors(tree, leaf=torch.Tensor) -> list[torch.Tensor]:
    """Every tensor of a tree (params with their weight records and plane
    stacks, or a state), in a fixed order; ``leaf``: the leaf type (P for
    a spec tree of the same structure)."""
    out: list[torch.Tensor] = []

    def walk(t):
        if isinstance(t, leaf):
            out.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif dataclasses.is_dataclass(t):
            for f in dataclasses.fields(t):
                walk(getattr(t, f.name))

    walk(tree)
    return out


def _check_params_device(params, dev: torch.device) -> None:
    for t in _tensors(params):
        if t.device != dev:
            raise ValueError(f"the params hold a tensor on {t.device}; this "
                             f"engine runs on {dev}: move them there first")


def _storage(state) -> list[int]:
    return [t.data_ptr() for t in _tensors(state)]


def infer_batch_axes(a, b):
    """Per-leaf batch-axis tree, derived from the state STRUCTURE: the
    same init at two batch sizes; each leaf's batch axis is the unique
    axis whose size changed, -1 for a batch-independent leaf."""
    def ax(x, y):
        diffs = [i for i, (p, q) in enumerate(zip(x.shape, y.shape))
                 if p != q]
        if not diffs:
            return -1
        assert len(diffs) == 1, f"ambiguous batch axis: {x.shape} vs {y.shape}"
        return diffs[0]

    return _map(ax, a, b)


def state_batch_axes(cfg: ModelConfig, max_len: int,
                     cache_dtype: torch.dtype = torch.float32):
    """Batch-axis tree of the LM serving state (see infer_batch_axes),
    from two inits on the ``meta`` device (no memory, no arithmetic)."""
    return infer_batch_axes(
        init_lm_state(cfg, 1, max_len, cache_dtype, device="meta"),
        init_lm_state(cfg, 2, max_len, cache_dtype, device="meta"))


def check_state_sharding(cfg: ModelConfig, params, mesh,
                         state_sharding: str) -> None:
    """Refuse a slot layout the params or the mesh cannot serve:
    ``"specs"`` needs a mesh and, where the layout splits anything over
    its model axis (sharding/axes.py:splits_anything), params split by
    ``sharding/axes.py:shard_params``; ``"replicated"`` and ``"batch"``
    need whole params."""
    split = params_split(cfg, params)
    if state_sharding != "specs":
        if split:
            raise ValueError(
                f"state_sharding={state_sharding!r} serves whole params; "
                f"params split by shard_params serve with 'specs'")
        return
    if mesh is None:
        raise ValueError("state_sharding='specs' needs a mesh")
    if not split and splits_anything(cfg, mesh):
        raise ValueError("state_sharding='specs' serves the params split "
                         "over the model axis: pass "
                         "sharding/axes.py:shard_params(cfg, params, mesh)")


def init_sharded_state(cfg: ModelConfig, mesh, batch: int, rows: int,
                       max_len: int, cache_dtype: torch.dtype, device):
    """The ``"specs"`` slot state of ``rows`` of ``batch`` slots: each
    leaf this rank's part (:func:`~repro_torch.serve.engine.
    local_state`), allocated at that size (checked against it)."""
    from .engine import local_state

    with ctx.model_shard(mesh):
        state = init_lm_state(cfg, rows, max_len, cache_dtype,
                              device=device)
    whole = init_lm_state(cfg, batch, max_len, cache_dtype, device="meta")
    for got, want in zip(_tensors(state),
                         _tensors(local_state(cfg, mesh, whole)),
                         strict=True):
        assert got.shape == want.shape, (tuple(got.shape),
                                         tuple(want.shape))
    return state


def _pad_value(b: torch.Tensor):
    """Empty sentinel for donor-cache padding.  Integer leaves carry
    position/validity semantics in the state (positions use -1 = empty),
    so EVERY integer dtype pads with the all-ones "empty" sentinel, the
    int8 key planes of ``attn_l2r`` included: -1 for signed, the maximum
    (the same bit pattern) for unsigned; floats and bools pad with 0."""
    if b.dtype.is_floating_point or b.dtype == torch.bool \
            or b.dtype.is_complex:
        return 0
    if b.dtype in (torch.uint8, torch.uint16, torch.uint32, torch.uint64):
        return int(torch.iinfo(b.dtype).max)
    return -1


def _splice(batch_tree, single_tree, slot: int, axes_tree):
    """Copy ``single`` (batch-1 leaves) into ``batch`` at index ``slot``
    of each leaf's batch axis (``axes_tree``, from infer_batch_axes), in
    place, and return ``batch``.

    A donor leaf may be shorter than the live one in non-batch dims: it
    lands at offset 0 and the rest of the slot row takes
    :func:`_pad_value` (positions past the donor are empty)."""
    def f(b, s, ax):
        if ax < 0:  # batch-independent leaf: nothing to splice
            return b
        want = tuple(1 if i == ax else d for i, d in enumerate(b.shape))
        dst = b.narrow(ax, slot, 1)
        if tuple(s.shape) != want:
            dst.fill_(_pad_value(b))
            dst = dst[tuple(slice(0, d) for d in s.shape)]
        dst.copy_(s)
        return b

    _map(f, batch_tree, single_tree, axes_tree)
    return batch_tree


def _row(tree, i: int, axes_tree):
    """Row ``i`` of each leaf's batch axis, as views."""
    return _map(lambda x, a: x.narrow(a, i, 1) if a >= 0 else x, tree,
                axes_tree)


class ContinuousBatcher:
    def __init__(self, cfg: ModelConfig, params, n_slots: int = 4,
                 max_len: int = 128, cache_dtype: torch.dtype = torch.float32,
                 progressive: bool = False, early_exit: bool = False,
                 donate_state: bool = True, bucketed: bool | None = None,
                 default_class: PrecisionClass | None = None,
                 device: str | torch.device | None = None,
                 mesh=None, state_sharding: str = "replicated"):
        """Slots, caches and steps live on ``device`` (CUDA unless given;
        raises without it); ``params`` must already be there.

        ``mesh`` (default: the installed mesh, sharding/ctx.py) makes the
        engine mesh-aware: every rank of the mesh builds this engine with
        the same arguments and requests and the progressive head streams
        as the consensus walk.  With ``state_sharding="replicated"`` each
        rank holds the whole slot state and steps the backbone on it; with
        ``"batch"`` it holds only its block of ``n_slots / dp`` slots
        (``sharding/axes.py:batch_rows``; the whole state where the data
        axes do not divide ``n_slots``) and decodes those rows in a
        ``ctx.row_shard`` scope.  ``"specs"`` (the reference's
        ``state_specs`` layout) serves params split over ``model``
        (``sharding/axes.py:shard_params``, after ``prepare_params``):
        the rows as in ``"batch"``, and of them only this rank's part
        (its kv heads, or its slice of each head's values, its SSD heads,
        its RG-LRU channels), the backbone tensor-parallel
        (:func:`check_state_sharding` says what it refuses).  Every rank
        prefills every admitted request (a one-row prefill does not
        split), the slot's owner splices it, and every rank keeps the same
        requests, tokens and histograms.  Tokens, exit levels and stats
        equal the unmeshed engine's bit for bit.

        ``donate_state=True`` (default) asserts after every decode step
        that each state tensor kept its storage: the step wrote the
        caches in place instead of copying them.  ``False`` clones the
        state before each step, so the previous state stays intact.

        ``bucketed`` routes admits through power-of-2 prompt-length
        buckets (engine.make_bucket_prefill_step): bit-exact, one prefill
        shape per bucket.  Default None = on for attention-mixer
        families (with local windows, when the cache bound fits the
        window).

        ``default_class`` (progressive mode) is the precision class of
        requests without their own ``Request.precision`` and of idle
        slot rows; default ``bounded(0.0)``, the plain early-exit walk.
        Each admitted request's class is spliced into the per-slot
        :class:`~repro_torch.core.policy.LevelPolicy` rows, so one decode
        loop serves a mixed exact / budget / bounded batch.
        """
        if state_sharding not in ("replicated", "batch", "specs"):
            raise ValueError(f"state_sharding={state_sharding!r}: one of "
                             f"'replicated', 'batch', 'specs'")
        self.device = resolve_device(device)
        _check_params_device(params, self.device)
        self.cfg = cfg
        self.params = params
        self.mesh = mesh if mesh is not None else ctx.get_mesh()
        check_state_sharding(cfg, params, self.mesh, state_sharding)
        self.n_slots = n_slots
        self.max_len = max_len
        self.progressive = progressive
        self.donate_state = donate_state
        # this rank's slots [r0, r0 + n_local) of the state (all of them
        # unless the "batch" layout splits them)
        self._rows, self._r0, self._n_local = batch_rows(
            self.mesh if state_sharding != "replicated" else None, n_slots)
        if state_sharding == "specs":
            self.state = init_sharded_state(cfg, self.mesh, n_slots,
                                            self._n_local, max_len,
                                            cache_dtype, self.device)
        else:
            self.state = init_lm_state(cfg, self._n_local, max_len,
                                       cache_dtype, device=self.device)
        # every slot's next position, on the host of every rank
        self._pos = np.zeros(n_slots, np.int64)
        # explicit per-leaf batch axes for slot splicing (derived from the
        # state structure, never from shape coincidences)
        self._axes = state_batch_axes(cfg, max_len, cache_dtype)
        self.slot_req: list[Request | None] = [None] * n_slots
        self.cur_tok = torch.zeros((n_slots, 1), dtype=torch.int32,
                                   device=self.device)
        self.queue: list[Request] = []
        step_kw = dict(progressive=progressive, early_exit=early_exit,
                       mesh=self.mesh)
        self._decode = make_decode_step(cfg, **step_kw)
        self._prefill1 = make_prefill_step(cfg, max_len, cache_dtype,
                                           **step_kw)
        if bucketed is None:
            local = any(k == "local" for k, _ in cfg.layer_kinds())
            bucketed = supports_bucketed_prefill(cfg) and \
                (not local or max_len <= cfg.window)
        self.bucketed = bucketed
        if bucketed:
            self._buckets = prefill_buckets(max_len)
            self._bucket_prefill = make_bucket_prefill_step(
                cfg, max_len, cache_dtype, **step_kw)
        self.steps = 0
        # the (rows, length) shapes of every prefill call
        self.prefill_shapes: set[tuple[int, int]] = set()
        # saved-levels accounting (progressive mode): histograms over the
        # exit level of every decoded token and of every streamed prefill
        # head, in total and per precision class
        self.n_levels = (2 * cfg.l2r.planes - 1
                         if progressive and cfg.l2r is not None else 0)
        self.exit_hist = np.zeros(max(self.n_levels, 1), np.int64)
        self.prefill_exit_hist = np.zeros(max(self.n_levels, 1), np.int64)
        if default_class is not None and not progressive:
            raise ValueError("default_class steers the progressive head "
                             "walk: requires progressive=True")
        self.default_class = (default_class or PrecisionClass.bounded()
                              if progressive else None)
        self.slot_policy = (LevelPolicy.from_classes(
            [self.default_class] * n_slots, device=self.device)
            if progressive else None)
        seed = ({self.default_class.label():
                 np.zeros(max(self.n_levels, 1), np.int64)}
                if progressive else {})
        self.exit_hist_by_class = {k: v.copy() for k, v in seed.items()}
        self.prefill_exit_hist_by_class = dict(seed)
        # per-request latency samples, recorded at retirement (seconds)
        self._ttft: list[float] = []
        self._tpot: list[float] = []

    # ------------------------------------------------------------- api
    def submit(self, req: Request):
        if req.precision is not None and not self.progressive:
            raise ValueError("Request.precision steers the progressive "
                             "head walk: requires progressive=True")
        if req.t_arrival is None:
            req.t_arrival = time.perf_counter()
        self.queue.append(req)

    def _class_of(self, req: Request) -> PrecisionClass:
        return req.precision if req.precision is not None \
            else self.default_class

    def _class_hist(self, hists: dict, label: str) -> np.ndarray:
        if label not in hists:
            hists[label] = np.zeros(max(self.n_levels, 1), np.int64)
        return hists[label]

    def _prefill_request(self, req: Request):
        """One-sequence prefill, through the bucket pad when enabled (the
        returned state is bit-identical to the unpadded prefill's: pad
        cache entries are masked empty, ``pos`` is the true length).
        Progressive: the request's class rides along as a one-row
        LevelPolicy."""
        prompt = np.asarray(req.prompt, np.int32)
        pol1 = (LevelPolicy.from_classes([self._class_of(req)],
                                         device=self.device)
                if self.progressive else None)
        if self.bucketed:
            lb = bucket_for(len(prompt), self._buckets)
            self.prefill_shapes.add((1, lb))
            padded = np.zeros((1, lb), np.int32)
            padded[0, :len(prompt)] = prompt
            return self._bucket_prefill(
                self.params, torch.from_numpy(padded).to(self.device),
                torch.tensor([len(prompt)], dtype=torch.int32,
                             device=self.device), pol1)
        self.prefill_shapes.add((1, len(prompt)))
        return self._prefill1(
            self.params,
            {"tokens": torch.from_numpy(prompt[None, :]).to(self.device)},
            pol1)

    def _admit(self):
        for slot in range(self.n_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            if self.progressive:
                # the head streams the LAST prompt position only,
                # committing the first token at its earliest sound level
                # (under the request's class)
                st1, _, tok, lv = self._prefill_request(req)
                first = tok[0, 0]
                level = int(lv[0, 0])
                req.prefill_exit_level = level
                self.prefill_exit_hist[level] += 1
                cls = self._class_of(req)
                self._class_hist(self.prefill_exit_hist_by_class,
                                 cls.label())[level] += 1
                self.slot_policy = self.slot_policy.set_row(slot, cls)
            else:
                st1, logits = self._prefill_request(req)
                first = torch.argmax(logits[0, -1]).to(torch.int32)
            # the slot's owner copies the one-row state into its rows
            if self._r0 <= slot < self._r0 + self._n_local:
                _splice(self.state, st1, slot - self._r0, self._axes)
            self._pos[slot] = int(st1.pos[0])
            self.cur_tok[slot, 0] = first
            req.output.append(int(first))
            req.t_first_token = time.perf_counter()
            self.slot_req[slot] = req

    def _retire(self):
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            eos = req.eos_id is not None and req.output and \
                req.output[-1] == req.eos_id
            full = len(req.output) >= req.max_new_tokens
            of_cache = self._pos[slot] >= self.max_len - 1
            if eos or full or of_cache:
                req.done = True
                req.t_complete = time.perf_counter()
                if req.t_arrival is not None and req.t_first_token is not None:
                    self._ttft.append(req.t_first_token - req.t_arrival)
                    if len(req.output) > 1:
                        self._tpot.append(
                            (req.t_complete - req.t_first_token)
                            / (len(req.output) - 1))
                self.slot_req[slot] = None
                if self.progressive:
                    # idle rows revert to the default class, so an
                    # `exact` occupant cannot pin the early-exit loop at
                    # full depth after retirement
                    self.slot_policy = self.slot_policy.set_row(
                        slot, self.default_class)

    def step(self):
        """One engine iteration: admit, decode all slots, retire."""
        self._admit()
        if all(r is None for r in self.slot_req):
            return False
        state = self.state if self.donate_state \
            else _map(torch.clone, self.state)
        before = _storage(state) if self.donate_state else None
        tok = self.cur_tok[self._r0:self._r0 + self._n_local]
        scope = ctx.row_shard(self.mesh, self._rows) if self._rows \
            else contextlib.nullcontext()
        with scope:
            if self.progressive:
                self.state, nxt, _, lv = self._decode(
                    self.params, state, tok, None, self.slot_policy)
                lv = lv[:, 0].tolist()
            else:
                self.state, nxt, _ = self._decode(self.params, state, tok)
                lv = None
        self._pos += 1  # the step advanced every slot
        if before is not None:
            assert _storage(self.state) == before, \
                "the decode step copied the state instead of updating it"
        self.cur_tok = nxt
        nxt = nxt[:, 0].tolist()
        for slot, req in enumerate(self.slot_req):
            if req is not None:
                req.output.append(nxt[slot])
                if lv is not None:
                    req.exit_levels.append(lv[slot])
                    self.exit_hist[lv[slot]] += 1
                    self._class_hist(self.exit_hist_by_class,
                                     self._class_of(req).label())[
                        lv[slot]] += 1
        self.steps += 1
        self._retire()
        return True

    def run(self, max_steps: int = 10_000):
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and self.steps < max_steps:
            if not self.step() and self.queue:
                continue
        return self.steps

    def stats(self, latency: bool = False) -> dict:
        """Engine counters; in progressive mode also the saved-levels
        histograms (:func:`progressive_stats`, the schema shared with
        `ServingGateway.stats`, present from construction on).
        ``latency=True`` adds wall-clock percentiles over retired
        requests (opt-in: the default schema is deterministic for a fixed
        request set)."""
        out = {"steps": self.steps, "progressive": self.progressive}
        if latency:
            out.update(completed=len(self._ttft),
                       **latency_percentiles(self._ttft, self._tpot))
        if self.progressive:
            out.update(
                tokens=int(self.exit_hist.sum()),
                prefills=int(self.prefill_exit_hist.sum()),
                **progressive_stats(self.n_levels, self.exit_hist,
                                    self.prefill_exit_hist,
                                    self.exit_hist_by_class,
                                    self.prefill_exit_hist_by_class),
            )
        return out
