"""Serving gateway: bucketed packed prefill, warmup, in-place decode,
async emit.

The port of ``repro/serve/gateway.py`` on one card: the request-queue
front end over the serving engine.  Against `ContinuousBatcher` it
removes three per-request and per-step costs:

  * **Bucketed, packed prefill**: prompts right-pad to power-of-2 length
    buckets (`engine.prefill_buckets`) and up to ``prefill_group``
    queued prompts share ONE prefill call at a fixed ``(group, bucket)``
    shape.  Bit-exact (pad cache entries are masked empty, the head
    reads the true last position: `engine.make_bucket_prefill_step`).
  * **Warmup**: every bucket's prefill and the decode step run once on
    dummy inputs at construction, so the kernel libraries are built and
    the allocator holds its pools before the first request.  (The
    reference compiles its executables ahead of time; eager PyTorch has
    nothing to compile, and no CUDA graph is captured: ``quantize``
    copies a host scalar and the early-exit walk reads a flag on the
    host, and either breaks a capture.)  The decode step updates the
    slot state in place.
  * **Async emit**: the device loop never reads a device value.  Token
    tensors go through a bounded queue to an emit thread that copies
    them to the host, appends tokens to requests, stamps latency and
    detects EOS.  Retirement on the token budget is computed on the host
    at admission (``min(max_new_tokens, max_len - prompt_len)`` tokens,
    the batcher's semantics), so the loop frees slots without waiting on
    results; EOS retirement lags by the queue depth and is signalled back
    as a ``(slot, generation)`` pair, so a stale signal cannot free a
    reassigned slot.  The loop never writes a tensor it has handed to
    the thread: the token rows are rebuilt (not written in place) when
    a request is admitted.

Output streams are bit-identical to `ContinuousBatcher` for the same
request set: bucketed prefill is bit-exact, rows of a packed prefill are
independent, and decode rows are independent (on the card too:
models/common.py:_row_mean, models/attention.py:_fixed_pairs).

With a mesh (``mesh=``) every rank runs the same gateway on the same
requests with the whole slot state, and the progressive head streams as
the consensus walk.  The ranks must then take the same schedule, so the
loop reads EOS retirements only after the emit queue has drained (a host
wait a step), and ``run(realtime=True)``, whose admissions follow each
rank's own clock, is refused.
"""

from __future__ import annotations

import functools
import queue
import threading
import time

import numpy as np
import torch

from repro_torch.core.policy import LevelPolicy, PrecisionClass
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_lm_state
from repro_torch.sharding import ctx
from repro_torch.sharding.axes import dp_axes

from .batching import (Request, _check_params_device, _row, _splice,
                       check_state_sharding, init_sharded_state,
                       _storage, latency_percentiles, progressive_stats,
                       state_batch_axes)
from .engine import (bucket_for, make_bucket_prefill_step, make_decode_step,
                     prefill_buckets, supports_bucketed_prefill)

__all__ = ["ServingGateway"]


class _EmitThread:
    """Bounded-queue emit worker: drains (kind, entries, tensors) items,
    doing the host copies OFF the device loop.  One FIFO drained by one
    thread processes dispatches in device order, so each request's tokens
    append in sequence order.  Worker exceptions are captured and
    re-raised at flush()/close()."""

    def __init__(self, process, depth: int):
        self._process = process
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="gateway-emit")
        self._t.start()

    def put(self, item):
        self._q.put(item)

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._err is None:  # fail-stop: keep draining, no work
                    self._process(item)
            except BaseException as e:  # re-raised on the caller's thread
                self._err = e
            finally:
                self._q.task_done()

    def flush(self):
        """Block until every queued item is processed; re-raise worker
        errors on the calling thread."""
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        self.flush()
        self._q.put(None)
        self._t.join()


class _Slot:
    """Host-side per-slot bookkeeping: the owning request, the decode
    steps left (token-budget retirement, known at admission), and a
    generation counter so retirement signals for a PREVIOUS occupant
    cannot free the current one."""

    __slots__ = ("req", "rem", "gen")

    def __init__(self):
        self.req: Request | None = None
        self.rem = 0
        self.gen = 0


class ServingGateway:
    """Offline-inference loop and online request-queue server over the
    serving engine; the public surface mirrors `ContinuousBatcher`:

        gw = ServingGateway(cfg, params, n_slots=8, max_len=128)
        gw.submit(Request(uid=0, prompt=..., max_new_tokens=32))
        gw.run()                  # offline: drain everything
        gw.run(realtime=True)     # online: honor Request.t_arrival stamps
        gw.stats()

    ``prefill_group`` is the packed-prefill width: up to that many
    queued prompts (sharing a length bucket) prefill in one call; short
    groups pad with dummy rows (``true_len = 1``) whose outputs are
    ignored, so the shape never varies.  ``aot_warmup`` runs every
    bucket's prefill and the decode step once at construction
    (``warmup_s`` keeps each one's seconds); ``async_emit=False`` runs
    the emit work inline (same code path, synchronous).  Everything runs
    on ``device`` (CUDA unless given; raises without it), where
    ``params`` must already be.

    ``default_class`` mirrors `ContinuousBatcher`: the precision class of
    requests without their own and of idle and dummy rows (default
    ``bounded(0.0)``); admission splices each request's class into the
    per-slot LevelPolicy rows, and packed prefills carry a per-row group
    policy.

    ``mesh`` (default: the installed mesh, sharding/ctx.py) serves with
    replicated state and the sharded head walk, as the batcher's
    ``mesh=``; tokens, exit levels and the stats' counts and histograms
    equal the unmeshed gateway's bit for bit.  ``state_sharding="specs"``
    serves params split over the model axis
    (``sharding/axes.py:shard_params``), each rank holding its part of
    every slot's state, as the batcher's ``"specs"`` (which also refuses); the
    gateway's slots are not split over the data axes, so it refuses a
    mesh whose data axes have more than one rank there.
    """

    def __init__(self, cfg: ModelConfig, params, n_slots: int = 8,
                 max_len: int = 128, cache_dtype: torch.dtype = torch.float32,
                 progressive: bool = False, early_exit: bool = False,
                 prefill_group: int = 4, buckets: tuple[int, ...] | None = None,
                 aot_warmup: bool = True, async_emit: bool = True,
                 emit_queue_depth: int = 8,
                 default_class: PrecisionClass | None = None,
                 device: str | torch.device | None = None, mesh=None,
                 state_sharding: str = "replicated"):
        assert supports_bucketed_prefill(cfg), \
            "gateway serving needs bucketed prefill: attention families only"
        self.device = resolve_device(device)
        _check_params_device(params, self.device)
        self.cfg = cfg
        self.params = params
        self.mesh = mesh if mesh is not None else ctx.get_mesh()
        if state_sharding not in ("replicated", "specs"):
            raise ValueError(f"state_sharding={state_sharding!r}: the "
                             f"gateway serves 'replicated' or 'specs'")
        check_state_sharding(cfg, params, self.mesh, state_sharding)
        if state_sharding == "specs" and ctx.mesh_axis_size(
                self.mesh, dp_axes(self.mesh)) > 1:
            raise ValueError("ServingGateway(state_sharding='specs'): its "
                             "slots are not split over the data axes; use a "
                             "mesh whose data axes have one rank")
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.progressive = progressive
        self.prefill_group = prefill_group
        self.buckets = tuple(buckets) if buckets else prefill_buckets(max_len)
        assert self.buckets[-1] == max_len, \
            "the largest bucket must be the cache bound"

        if state_sharding == "specs":
            self._new_state = functools.partial(
                init_sharded_state, cfg, self.mesh, n_slots, n_slots,
                max_len, cache_dtype, self.device)
        else:
            self._new_state = functools.partial(
                init_lm_state, cfg, n_slots, max_len, cache_dtype,
                device=self.device)
        self.state = self._new_state()
        self._axes = state_batch_axes(cfg, max_len, cache_dtype)
        self.cur_tok = torch.zeros((n_slots, 1), dtype=torch.int32,
                                   device=self.device)

        if default_class is not None and not progressive:
            raise ValueError("default_class steers the progressive head "
                             "walk: requires progressive=True")
        self.default_class = (default_class or PrecisionClass.bounded()
                              if progressive else None)
        self.slot_policy = (LevelPolicy.from_classes(
            [self.default_class] * n_slots, device=self.device)
            if progressive else None)

        step_kw = dict(progressive=progressive, early_exit=early_exit,
                       mesh=self.mesh)
        self._prefill_fn = make_bucket_prefill_step(cfg, max_len, cache_dtype,
                                                    **step_kw)
        self._decode_fn = make_decode_step(cfg, **step_kw)
        self.warmup_s: dict = {}
        if aot_warmup:
            self.warmup()

        self._slots = [_Slot() for _ in range(n_slots)]
        self.queue: list[Request] = []
        self.steps = 0
        self.prefills = 0
        # the (rows, bucket) shapes of every prefill call after warmup
        self.prefill_shapes: set[tuple[int, int]] = set()

        # emit-side accounting (owned by the emit thread; read after
        # flush())
        self.n_levels = (2 * cfg.l2r.planes - 1
                         if progressive and cfg.l2r is not None else 0)
        self.exit_hist = np.zeros(max(self.n_levels, 1), np.int64)
        self.prefill_exit_hist = np.zeros(max(self.n_levels, 1), np.int64)
        seed = ({self.default_class.label():
                 np.zeros(max(self.n_levels, 1), np.int64)}
                if progressive else {})
        self.exit_hist_by_class = {k: v.copy() for k, v in seed.items()}
        self.prefill_exit_hist_by_class = dict(seed)
        self._ttft: list[float] = []
        self._tpot: list[float] = []
        self._tokens = 0
        self._completed = 0
        self._elapsed = 0.0
        # EOS retirement signals from the emit thread: (slot, generation)
        self._eos_lock = threading.Lock()
        self._eos_signals: set[tuple[int, int]] = set()
        self._emit = (_EmitThread(self._process_emit, emit_queue_depth)
                      if async_emit else None)

    # ---------------------------------------------------------- warmup
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _group_policy(self, classes) -> LevelPolicy | None:
        if not self.progressive:
            return None
        classes = list(classes)
        classes += [self.default_class] * (self.prefill_group - len(classes))
        return LevelPolicy.from_classes(classes, device=self.device)

    def warmup(self):
        """Run one prefill per bucket at the ``(prefill_group, bucket)``
        shape and one decode step on a scratch state, on dummy inputs:
        the kernel libraries get built and the allocator's pools filled
        before the first request.  ``warmup_s[bucket]`` and
        ``warmup_s["decode"]`` keep the seconds of each."""
        g = self.prefill_group
        dev = self.device
        with torch.no_grad():
            for lb in self.buckets:
                if lb in self.warmup_s:
                    continue
                self._sync()
                t0 = time.perf_counter()
                self._prefill_fn(
                    self.params, torch.zeros((g, lb), dtype=torch.int32,
                                             device=dev),
                    torch.ones((g,), dtype=torch.int32, device=dev),
                    self._group_policy([]))
                self._sync()
                self.warmup_s[lb] = time.perf_counter() - t0
            if "decode" not in self.warmup_s:
                scratch = self._new_state()
                self._sync()
                t0 = time.perf_counter()
                args = (None, self.slot_policy) if self.progressive else ()
                self._decode_fn(self.params, scratch, self.cur_tok, *args)
                self._sync()
                self.warmup_s["decode"] = time.perf_counter() - t0
                del scratch

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

    def run(self, requests=None, max_steps: int = 100_000,
            realtime: bool = False):
        """Serve until the queue and all slots drain (or ``max_steps``
        decode calls).  ``requests`` is submitted first.
        ``realtime=True`` honors future ``Request.t_arrival`` stamps (a
        pre-stamped trace replays in real time); otherwise every queued
        request is admissible at once."""
        if realtime and self.mesh is not None:
            raise ValueError("run(realtime=True) admits by each rank's own "
                             "clock; under a mesh the ranks must take the "
                             "same schedule")
        if requests is not None:
            for r in requests:
                self.submit(r)
        t0 = time.perf_counter()
        steps0 = self.steps
        with torch.no_grad():
            while self.queue or any(s.req is not None for s in self._slots):
                if self.steps - steps0 >= max_steps:
                    break
                self._drain_eos_signals()
                self._admit(realtime)
                if all(s.req is None for s in self._slots):
                    if not self.queue:
                        break
                    if realtime:
                        nxt = min(r.t_arrival for r in self.queue)
                        dt = nxt - time.perf_counter()
                        if dt > 0:
                            time.sleep(min(dt, 0.05))
                        continue
                    # EOS-retirement lag can leave every slot waiting on
                    # the emit thread while the queue still holds work
                    self._flush_emit()
                    continue
                self._decode_step()
        self._flush_emit()
        self._drain_eos_signals()
        self._elapsed += time.perf_counter() - t0
        return self.steps

    def stats(self, latency: bool = True) -> dict:
        """Gateway counters (emit thread flushed first): dispatch and
        token counts, throughput, the progressive saved-levels histograms
        (the schema of `ContinuousBatcher.stats`), and, unless
        ``latency=False``, p50/p99 TTFT and per-output-token seconds over
        completed requests."""
        self._flush_emit()
        out = {"steps": self.steps, "prefills": self.prefills,
               "progressive": self.progressive, "tokens": self._tokens,
               "completed": self._completed,
               "buckets": list(self.buckets),
               "tokens_per_s": (self._tokens / self._elapsed
                                if self._elapsed > 0 else 0.0)}
        if self.progressive:
            out.update(progressive_stats(self.n_levels, self.exit_hist,
                                         self.prefill_exit_hist,
                                         self.exit_hist_by_class,
                                         self.prefill_exit_hist_by_class))
        if latency:
            out.update(latency_percentiles(self._ttft, self._tpot))
        return out

    def close(self):
        if self._emit is not None:
            self._emit.close()
            self._emit = None

    # ------------------------------------------------------ device loop
    def _free_slots(self):
        return [i for i, s in enumerate(self._slots) if s.req is None]

    def _admissible(self, realtime: bool):
        if not realtime:
            return self.queue
        now = time.perf_counter()
        return [r for r in self.queue if r.t_arrival <= now]

    def _admit(self, realtime: bool = False):
        """Admit queued requests by PACKED bucket prefill: up to
        ``prefill_group`` admissible prompts sharing a length bucket go
        through one fixed-shape call; short groups pad with dummy rows
        (true_len 1) whose outputs are never read."""
        while True:
            free = self._free_slots()
            cand = self._admissible(realtime)
            if not free or not cand:
                return
            lb = bucket_for(len(cand[0].prompt), self.buckets)
            group: list[Request] = []
            for r in cand:  # FIFO scan: later prompts may share the bucket
                if len(group) >= min(len(free), self.prefill_group):
                    break
                if bucket_for(len(r.prompt), self.buckets) <= lb:
                    group.append(r)
            for r in group:
                self.queue.remove(r)

            g = self.prefill_group
            tokens = np.zeros((g, lb), np.int32)
            true_len = np.ones((g,), np.int32)  # dummy rows: one pad token
            for i, r in enumerate(group):
                p = np.asarray(r.prompt, np.int32)
                tokens[i, :len(p)] = p
                true_len[i] = len(p)
            out = self._prefill_fn(
                self.params, torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(true_len).to(self.device),
                self._group_policy(self._class_of(r) for r in group))
            self.prefill_shapes.add((g, lb))
            if self.progressive:
                st1, _, tok, lv = out
            else:
                st1, logits = out
                tok = torch.argmax(logits[:, -1], dim=-1,
                                   keepdim=True).to(torch.int32)
                lv = None
            self.prefills += 1

            # a new token tensor: the emit thread may still be reading
            # the previous decode's, which cur_tok is
            self.cur_tok = self.cur_tok.clone()
            entries = []
            for i, r in enumerate(group):
                slot = free[i]
                s = self._slots[slot]
                s.req = r
                s.rem = self._budget_steps(r)
                _splice(self.state, _row(st1, i, self._axes), slot,
                        self._axes)
                self.cur_tok[slot, 0] = tok[i, 0]
                if self.progressive:
                    self.slot_policy = self.slot_policy.set_row(
                        slot, self._class_of(r))
                entries.append((i, slot, s.gen, r))
            self._dispatch_emit(("prefill", entries, tok, lv))

    def _budget_steps(self, req: Request) -> int:
        """Decode steps owed to a request AFTER its prefill token, decided
        on the host at admission, as `ContinuousBatcher` retires: every
        admitted request gets at least one decode step, then stops at the
        token budget or the cache bound, whichever bites first."""
        return max(1, min(req.max_new_tokens - 1,
                          self.max_len - 1 - len(req.prompt)))

    def _decode_step(self):
        before = _storage(self.state)
        if self.progressive:
            self.state, tok, _, lv = self._decode_fn(
                self.params, self.state, self.cur_tok, None,
                self.slot_policy)
        else:
            self.state, tok, _ = self._decode_fn(self.params, self.state,
                                                 self.cur_tok)
            lv = None
        assert _storage(self.state) == before, \
            "the decode step copied the state instead of updating it"
        self.cur_tok = tok
        self.steps += 1
        entries = []
        for slot, s in enumerate(self._slots):
            if s.req is None:
                continue
            entries.append((slot, s.gen, s.req))
            s.rem -= 1
            if s.rem <= 0:
                self._release(slot)
        self._dispatch_emit(("decode", entries, tok, lv))

    def _release(self, slot: int):
        s = self._slots[slot]
        s.req = None
        s.rem = 0
        s.gen += 1  # stale EOS signals for the old occupant die here
        if self.progressive:
            # idle rows revert to the default class (an `exact` leftover
            # would pin the early-exit loop at full depth)
            self.slot_policy = self.slot_policy.set_row(
                slot, self.default_class)

    def _drain_eos_signals(self):
        if self.mesh is not None:  # every rank reads the same signals
            self._flush_emit()
        with self._eos_lock:
            signals, self._eos_signals = self._eos_signals, set()
        for slot, gen in signals:
            if self._slots[slot].req is not None and \
                    self._slots[slot].gen == gen:
                self._release(slot)

    # ------------------------------------------------------ emit thread
    def _dispatch_emit(self, item):
        if self._emit is not None:
            self._emit.put(item)
        else:
            self._process_emit(item)

    def _flush_emit(self):
        if self._emit is not None:
            self._emit.flush()

    def _process_emit(self, item):
        """Host-side token landing (emit thread): copy the tensors to the
        host, append tokens in dispatch order, stamp times, detect EOS.
        ``entries`` rows are (row-in-call, slot, gen, req) for a prefill
        and (slot, gen, req) for a decode."""
        kind, entries, tok, lv = item
        tok = tok.cpu().numpy().reshape(-1)
        lv = lv.cpu().numpy().reshape(-1) if lv is not None else None
        now = time.perf_counter()
        if kind == "prefill":
            for row, slot, gen, req in entries:
                req.t_first_token = now
                if lv is not None:
                    level = int(lv[row])
                    req.prefill_exit_level = level
                    self.prefill_exit_hist[level] += 1
                    self._class_hist(self.prefill_exit_hist_by_class,
                                     self._class_of(req).label())[level] += 1
                self._land(req, int(tok[row]), slot, gen)
        else:
            for slot, gen, req in entries:
                if req.done:  # EOS already hit; drop the lagged tokens
                    continue
                if lv is not None:
                    level = int(lv[slot])
                    req.exit_levels.append(level)
                    self.exit_hist[level] += 1
                    self._class_hist(self.exit_hist_by_class,
                                     self._class_of(req).label())[level] += 1
                self._land(req, int(tok[slot]), slot, gen)

    def _land(self, req: Request, t: int, slot: int, gen: int):
        req.output.append(t)
        self._tokens += 1
        n_expect = 1 + self._budget_steps(req)
        eos = req.eos_id is not None and t == req.eos_id
        if eos or len(req.output) >= n_expect:
            req.done = True
            req.t_complete = time.perf_counter()
            if req.t_arrival is not None and req.t_first_token is not None:
                self._ttft.append(req.t_first_token - req.t_arrival)
                if len(req.output) > 1:
                    self._tpot.append((req.t_complete - req.t_first_token)
                                      / (len(req.output) - 1))
            self._completed += 1
            if eos:  # budget retirement the device loop already knows
                with self._eos_lock:
                    self._eos_signals.add((slot, gen))
