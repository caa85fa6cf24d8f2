"""Fault tolerance, straggler mitigation and elastic scaling.

The port of ``repro/runtime/fault.py``, a copy (pure Python).  The train
launcher (launch/train.py) wires its save and restore hooks to
checkpoint/manager.py:CheckpointManager.

On a real 1000+-node fleet these hooks bind to the cluster scheduler
(pod liveness, ICI link health).  The *logic* — what the framework does
when a node dies, lags, or the fleet resizes — is implemented and tested
here with injectable fault sources:

  * FaultTolerantLoop: wraps the train loop; on a step failure it
    restores the latest atomic checkpoint and replays (the data pipeline
    is counter-based, so replay is exact).  Retries are bounded.
  * StragglerPolicy: per-step deadline from an EWMA of step times; a
    straggling step (simulated or real) is skipped with its gradient
    contribution dropped — the EF-compression residual (optim/
    compression.py) absorbs the skipped contribution next step.
  * ElasticMesh: on DP-width change, re-shards the data pipeline and
    re-tiles optimizer state (pure reshape: ZeRO-1 shards are laid out
    so a DP resize is a host-side re-slice, no cross-host shuffle).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

__all__ = ["StragglerPolicy", "FaultTolerantLoop", "ElasticPlan", "elastic_replan"]


@dataclasses.dataclass
class StragglerPolicy:
    """EWMA step-time deadline; flags steps exceeding factor * ewma."""

    factor: float = 3.0
    alpha: float = 0.1
    min_samples: int = 5

    def __post_init__(self):
        self._ewma = None
        self._n = 0

    def observe(self, dt: float) -> None:
        self._n += 1
        self._ewma = dt if self._ewma is None else (
            self.alpha * dt + (1 - self.alpha) * self._ewma
        )

    def deadline(self) -> float | None:
        if self._n < self.min_samples:
            return None
        return self.factor * self._ewma

    def is_straggler(self, dt: float) -> bool:
        d = self.deadline()
        return d is not None and dt > d


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    n_shards: int
    shard: int
    note: str


def elastic_replan(global_batch: int, healthy_hosts: int, host_id: int) -> ElasticPlan:
    """Pick the largest DP width dividing the global batch <= healthy hosts."""
    n = healthy_hosts
    while n > 1 and global_batch % n:
        n -= 1
    return ElasticPlan(
        n_shards=n, shard=host_id % n,
        note=f"resized to {n} data shards for {healthy_hosts} healthy hosts",
    )


class FaultTolerantLoop:
    """Checkpoint/restart supervisor around a step function.

    step_fn(state, batch) -> (state, metrics); save_fn(step, state);
    restore_fn() -> (step, state) | (None, None).  ``fault_source`` is an
    injectable callable(step) -> str|None used by tests to simulate node
    failure ('crash'), stragglers ('slow'), or resizes ('resize:<n>').
    """

    def __init__(
        self,
        step_fn: Callable,
        save_fn: Callable,
        restore_fn: Callable,
        data: Iterable,
        ckpt_every: int = 50,
        max_retries: int = 3,
        straggler: StragglerPolicy | None = None,
        fault_source: Callable[[int], str | None] | None = None,
        on_resize: Callable[[int], None] | None = None,
    ):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.data = data
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.straggler = straggler or StragglerPolicy()
        self.fault_source = fault_source or (lambda s: None)
        self.on_resize = on_resize or (lambda n: None)
        self.events: list[tuple[int, str]] = []

    def run(self, state, n_steps: int, start_step: int = 0):
        step = start_step
        retries = 0
        fail_step = -1  # retries are per failure point: a deterministic
        #                 fault can't loop forever behind a checkpoint
        history = []
        while step < n_steps:
            fault = self.fault_source(step)
            try:
                if fault == "crash":
                    self.events.append((step, "crash"))
                    raise RuntimeError(f"injected node failure at step {step}")
                if fault and fault.startswith("resize:"):
                    n = int(fault.split(":")[1])
                    self.events.append((step, fault))
                    self.on_resize(n)
                t0 = time.perf_counter()
                batch = next(self.data)
                state, metrics = self.step_fn(state, batch)
                dt = time.perf_counter() - t0
                if fault == "slow":
                    dt += (self.straggler.deadline() or 1.0) * 2
                if self.straggler.is_straggler(dt):
                    # drop this step's contribution; EF residual carries it
                    self.events.append((step, "straggler-skip"))
                else:
                    self.straggler.observe(dt)
                history.append(metrics)
                step += 1
                if step % self.ckpt_every == 0:
                    self.save_fn(step, state)
            except RuntimeError:
                if step == fail_step:
                    retries += 1
                else:
                    fail_step, retries = step, 1
                if retries > self.max_retries:
                    raise
                r_step, r_state = self.restore_fn()
                if r_state is not None:
                    step, state = r_step, r_state
                    self.events.append((step, "restored"))
                else:
                    self.events.append((step, "restart-from-scratch"))
                    step = start_step
        return state, history
