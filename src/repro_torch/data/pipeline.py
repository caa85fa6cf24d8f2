"""Deterministic synthetic data pipeline, host-sharded and elastic.

The port of ``repro/data/pipeline.py``, a copy: batches are numpy, drawn
from ``np.random.SeedSequence``, equal to the reference's bit for bit.
``lm_spec_batch`` gives a batch's shapes as ``meta`` tensors.

A production run would wire a tokenized corpus here; the pipeline
substrate (deterministic sharding, packing, resumable cursor, elastic
re-sharding on DP resize) is the part that matters for the framework and
is fully implemented.  Each batch is drawn by a numpy generator seeded
from (seed, step, shard), so batch `i` is reproducible from the cursor
alone — restart and elastic resize replay exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

__all__ = ["DataConfig", "ShardedPipeline", "synthetic_batch",
           "lm_spec_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # structured synthetic stream: token t+1 = f(token t) with noise, so a
    # model can actually learn it (loss decreases in the e2e example).
    structure: float = 0.9  # probability of the deterministic successor


def synthetic_batch(cfg: DataConfig, step: int, shard: int, n_shards: int) -> dict:
    """Deterministic (step, shard) -> batch dict of numpy arrays."""
    assert cfg.global_batch % n_shards == 0, (cfg.global_batch, n_shards)
    local = cfg.global_batch // n_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]).generate_state(4)
    )
    base = rng.integers(0, cfg.vocab, size=(local, 1), dtype=np.int32)
    toks = [base[:, 0]]
    for _ in range(cfg.seq_len):
        nxt = (toks[-1] * 31 + 7) % cfg.vocab
        noise = rng.integers(0, cfg.vocab, size=(local,), dtype=np.int32)
        use_noise = rng.random(local) > cfg.structure
        toks.append(np.where(use_noise, noise, nxt).astype(np.int32))
    seq = np.stack(toks, 1)  # (local, seq_len + 1)
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


class ShardedPipeline:
    """Resumable, elastic iterator of host-local batches.

    ``resize(n_shards, shard)`` re-shards mid-stream (elastic scaling):
    determinism is per (step, shard) so the global stream stays coherent
    as long as global_batch stays divisible.
    """

    def __init__(self, cfg: DataConfig, shard: int = 0, n_shards: int = 1,
                 start_step: int = 0):
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.step = start_step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = synthetic_batch(self.cfg, self.step, self.shard, self.n_shards)
        self.step += 1
        return b

    def resize(self, n_shards: int, shard: int):
        self.n_shards = n_shards
        self.shard = shard

    def state_dict(self) -> dict:
        return {"step": self.step, "shard": self.shard, "n_shards": self.n_shards}

    def load_state_dict(self, d: dict):
        self.step = int(d["step"])
        self.shard = int(d["shard"])
        self.n_shards = int(d["n_shards"])



def lm_spec_batch(vocab: int, seq_len: int, global_batch: int) -> dict:
    """A token batch's inputs as empty ``meta`` tensors (shapes and
    dtypes for a dry run; nothing is allocated)."""
    del vocab
    return {k: torch.empty((global_batch, seq_len), dtype=torch.int32,
                           device="meta") for k in ("tokens", "labels")}
