"""The port's data pipeline, fault-tolerance loop and train launcher.

The pipeline's batches equal the reference's bit for bit (both draw
them with numpy); the fault-tolerance cases mirror tests/test_runtime.py
on the port's copy; the launcher trains the smoke SmolLM on the CPU,
saves, resumes exactly, and writes checkpoints the reference reads.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import load_pytree as j_load_pytree
from repro.data import pipeline as jp
from repro.models.common import materialize as j_materialize
from repro.models.transformer import lm_build as j_lm_build
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.configs import get_smoke as j_get_smoke
from repro_torch.data.pipeline import (DataConfig, ShardedPipeline,
                                       synthetic_batch)
from repro_torch.launch.train import main as train_main
from repro_torch.runtime.fault import (FaultTolerantLoop, StragglerPolicy,
                                       elastic_replan)
from test_torch_train import _one_torch_thread  # noqa: F401


# ------------------------------------------------------------- pipeline
@pytest.mark.parametrize("cfg", [
    dict(vocab=100, seq_len=16, global_batch=8),
    dict(vocab=49_152, seq_len=64, global_batch=8, seed=7, structure=0.95),
    dict(vocab=97, seq_len=33, global_batch=12, structure=1.0)])
def test_batches_equal_the_reference_bit_for_bit(cfg):
    for step, shard, n in ((0, 0, 1), (5, 1, 2), (123, 3, 4)):
        if cfg["global_batch"] % n:
            continue
        got = synthetic_batch(DataConfig(**cfg), step, shard, n)
        want = jp.synthetic_batch(jp.DataConfig(**cfg), step, shard, n)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            assert np.array_equal(got[k], want[k])


def test_pipeline_stream_resume_and_resize_equal_the_reference():
    cfg = dict(vocab=64, seq_len=8, global_batch=4)
    mine, ref = ShardedPipeline(DataConfig(**cfg)), \
        jp.ShardedPipeline(jp.DataConfig(**cfg))
    for i in range(4):
        if i == 2:
            mine.resize(2, 1)
            ref.resize(2, 1)
        a, b = next(mine), next(ref)
        assert np.array_equal(a["tokens"], b["tokens"])
    assert mine.state_dict() == ref.state_dict()
    resumed = ShardedPipeline(DataConfig(**cfg))
    resumed.load_state_dict(ref.state_dict())
    assert np.array_equal(next(resumed)["labels"], next(ref)["labels"])


# ------------------------------------- tests/test_runtime.py, on the port
def make_loop(fault_source, ckpt_every=5, data=None):
    saved = {}
    state0 = {"sum": 0.0, "step": 0}

    def step_fn(state, batch):
        s = dict(state)
        s["sum"] += float(batch["tokens"].mean())
        s["step"] += 1
        return s, {"v": s["sum"]}

    def save_fn(step, state):
        saved["ckpt"] = (step, dict(state))

    def restore_fn():
        if "ckpt" in saved:
            return saved["ckpt"][0], dict(saved["ckpt"][1])
        return None, None

    data = data or ShardedPipeline(DataConfig(vocab=64, seq_len=8,
                                              global_batch=4))
    loop = FaultTolerantLoop(step_fn, save_fn, restore_fn, data,
                             ckpt_every=ckpt_every, fault_source=fault_source)
    return loop, state0


def test_run_without_faults():
    loop, s0 = make_loop(lambda s: None)
    state, hist = loop.run(s0, 10)
    assert state["step"] == 10
    assert len(hist) == 10


def test_crash_restores_from_checkpoint():
    crashed = []

    def fault(step):
        if step == 7 and not crashed:
            crashed.append(step)
            return "crash"
        return None

    loop, s0 = make_loop(fault, ckpt_every=5)
    state, hist = loop.run(s0, 10)
    assert (5, "restored") in loop.events
    assert state["step"] == 10  # completed despite the crash
    assert (7, "crash") in loop.events


def test_crash_exhausts_retries():
    loop, s0 = make_loop(lambda s: "crash" if s == 3 else None)
    with pytest.raises(RuntimeError):
        loop.run(s0, 10)


def test_straggler_skip_event():
    loop, s0 = make_loop(lambda s: "slow" if s == 8 else None)
    loop.straggler = StragglerPolicy(factor=3.0, min_samples=3)
    state, _ = loop.run(s0, 12)
    assert (8, "straggler-skip") in loop.events
    assert state["step"] == 12


def test_elastic_replan_divisibility():
    p = elastic_replan(global_batch=256, healthy_hosts=15, host_id=3)
    assert p.n_shards == 8 and 256 % p.n_shards == 0 and p.shard == 3
    assert elastic_replan(global_batch=256, healthy_hosts=16,
                          host_id=3).n_shards == 16


def test_elastic_resize_event():
    resizes = []
    loop, s0 = make_loop(lambda s: "resize:4" if s == 6 else None)
    loop.on_resize = lambda n: resizes.append(n)
    loop.run(s0, 10)
    assert resizes == [4]


def test_data_replay_after_restore_is_exact():
    dcfg = DataConfig(vocab=64, seq_len=8, global_batch=4)
    p1 = ShardedPipeline(dcfg)
    batches = [next(p1) for _ in range(6)]
    p2 = ShardedPipeline(dcfg)
    p2.load_state_dict({"step": 3, "shard": 0, "n_shards": 1})
    np.testing.assert_array_equal(batches[3]["tokens"], next(p2)["tokens"])


# --------------------------------------------------------------- launcher
ARGS = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
        "--global-batch", "4", "--seq-len", "16", "--log-every", "100"]


def test_launcher_saves_and_resumes_exactly(tmp_path, capsys):
    """8 steps with a checkpoint every 4; a second run from the step-4
    checkpoint alone repeats steps 5-8 bit for bit (params, optimizer
    state and the data cursor restored), and the reference reads the
    saved trees."""
    full = str(tmp_path / "full")
    losses = train_main(ARGS + ["--steps", "8", "--ckpt-dir", full,
                                "--ckpt-every", "4"])
    assert len(losses) == 8 and all(np.isfinite(losses))
    part = tmp_path / "part"
    part.mkdir()
    shutil.copytree(os.path.join(full, "step_00000004"),
                    part / "step_00000004")
    (part / "latest").write_text("4")
    resumed = train_main(ARGS + ["--steps", "8", "--ckpt-dir", str(part),
                                 "--ckpt-every", "4"])
    assert "[resume] restored step 4" in capsys.readouterr().out
    assert resumed == losses[4:]

    cfg = j_get_smoke("smollm-135m")
    params = j_materialize(j_lm_build(cfg), jax.random.PRNGKey(0))
    step8 = os.path.join(full, "step_00000008")
    j_params = j_load_pytree(params, os.path.join(step8, "params.proc0.npz"))
    j_opt = j_load_pytree(j_adamw_init(params),
                          os.path.join(step8, "opt.proc0.npz"))
    assert int(j_opt.step) == 8
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves((j_params, j_opt)))


def test_launcher_without_device_raises_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--arch", "smollm-135m", "--smoke", "--steps", "1"])
