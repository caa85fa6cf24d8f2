"""The ``"batch"`` slot-state layout on four gloo CPU ranks.

One ``spawn_local`` of 4 ranks serves the whole module: on the meshes
1x4, 2x2 and 4x1 each rank runs the smoke SmolLM (L2R, progressive,
early exit) through ``ContinuousBatcher(state_sharding="batch")`` over
the same requests, with 4 slots and, on 4x1, also with 8 (2 a rank).
The parent meanwhile runs the port's unmeshed batcher on the same
requests (the batcher itself is held to the reference by
tests/test_torch_batcher.py and tests/test_torch_sharded_walk.py).

Bit for bit against the unmeshed batcher: every request's tokens, exit
levels and prefill exit level, and the stats.  Each rank's state holds
``n_slots / data`` rows (all of them on 1x4), the same
``slot_req``-driven schedule runs on every rank, and the decode step
walks this rank's rows only (collectives counted per step).  The smoke
deepseek (MoE) runs the same way on 2x2: with the rows split, the MoE
keeps the global batch's capacity and slot order (an all-gather of
per-expert counts).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.policy import PrecisionClass
from repro_torch.core.quant import QuantConfig
from repro_torch.launch.mesh import make_local_mesh, spawn_local
from repro_torch.models.common import materialize
from repro_torch.sharding import collectives

WORLD = 4
MESHES = ((1, 4), (2, 2), (4, 1))
CLASSES = (PrecisionClass.exact(), PrecisionClass.budget(3),
           PrecisionClass.bounded(), PrecisionClass.bounded(0.01))
N_REQUESTS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here as in the ranks (the suite's workers share
    a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch: str):
    from repro_torch.models.transformer import lm_build
    from repro_torch.serve.engine import prepare_params

    cfg = dataclasses.replace(get_smoke(arch), l2r=QuantConfig())
    params = materialize(lm_build(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    return cfg, params, prepare_params


def _prompts() -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, (n,)).astype(np.int32)
            for n in (5, 7, 6, 9, 4, 8)[:N_REQUESTS]]


def _serve(arch: str, n_slots: int, mesh, sharding: str) -> dict:
    """The batcher's requests, stats and state rows under ``mesh``."""
    from repro_torch.serve.batching import ContinuousBatcher, Request

    cfg, params, prepare = _model(arch)
    prep = prepare(cfg, params, mesh=mesh)
    eng = ContinuousBatcher(cfg, prep, n_slots=n_slots, max_len=32,
                            progressive=True, early_exit=True, device="cpu",
                            mesh=mesh, state_sharding=sharding)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=5 + i % 3,
                    precision=CLASSES[i % len(CLASSES)])
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    collectives.reset()
    eng.run()
    return {"reqs": [(r.output, r.exit_levels, r.prefill_exit_level)
                     for r in reqs],
            "stats": eng.stats(latency=False),
            "rows": int(eng.state.pos.shape[0]),
            "counts": dict(collectives.COUNTS)}


def _rank_main() -> dict:
    out = {}
    for shape in MESHES:
        mesh = make_local_mesh(*shape)
        out[shape, 4] = _serve("smollm-135m", 4, mesh, "batch")
        if shape == (4, 1):
            out[shape, 8] = _serve("smollm-135m", 8, mesh, "batch")
        if shape == (2, 2):
            out["moe"] = _serve("deepseek-moe-16b", 4, mesh, "batch")
    return out


@pytest.fixture(scope="module")
def runs():
    """(rank results, unmeshed results): the ranks run in a thread's
    spawn_local while this process serves without a mesh."""
    box = {}

    def ranks():
        try:
            box["out"] = spawn_local(WORLD, _rank_main, threads=1,
                                     deadline_s=600)
        except BaseException as e:  # re-raised below, on this thread
            box["err"] = e

    t = threading.Thread(target=ranks)
    t.start()
    try:
        ref = {n: _serve("smollm-135m", n, None, "replicated")
               for n in (4, 8)}
        ref["moe"] = _serve("deepseek-moe-16b", 4, None, "replicated")
        # tests/conftest.py's per-test mesh reset imports the reference
        # package (and jax) after the first test: import it while the ranks
        # run, not after them
        import repro.sharding.ctx  # noqa: F401
    finally:
        t.join()
    if "err" in box:
        raise box["err"]
    return box["out"], ref


CELLS = [(s, 4) for s in MESHES] + [((4, 1), 8)]


@pytest.mark.parametrize("shape,n_slots", CELLS)
def test_batch_layout_serves_as_the_unmeshed_batcher(runs, shape, n_slots):
    out, ref = runs
    want = ref[n_slots]
    assert any(lv < 6 for r in want["reqs"] for lv in r[1]), \
        "no token exits early: the walk's sharded decision is not exercised"
    for rank in range(WORLD):
        got = out[rank][shape, n_slots]
        assert got["reqs"] == want["reqs"], rank
        assert got["stats"] == want["stats"], rank


@pytest.mark.parametrize("shape,n_slots", CELLS)
def test_each_rank_holds_its_rows(runs, shape, n_slots):
    out, _ = runs
    data = shape[0]
    for rank in range(WORLD):
        got = out[rank][shape, n_slots]
        assert got["rows"] == n_slots // data, (rank, got["rows"])
        counts = got["counts"]
        assert counts["all_to_all"] == 0
        if data == 1:  # whole rows: no gather over the data group
            assert counts["all_gather"] == got["stats"]["steps"] + \
                got["stats"]["prefills"], counts


def test_moe_batch_layout_serves_as_the_unmeshed_batcher(runs):
    out, ref = runs
    for rank in range(WORLD):
        got = out[rank]["moe"]
        assert got["rows"] == 2
        assert got["reqs"] == ref["moe"]["reqs"], rank
        assert got["stats"] == ref["moe"]["stats"], rank
