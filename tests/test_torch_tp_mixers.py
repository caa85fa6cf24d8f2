"""The rest of the tensor-parallel mesh on four gloo CPU ranks: the SSD,
RG-LRU and whisper mixers over ``model`` and the head_dim KV-cache
layout.

One ``spawn_local`` of 4 ranks serves the module.  On the meshes 1x4 and
2x2 each rank cuts seeded params with ``sharding/axes.py:shard_params``
and serves through the step factories (``make_prefill_step`` /
``make_decode_step``, its rows over "data", the backbone over "model"):
the smoke mamba2 (SSD heads, head-aligned ``in_proj``), recurrentgemma
(RG-LRU channels; its one kv head in the head_dim layout), whisper (heads
of the encoder, the decoder and the cross-attention) and SmolLM (one kv
head: the head_dim layout, with and without digit-serial attention whose
decode walk stops early, and with a d_ff the model axis does not divide,
whose MLP runs whole); SmolLM and recurrentgemma also through
``ContinuousBatcher(state_sharding="specs")`` (progressive, early exit,
mixed precision classes for SmolLM).  The parent meanwhile runs the same
without a mesh: the oracle (the unmeshed runs are held to the reference
by tests/test_torch_{mixers,encdec,serve,lm_attn}.py).

Bit for bit on every rank: tokens, logits, exit levels and stats, and
each rank's states against the matching part of one process's
(serve/engine.py:local_state); the step factories' collectives a
forward are serve/engine.py:split_collectives'.  One-process checks of
the layouts (sharding/axes.py:held_layouts): ``shard_params`` then
``gather_params`` gives the tree back for every family, a rank's bytes,
and the rule for a model axis that does not divide a leaf (mamba2-smoke
at model 3 keeps every layer whole).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.policy import PrecisionClass
from repro_torch.core.quant import QuantConfig
from repro_torch.launch.mesh import Mesh, make_local_mesh, spawn_local
from repro_torch.sharding import collectives

WORLD = 4
MESHES = ((1, 4), (2, 2))
CLASSES = (PrecisionClass.exact(), PrecisionClass.budget(3),
           PrecisionClass.bounded(), PrecisionClass.bounded(0.01))
N_SLOTS, MAX_LEN = 4, 24
# (case, arch, config overrides)
STEPS = (("mamba2", "mamba2-130m", {}),
         ("rgemma", "recurrentgemma-2b", {}),
         ("whisper", "whisper-base", {}),
         ("smollm", "smollm-135m", {}),
         ("smollm_attn", "smollm-135m",
          dict(attn_l2r=QuantConfig(), attn_early_exit=True,
               attn_exit_tol=10.0)),
         ("smollm_whole_mlp", "smollm-135m", dict(d_ff=255)))
SERVE = (("smollm", "smollm-135m"), ("rgemma", "recurrentgemma-2b"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here as in the ranks (the suite's workers share
    a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch: str, **over):
    return dataclasses.replace(get_smoke(arch), l2r=QuantConfig(), **over)


def _params(cfg):
    from repro_torch.models.common import materialize
    from repro_torch.sharding.axes import _desc

    return materialize(_desc(cfg, None), torch.Generator().manual_seed(0),
                       device="cpu")


def _np(tensors) -> list:
    return [t.detach().numpy().copy() for t in tensors]


def _steps(arch: str, over: dict, mesh) -> dict:
    """A prefill of 4 x 8 tokens (whisper: and its frames) and 3 greedy
    steps through the step factories, raw params (the ssm, hybrid and
    encdec families serve them: ROADMAP Caveats) or prepared ones (the
    dense SmolLM); under ``mesh`` this rank's rows (over "data") and
    backbone slices (over "model").  Returns tokens, logits, the state's
    tensors, the collectives of each call and the done flags each call's
    digit-serial walks read (one a level walked and one at the stop, up
    to the stream's levels)."""
    import contextlib

    from repro_torch.core.progressive import msdf_levels
    from repro_torch.models.attention import attn_exit_tap
    from repro_torch.serve.batching import _tensors
    from repro_torch.serve.engine import (make_decode_step,
                                          make_prefill_step, prepare_params)
    from repro_torch.sharding import ctx
    from repro_torch.sharding.axes import batch_rows, shard_params

    cfg = _cfg(arch, **over)
    params = _params(cfg)
    if cfg.family == "dense":
        params = prepare_params(cfg, params, mesh=mesh)
    rng = np.random.default_rng(4)
    b, s = 4, 8
    tokens = torch.from_numpy(rng.integers(0, 512, (b, s)).astype(np.int32))
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    axes, r0, n = batch_rows(mesh, b)
    scope = ctx.row_shard(mesh, axes) if axes else contextlib.nullcontext()
    if mesh is not None:
        params = shard_params(cfg, params, mesh)
    prefill = make_prefill_step(cfg, s + 4, torch.float32, mesh=mesh)
    decode = make_decode_step(cfg, mesh=mesh)
    rows = slice(r0, r0 + n)
    n_levels = len(msdf_levels(cfg.attn_l2r.planes)[:cfg.attn_levels]) \
        if cfg.attn_l2r is not None else 0
    counts, flags = [], []
    with scope:
        collectives.reset()
        with collectives.recording() as records:
            state, logits = prefill(params, {k: v[rows]
                                             for k, v in batch.items()})
        counts.append(dict(collectives.COUNTS))
        flags.append(0)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out, all_logits = [tok], [logits]
        for _ in range(3):
            collectives.reset()
            with attn_exit_tap() as walks:
                state, tok, logits = decode(params, state, tok[rows])
            counts.append(dict(collectives.COUNTS))
            flags.append(sum(min(w["levels_run"] + 1, n_levels)
                             for w in walks))
            out.append(tok)
            all_logits.append(logits)
    res = {"tokens": torch.cat(out, 1).numpy(),
           "logits": torch.cat(all_logits, 1).numpy(),
           "state": _np(_tensors(state)), "counts": counts,
           "flags": flags,
           "prefill_records": [r.to_json() for r in records]}
    if mesh is not None:
        from repro_torch.serve.engine import split_collectives

        res["split"] = [split_collectives(cfg, params, m)
                        for m in ("prefill", "decode")]
    return res


def _serve(arch: str, mesh) -> dict:
    """The batcher (progressive with early exit for the prepared SmolLM,
    greedy on recurrentgemma's raw params) on 6 requests, unmeshed or in
    the ``"specs"`` layout; the requests, stats and the state."""
    from repro_torch.serve.batching import (ContinuousBatcher, Request,
                                            _tensors)
    from repro_torch.serve.engine import prepare_params
    from repro_torch.sharding.axes import shard_params

    cfg = _cfg(arch)
    dense = cfg.family == "dense"
    params = _params(cfg)
    if dense:
        params = prepare_params(cfg, params, mesh=mesh)
    if mesh is not None:
        params = shard_params(cfg, params, mesh)
    eng = ContinuousBatcher(
        cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN, progressive=dense,
        early_exit=dense, device="cpu", mesh=mesh,
        state_sharding="specs" if mesh is not None else "replicated")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, 512, (n,)).astype(
        np.int32), max_new_tokens=4 + i % 3,
        precision=CLASSES[i % len(CLASSES)] if dense else None)
        for i, n in enumerate((5, 7, 6, 9, 4, 8))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return {"reqs": [(r.output, r.exit_levels, r.prefill_exit_level)
                     for r in reqs],
            "stats": eng.stats(latency=False),
            "state": _np(_tensors(eng.state))}


def _rank_main() -> dict:
    out = {}
    for shape in MESHES:
        mesh = make_local_mesh(*shape)
        out[shape] = {name: _steps(arch, over, mesh)
                      for name, arch, over in STEPS}
        for name, arch in SERVE:
            out[shape]["serve_" + name] = _serve(arch, mesh)
    return out


@pytest.fixture(scope="module")
def runs():
    """(rank results, unmeshed results): the ranks run in spawn_local
    while this process serves without a mesh (a thread)."""
    import threading

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
        ref = {name: _steps(arch, over, None) for name, arch, over in STEPS}
        for name, arch in SERVE:
            ref["serve_" + name] = _serve(arch, None)
    finally:
        t.join()
    if "err" in box:
        raise box["err"]
    return box["out"], ref


def _held(case_cfg, shape, rank: int, whole: list) -> list:
    """Rank ``rank``'s part of one process's state tensors ``whole`` (in
    ``_tensors`` order) as the "specs" layout holds it."""
    from repro_torch.models.encdec import init_encdec_state
    from repro_torch.models.transformer import init_lm_state
    from repro_torch.serve.batching import _tensors
    from repro_torch.serve.engine import local_state

    cfg, batch, max_len = case_cfg
    mesh = Mesh({"data": shape[0], "model": shape[1]}, rank=rank,
                groups={("model",): None})
    init = init_encdec_state if cfg.family == "encdec" else init_lm_state
    template = init(cfg, batch, max_len, torch.float32, device="cpu")
    it = iter(torch.from_numpy(w) for w in whole)
    from repro_torch.serve.batching import _map

    state = _map(lambda _: next(it), template)
    return _np(_tensors(local_state(cfg, mesh, state)))


def _states_equal(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", [c[0] for c in STEPS])
def test_split_steps_as_the_unmeshed_steps(runs, shape, case):
    """Tokens and logits of the prefill and 3 steps bit for bit on every
    rank; each rank's state the matching part of one process's."""
    out, ref = runs
    want = ref[case]
    name, arch, over = next(c for c in STEPS if c[0] == case)
    cfg = _cfg(arch, **over)
    for rank in range(WORLD):
        got = out[rank][shape][case]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["logits"], want["logits"])
        _states_equal(got["state"], _held((cfg, 4, 12), shape, rank,
                                          want["state"]))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", [c[0] for c in STEPS])
def test_split_collectives_are_the_derived_ones(runs, shape, case):
    """Each call's collectives: split_collectives' for the backbone, plus
    the head's gather where its vocabulary is split (one-shot logits),
    the rows' gather of the logits over "data", and, with the
    digit-serial walk stopping early, its done flags (one MIN all-reduce
    a flag the walks read, counted from the levels each walk ran)."""
    out, _ = runs
    name, arch, over = next(c for c in STEPS if c[0] == case)
    cfg = _cfg(arch, **over)
    data, model = shape
    for rank in range(WORLD):
        got = out[rank][shape][case]
        for i, counts in enumerate(got["counts"]):
            want = dict(got["split"][min(i, 1)])
            # the one-shot head on a vocab-split table, the rows' logits
            want["all_gather"] += int(cfg.vocab % model == 0) \
                + int(data > 1)
            if cfg.attn_early_exit:
                assert got["flags"][i] > 0 or i == 0, (rank, i)
                want["all_reduce"] += got["flags"][i]
            else:
                assert got["flags"][i] == 0, (rank, i)
            assert counts == want, (rank, i, counts, want)


def _meta_prefill_records(arch: str, over: dict, shape, rank: int) -> list:
    """The collectives of ``_steps``' prefill on rank ``rank``, from the
    dry run's meta step (launch/dryrun.py:meta_step) under a mesh of
    shapes only: params, inputs and state on the meta device, no process
    group, the meta tensors on the CPU's paths as the ranks were."""
    from repro_torch.device import meta_target
    from repro_torch.launch.dryrun import meta_step
    from repro_torch.launch.mesh import make_shape_mesh
    from repro_torch.models.common import abstract
    from repro_torch.serve.engine import prepare_params
    from repro_torch.sharding.axes import _desc, shard_params

    cfg = _cfg(arch, **over)
    mesh = make_shape_mesh({"data": shape[0], "model": shape[1]}, rank)
    params = abstract(_desc(cfg, None))
    if cfg.family == "dense":
        params = prepare_params(cfg, params, mesh=mesh)
    params = shard_params(cfg, params, mesh)
    batch = {"tokens": torch.empty((4, 8), dtype=torch.int32,
                                   device="meta")}
    if cfg.family == "encdec":
        batch["frames"] = torch.empty((4, cfg.encoder_seq, cfg.d_model),
                                      device="meta")
    with meta_target("cpu"):  # the ranks ran on the CPU
        res = meta_step(cfg, mesh, "prefill", params, batch, 12,
                        cache_dtype=torch.float32, measure=False)
    return [r.to_json() for r in res["records"]]


@pytest.mark.parametrize("case", [c[0] for c in STEPS])
def test_meta_prefill_records_are_the_ranks(runs, case):
    """The dry run's meta prefill of each rank of the 2 x 2 mesh records
    the collectives that rank's real prefill issued, one for one: op,
    reduce op, dtype, bytes, group, group size, loop and tag."""
    out, _ = runs
    shape = (2, 2)
    name, arch, over = next(c for c in STEPS if c[0] == case)
    for rank in range(WORLD):
        got = _meta_prefill_records(arch, over, shape, rank)
        want = out[rank][shape][case]["prefill_records"]
        assert got == want, (rank, len(got), len(want))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", [c[0] for c in SERVE])
def test_specs_batcher_serves_as_the_unmeshed(runs, shape, case):
    out, ref = runs
    want = ref["serve_" + case]
    arch = dict(SERVE)[case]
    cfg = _cfg(arch)
    if cfg.family == "dense":
        assert any(lv < 6 for r in want["reqs"] for lv in r[1]), \
            "no token exits early"
    for rank in range(WORLD):
        got = out[rank][shape]["serve_" + case]
        assert got["reqs"] == want["reqs"], rank
        assert got["stats"] == want["stats"], rank
        _states_equal(got["state"], _held((cfg, N_SLOTS, MAX_LEN), shape,
                                          rank, want["state"]))


# ------------------------------------------------------------ one process
@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b",
                                  "whisper-base", "smollm-135m",
                                  "deepseek-moe-16b"])
@pytest.mark.parametrize("model", [2, 3, 4])
def test_shard_then_gather_gives_the_tree_back(arch, model):
    """Every rank's ``shard_params`` slices, gathered as ``gather_params``
    writes them (sharding/collectives.py:gather_slices' indexing, here
    without a process group), give the whole tree back; the ranks hold
    no more than the whole tree's bytes plus what the layout keeps on
    every rank."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.sharding.axes import held_layouts, shard_params
    from repro_torch.sharding.collectives import on_device

    cfg = get_smoke(arch)
    params = _params(cfg)
    whole = tree_leaves(params)
    rebuilt = [torch.full_like(w, float("nan")) for w in whole]
    total = 0
    for r in range(model):
        mesh = Mesh({"data": 1, "model": model}, rank=r)
        part = tree_leaves(shard_params(cfg, params, mesh))
        for got, lay, out in zip(part, held_layouts(cfg, mesh), rebuilt):
            out[on_device(lay.index(mesh.coords()), "cpu")] = got
            total += got.numel()
    for got, want in zip(rebuilt, whole):
        assert torch.equal(got, want)
    size = sum(w.numel() for w in whole)
    assert total <= size * model
    if model in (2, 4):
        assert total < size * model  # something is split


def test_a_rank_holds_its_share_of_the_bytes():
    """mamba2-smoke at model 2: the head-aligned in_proj holds its heads'
    z, x, dt and B, C whole (164 of 296 columns), the conv 96 of 160;
    recurrentgemma's gate weights stay whole; whisper's every split
    leaf a half."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.sharding.axes import _paths, _desc, shard_params

    mesh = Mesh({"data": 1, "model": 2}, rank=1)
    for arch in ("mamba2-130m", "recurrentgemma-2b", "whisper-base"):
        cfg = get_smoke(arch)
        params = _params(cfg)
        got = dict(zip((p[0] for p in _paths(_desc(cfg, None))),
                       (tuple(t.shape) for t in tree_leaves(
                           shard_params(cfg, params, mesh)))))
        if arch == "mamba2-130m":
            assert got["stack[0].mixer.in_proj"] == (4, 64, 164)
            assert got["stack[0].mixer.conv_w"] == (4, 4, 96)
            assert got["stack[0].mixer.out_proj"] == (4, 64, 64)
            assert got["stack[0].mixer.a_log"] == (4, 8)
        elif arch == "recurrentgemma-2b":
            assert got["stack[0].mixer.w_a"] == (1, 64, 64)
            assert got["stack[0].mixer.gate_proj"] == (1, 64, 32)
            assert got["stack[0].mixer.out_proj"] == (1, 32, 64)
        else:
            assert got["enc_stack.attn.wq"] == (2, 64, 32)
            assert got["dec_stack.cross.wo"] == (2, 32, 64)
            assert got["embed"] == (256, 64)


def test_an_undivided_axis_keeps_the_layers_whole():
    """mamba2-smoke at model 3 (3 divides none of its 8 heads, 296
    in_proj columns, 160 conv channels, 128 d_inner or 512 vocabulary):
    every leaf stays whole, ``whole_leaves`` names the mixer's and the
    embedding, nothing splits, and the "specs" layout then serves the
    whole params."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.serve.batching import check_state_sharding
    from repro_torch.sharding.axes import (params_split, shard_params,
                                           splits_anything, whole_leaves)

    cfg = get_smoke("mamba2-130m")
    mesh = Mesh({"data": 1, "model": 3}, rank=2)
    params = _params(cfg)
    cut = shard_params(cfg, params, mesh)
    assert all(a is b for a, b in zip(tree_leaves(cut),
                                      tree_leaves(params)))
    assert not splits_anything(cfg, mesh) and not params_split(cfg, cut)
    assert set(whole_leaves(cfg, mesh)) == {
        "embed", "stack[0].mixer.in_proj", "stack[0].mixer.conv_w",
        "stack[0].mixer.conv_b", "stack[0].mixer.norm",
        "stack[0].mixer.out_proj"}
    check_state_sharding(cfg, cut, mesh, "specs")
    # SmolLM-135M (full) at model 3 splits its 3 kv heads but not its
    # d_ff of 1536 ... which 3 divides: its MLP splits too
    assert whole_leaves(get_smoke("smollm-135m"), mesh) == [
        "embed", "stack[0].ffn.wi", "stack[0].ffn.wo", "stack[0].mixer.wk",
        "stack[0].mixer.wv"]
