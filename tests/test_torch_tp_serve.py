"""The ``"specs"`` slot layout: serving the tensor-parallel backbone on
four gloo CPU ranks.

One ``spawn_local`` of 4 ranks serves the whole module.  Each rank
prepares the params (L2R at full depth), keeps its ``param_specs``
slices (sharding/axes.py:shard_params) and serves through
``ContinuousBatcher(state_sharding="specs")`` (progressive, early exit,
mixed precision classes): the smoke deepseek (4 kv heads, 8 experts) on
the meshes 1x4, 2x2 and 4x1, the smoke granite on 2x2; the smoke deepseek
also through ``ServingGateway(state_sharding="specs")`` on 1x4.  The smoke
qwen2-vl (q/k/v biases, M-RoPE) runs on 2x2 through the step factories
(``make_prefill_step`` / ``make_decode_step`` with (3, B, S) positions:
the batcher passes no M-RoPE positions, in the reference too), its rows
split over "data" and its kv heads over "model", and so does the smoke
granite with digit-serial attention whose decode walk stops early.  The parent meanwhile
runs the port's unmeshed batcher and steps on the same inputs, and the
reference's single-device ``ContinuousBatcher`` (jitted) on granite.

Bit for bit on every rank: tokens, exit levels, prefill exit levels and
stats against the unmeshed batcher (granite's also against the
reference's), qwen2-vl's tokens and logits against the unmeshed steps.
Each rank's KV caches hold its kv heads of its slots (the layout of
serve/engine.py:state_specs), its backbone its param_specs slices, and
the split backbone adds to the ``"batch"`` layout's collectives exactly
serve/engine.py:split_collectives a forward.
"""

import contextlib
import dataclasses
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.policy import PrecisionClass
from repro_torch.core.quant import QuantConfig
from repro_torch.launch.mesh import make_local_mesh, spawn_local
from repro_torch.sharding import collectives

WORLD = 4
MESHES = ((1, 4), (2, 2), (4, 1))
CLASSES = (PrecisionClass.exact(), PrecisionClass.budget(3),
           PrecisionClass.bounded(), PrecisionClass.bounded(0.01))
N_SLOTS, MAX_LEN = 4, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here as in the ranks (the suite's workers share
    a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# granite with digit-serial attention stopping its decode walk early (a
# loose tolerance: rows decide at different levels, so a rank that
# stopped on its own heads' or rows' decisions would round apart)
ATTN_EXIT = dict(attn_l2r=QuantConfig(), attn_early_exit=True,
                 attn_exit_tol=10.0)


def _cfg(arch: str, **over):
    return dataclasses.replace(get_smoke(arch), l2r=QuantConfig(), **over)


def _params(arch: str, inp: dict):
    """The arch's float params: the reference's draw for granite (handed
    over by the parent), a seeded torch draw otherwise."""
    from repro_torch.models.common import materialize
    from repro_torch.models.convert import lm_params_from_jax
    from repro_torch.models.transformer import lm_build

    if arch in inp:
        return lm_params_from_jax(inp[arch], "cpu")
    return materialize(lm_build(_cfg(arch)), torch.Generator().manual_seed(0),
                       device="cpu")


def _prompts() -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, (n,)).astype(np.int32)
            for n in (5, 7, 6, 9, 4, 8)]


def _requests(cls):
    return [cls(uid=i, prompt=p, max_new_tokens=5 + i % 3,
                precision=CLASSES[i % len(CLASSES)])
            for i, p in enumerate(_prompts())]


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _serve(arch: str, inp: dict, mesh, sharding: str,
           gateway: bool = False) -> dict:
    """The batcher's (or the gateway's) requests and stats under ``mesh``
    (None: unmeshed), with this rank's KV and backbone bytes and the
    collectives."""
    from repro_torch.models.attention import KVCache
    from repro_torch.serve.batching import (ContinuousBatcher, Request,
                                            _tensors)
    from repro_torch.serve.engine import prepare_params, split_collectives
    from repro_torch.serve.gateway import ServingGateway
    from repro_torch.sharding.axes import shard_params

    cfg = _cfg(arch)
    prep = prepare_params(cfg, _params(arch, inp), mesh=mesh)
    if sharding == "specs":
        prep = shard_params(cfg, prep, mesh)
    kw = dict(n_slots=N_SLOTS, max_len=MAX_LEN, progressive=True,
              early_exit=True, device="cpu", mesh=mesh,
              state_sharding=sharding)
    eng = ServingGateway(cfg, prep, prefill_group=2, **kw) if gateway \
        else ContinuousBatcher(cfg, prep, **kw)
    reqs = _requests(Request)
    for r in reqs:
        eng.submit(r)
    collectives.reset()
    eng.run()
    if gateway:
        eng.close()
    caches = [c for c in (*eng.state.prefix, *eng.state.stack,
                          *eng.state.suffix) if isinstance(c, KVCache)]
    stats = eng.stats(latency=False)
    stats.pop("tokens_per_s", None)  # the host clock's
    return {"reqs": [(r.output, r.exit_levels, r.prefill_exit_level)
                     for r in reqs],
            "stats": stats, "counts": dict(collectives.COUNTS),
            "kv_bytes": _bytes(t for c in caches for t in (c.k, c.v)),
            "kv_heads": caches[0].k.shape[-2],
            "rows": int(eng.state.pos.shape[0]),
            "backbone_bytes": _bytes(_tensors({k: v for k, v in prep.items()
                                               if k != "head_q"})),
            "forwards": stats["steps"] + stats["prefills"],
            "split": split_collectives(cfg, prep)}


def _steps(arch: str, mesh, **over) -> dict:
    """A prefill and 3 greedy steps through the step factories (qwen2-vl
    with M-RoPE positions); under ``mesh`` this rank's rows (over "data")
    and kv heads (over "model")."""
    from repro_torch.serve.engine import (make_decode_step,
                                          make_prefill_step, prepare_params)
    from repro_torch.sharding import ctx
    from repro_torch.sharding.axes import batch_rows, shard_params

    cfg = _cfg(arch, **over)
    prep = prepare_params(cfg, _params(arch, {}), mesh=mesh)
    rng = np.random.default_rng(4)
    b, s = 4, 8
    tokens = torch.from_numpy(rng.integers(0, 512, (b, s)).astype(np.int32))
    pos = torch.from_numpy(rng.integers(0, s, (3, b, s)).astype(np.int32)) \
        if cfg.rope_mode == "mrope" else None
    axes, r0, n = batch_rows(mesh, b)
    scope = ctx.row_shard(mesh, axes) if axes else contextlib.nullcontext()
    if mesh is not None:
        prep = shard_params(cfg, prep, mesh)
    prefill = make_prefill_step(cfg, s + 4, torch.float32, mesh=mesh)
    decode = make_decode_step(cfg, mesh=mesh)
    rows = slice(r0, r0 + n)
    with scope:
        batch = {"tokens": tokens[rows]}
        if pos is not None:
            batch["rope_positions"] = pos[:, rows]
        state, logits = prefill(prep, batch)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out, all_logits = [tok], [logits]
        for i in range(3):
            p = None if pos is None else \
                torch.full((3, n, 1), s + i, dtype=torch.int32)
            state, tok, logits = decode(prep, state, tok[rows], p)
            out.append(tok)
            all_logits.append(logits)
    return {"tokens": torch.cat(out, 1).numpy(),
            "logits": torch.cat(all_logits, 1).numpy(),
            "kv_heads": state.stack[0].k.shape[-2]}


def _rank_main(path: str) -> dict:
    out = {}
    for shape in MESHES:
        mesh = make_local_mesh(*shape)
        out[shape] = {s: _serve("deepseek-moe-16b", {}, mesh, s)
                      for s in ("specs", "batch")}
        if shape == (2, 2):  # granite's params: the parent's JAX draw
            out["granite"] = _serve("granite-8b", _load(path), mesh, "specs")
            out["vlm"] = _steps("qwen2-vl-7b", mesh)
            out["attn_exit"] = _steps("granite-8b", mesh, **ATTN_EXIT)
        if shape == (1, 4):  # the gateway's slots are not split by data
            out["gateway"] = _serve("deepseek-moe-16b", {}, mesh, "specs",
                                    gateway=True)
    return out


def _dump(path: str, obj) -> None:
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)


def _load(path: str, timeout_s: float = 300.0) -> dict:
    t_end = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if os.path.exists(path + ".err") or time.monotonic() > t_end:
            raise RuntimeError(f"no inputs at {path}")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def _reference_batcher(jparams) -> dict:
    """The reference's single-device batcher on granite, jitted."""
    import jax.numpy as jnp

    from repro.configs import get_smoke as j_get_smoke
    from repro.core.policy import PrecisionClass as JClass
    from repro.core.quant import QuantConfig as JQuantConfig
    from repro.serve import batching as jb
    from repro.serve.engine import prepare_params as j_prepare

    jcfg = dataclasses.replace(j_get_smoke("granite-8b"),
                               l2r=JQuantConfig())
    classes = {c.label(): c for c in (
        JClass.exact(), JClass.budget(3), JClass.bounded(),
        JClass.bounded(0.01))}
    prep = j_prepare(jcfg, {k: v for k, v in jparams.items()})
    prep = __import__("jax").tree.map(jnp.asarray, prep)
    eng = jb.ContinuousBatcher(jcfg, prep, n_slots=N_SLOTS, max_len=MAX_LEN,
                               cache_dtype=jnp.float32, progressive=True,
                               early_exit=True)
    reqs = [jb.Request(uid=i, prompt=p, max_new_tokens=5 + i % 3,
                       precision=classes[CLASSES[i % len(CLASSES)].label()])
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return {"reqs": [([int(t) for t in r.output],
                      [int(x) for x in r.exit_levels],
                      int(r.prefill_exit_level)) for r in reqs],
            "stats": eng.stats()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, unmeshed results, the reference's granite run): the
    ranks start in a thread's spawn_local and take the parent's granite
    draw when they reach granite; the parent then serves without a mesh
    and runs the reference's batcher."""
    path = str(tmp_path_factory.mktemp("tp") / "inputs.pkl")
    box = {}

    def ranks():
        try:
            box["out"] = spawn_local(WORLD, _rank_main, path, threads=1,
                                     deadline_s=600)
        except BaseException as e:  # re-raised below, on this thread
            box["err"] = e

    t = threading.Thread(target=ranks)
    t.start()
    try:
        import jax

        from repro.configs import get_smoke as j_get_smoke
        from repro.models.common import materialize
        from repro.models.transformer import lm_build as j_lm_build

        key = jax.random.PRNGKey(0)
        desc = j_lm_build(j_get_smoke("granite-8b"))
        jparams = jax.tree.map(np.asarray, jax.jit(
            lambda k: materialize(desc, k))(key))
        inp = {"granite-8b": jparams}
        _dump(path, inp)
        ref = {"deepseek": _serve("deepseek-moe-16b", inp, None,
                                  "replicated"),
               "gateway": _serve("deepseek-moe-16b", inp, None,
                                 "replicated", gateway=True),
               "granite": _serve("granite-8b", inp, None, "replicated"),
               "vlm": _steps("qwen2-vl-7b", None),
               "attn_exit": _steps("granite-8b", None, **ATTN_EXIT)}
        ref["jax_granite"] = _reference_batcher(jparams)
    except BaseException:
        open(path + ".err", "w").close()  # the ranks stop waiting
        raise
    finally:
        t.join()
    if "err" in box:
        raise box["err"]
    return box["out"], ref


@pytest.mark.parametrize("shape", MESHES)
def test_specs_layout_serves_as_the_unmeshed_batcher(runs, shape):
    out, ref = runs
    want = ref["deepseek"]
    assert any(lv < 6 for r in want["reqs"] for lv in r[1]), \
        "no token exits early: the walk's sharded decision is not exercised"
    for rank in range(WORLD):
        got = out[rank][shape]["specs"]
        assert got["reqs"] == want["reqs"], rank
        assert got["stats"] == want["stats"], rank


@pytest.mark.parametrize("shape", MESHES)
def test_each_rank_holds_its_heads_and_its_slices(runs, shape):
    """KV bytes a (data x model) share of the unmeshed state's, the kv
    heads 4 / model, the backbone's bytes below the whole's by the
    split."""
    out, ref = runs
    data, model = shape
    whole = ref["deepseek"]
    for rank in range(WORLD):
        got = out[rank][shape]["specs"]
        assert got["rows"] == N_SLOTS // data
        assert got["kv_heads"] == 4 // model
        assert got["kv_bytes"] * data * model == whole["kv_bytes"]
        if model > 1:
            assert got["backbone_bytes"] < whole["backbone_bytes"]
        else:
            assert got["backbone_bytes"] == whole["backbone_bytes"]


@pytest.mark.parametrize("shape", MESHES)
def test_split_collectives_are_the_derived_ones(runs, shape):
    """The "specs" run's collectives are the "batch" run's (the head walk,
    the rows' split) plus split_collectives a forward."""
    out, _ = runs
    for rank in range(WORLD):
        specs, batch = out[rank][shape]["specs"], out[rank][shape]["batch"]
        assert specs["reqs"] == batch["reqs"]
        extra = specs["split"] if shape[1] > 1 else \
            {k: 0 for k in specs["split"]}
        for k in specs["counts"]:
            assert specs["counts"][k] == batch["counts"][k] + \
                specs["forwards"] * extra[k], (rank, k, specs["counts"],
                                               batch["counts"])


def test_specs_gateway_serves_as_the_unmeshed_gateway(runs):
    out, ref = runs
    for rank in range(WORLD):
        got = out[rank]["gateway"]
        assert got["kv_heads"] == 1
        assert got["reqs"] == ref["gateway"]["reqs"], rank
        assert got["stats"] == ref["gateway"]["stats"], rank


def test_granite_specs_serves_as_the_unmeshed_and_the_reference(runs):
    out, ref = runs
    for rank in range(WORLD):
        got = out[rank]["granite"]
        assert got["kv_heads"] == 1
        assert got["reqs"] == ref["granite"]["reqs"], rank
        assert got["stats"] == ref["granite"]["stats"], rank
    jax_run = ref["jax_granite"]
    assert ref["granite"]["reqs"] == jax_run["reqs"]
    assert _plain(ref["granite"]["stats"]) == _plain(jax_run["stats"])


def _plain(x):
    """Stats as plain Python values (the reference's hold numpy arrays
    and scalars)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, np.ndarray)):
        return [_plain(v) for v in x]
    return x.item() if isinstance(x, np.generic) else x


@pytest.mark.parametrize("case", ["vlm", "attn_exit"])
def test_split_steps_as_the_unmeshed_steps(runs, case):
    """qwen2-vl's M-RoPE steps, and granite's with the digit-serial
    attention walk stopping early (every rank stops where one process
    stops: the done flag is reduced over the rows' and heads' split)."""
    out, ref = runs
    for rank in range(WORLD):
        got = out[rank][case]
        assert got["kv_heads"] == 1
        np.testing.assert_array_equal(got["tokens"], ref[case]["tokens"])
        np.testing.assert_array_equal(got["logits"], ref[case]["logits"])
