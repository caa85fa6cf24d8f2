"""The data-parallel train step and dp-local MoE on four gloo CPU ranks.

One ``spawn_local`` of 4 ranks serves the whole module: each rank builds
the meshes 1x4, 2x2 and 4x1 and returns numpy results; the parent
meanwhile makes the inputs, one architecture at a time (a rank starts on
each as soon as it is written), and then the oracles.  The reference's own sharded tests
fail on today's JAX (ROADMAP Queue C), so the oracles are one-process
runs: the port's unmeshed step (itself held to the reference's jitted
step by tests/test_torch_train_parity.py) and the reference's
single-device ``moe_apply_dp_local`` with ``_dp_groups`` patched here.

* ``make_train_step(mesh=)`` from the same params (crossed from JAX's
  ``materialize``; where split, the stacked weights rescaled to their
  width: models/common.py:fan_in_scaled), optimizer state and batch as the
  one-process step: the loss and the grad norm within 1e-6 relative,
  each leaf's gradient within 1e-5 of its norm (not the update: a first
  Adam step is about ``lr * sign(g)``, and an element whose gradient is
  near 0 may flip); the ZeRO-1 state gathered after the step equals a
  whole-leaf ``adamw_update`` (and ``ef_compress_grads``) of the same
  summed gradients and grad norm bit for bit; each rank's m / v bytes
  are its zero1_specs share.  The attention families train with the
  params split per ``param_specs`` (sharding/axes.py:shard_params) on a
  model axis over 1, the float products summed over the model group: on
  the reference's own init (each stacked weight's std from the layers
  axis, about 4x its width's here) a stack this random magnifies that
  reassociation past the bound
  (``test_split_sums_need_the_rescaled_weights``), so those cases, and
  their one-process steps, read the rescaled weights; the 4x1 mesh the
  reference's init.  Cases: smollm (dense; microbatch 2;
  EF; the sequence split over "model" between blocks, with remat: the
  backward recomputes each block inside the step's scopes), granite (kv
  heads split), qwen2-vl (q/k/v biases, M-RoPE positions), deepseek
  smoke with ``moe_dp_local`` off and on, whisper (encdec, whole on every
  rank).  With ``moe_dp_local``
  on, routing is per group of T/4 tokens; the case raises the capacity
  factor so that no group drops a token and the grouped step computes
  the one-process function (dropping is held bit for bit by the MoE
  cases below).  Whisper trains split as well (heads of the
  encoder, decoder and cross-attention; with the decoder's sequence split
  over "model" between blocks in ``whisper_seq``), and so do
  recurrentgemma (RG-LRU channels, its one kv head gathered) and mamba2
  (SSD heads), whose gradient is NaN in both packages (ROADMAP Caveats):
  its NaN elements are held equal to one process's and its finite ones
  to the bound, and the gathered update equal NaN for NaN.
* ``moe_apply_dp_local``: each rank's group output equals the unmeshed
  ``moe_apply`` on that group's tokens bit for bit (routing, capacity,
  shared experts and combine are per group), with whole rows and with
  the rows split over data, whole expert stacks and ``shard_experts``
  ones, without and with L2R; the gathered output equals the patched
  reference within test_torch_moe.py's MOE_REL, the aux loss within
  AUX_REL.
"""

import dataclasses
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.quant import QuantConfig
from repro_torch.launch.mesh import Mesh, make_local_mesh, spawn_local
from repro_torch.models.common import tree_leaves
from repro_torch.optim.adamw import AdamWConfig, OptState
from repro_torch.optim.compression import EFState
from repro_torch.sharding import collectives, ctx
from repro_torch.train.step import TrainConfig

WORLD = 4
MESHES = ((1, 4), (2, 2), (4, 1))
LR = 1e-3
TCFG = dict(remat=False, seq_shard=False, xent_chunk=8)
# (case, arch, config overrides, TrainConfig overrides)
CASES = (("smollm", "smollm-135m", {}, {}),
         ("smollm_mb2", "smollm-135m", {}, {"microbatch": 2}),
         ("smollm_ef", "smollm-135m", {}, {"ef_compression": True}),
         ("smollm_seq", "smollm-135m", {}, {"seq_shard": True,
                                            "remat": True}),
         ("granite", "granite-8b", {}, {}),
         ("qwen2vl", "qwen2-vl-7b", {}, {}),
         ("deepseek", "deepseek-moe-16b", {}, {}),
         ("deepseek_dp", "deepseek-moe-16b",
          {"moe_dp_local": True, "capacity_factor": 4.0}, {}),
         ("whisper", "whisper-base", {}, {}),
         ("whisper_seq", "whisper-base", {}, {"seq_shard": True,
                                              "remat": True}),
         ("rgemma", "recurrentgemma-2b", {}, {}),
         ("mamba2", "mamba2-130m", {}, {}))
ARCHS = tuple(dict.fromkeys(c[1] for c in CASES))  # in CASES order
MOE_REL, AUX_REL = 2e-6, 1e-6  # tests/test_torch_moe.py's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here as in the ranks (the suite's workers share
    a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(case):
    _, arch, over, tover = case
    return (dataclasses.replace(get_smoke(arch), **over),
            TrainConfig(**{**TCFG, **tover}))


def _batch(cfg, b=8, s=8, seed=1) -> dict:
    """numpy inputs as tests/test_torch_train.py:_batch makes them."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.rope_mode == "mrope":  # temporal / height / width streams
        batch["rope_positions"] = rng.integers(0, s, (3, b, s)).astype(
            np.int32)
    return batch


def _state(params, seed=5) -> OptState:
    """A reached optimizer state of numpy leaves (m ~ 1e-3, v = m^2 +
    1e-6, step 3), as tests/test_torch_train_parity.py:_ref_state."""
    rng = np.random.default_rng(seed)

    def walk(t, f):
        if isinstance(t, dict):
            return {k: walk(v, f) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f) for v in t]
        return f(t)

    m = walk(params, lambda x: (rng.standard_normal(np.shape(x))
                                * 1e-3).astype(np.float32))
    return OptState(step=np.int32(3), m=m,
                    v=walk(m, lambda x: np.square(x) + np.float32(1e-6)))


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np_tree(tree) -> list:
    return [x.detach().numpy().copy() for x in tree_leaves(tree)]


def _tp(cfg, mesh) -> bool:
    from repro_torch.sharding.axes import splits_anything

    return splits_anything(cfg, mesh)


def _params(inp: dict, name: str, cfg, scaled: bool):
    """The case's params crossed from JAX, with the stacked weights
    rescaled to their width where ``scaled`` (the split cases)."""
    from repro_torch.models.common import fan_in_scaled
    from repro_torch.models.convert import lm_params_from_jax

    params = lm_params_from_jax(inp["params", name], "cpu")
    return fan_in_scaled(cfg, params) if scaled else params


# ------------------------------------------------------------- the ranks
def _train_case(inp: dict, case, mesh) -> dict:
    """The mesh step of ``case`` from the crossed params and state: its
    loss, metrics and summed gradients, whether the gathered state after
    the step equals the whole-leaf update of those gradients (and grad
    norm), this rank's optimizer bytes, and the collectives of the loss's
    forward and backward alone."""
    from repro_torch.models.convert import (ef_state_from_jax,
                                            gather_ef_state,
                                            gather_opt_state,
                                            opt_state_from_jax)
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.optim.compression import ef_compress_grads
    from repro_torch.sharding.axes import gather_params, shard_params
    from repro_torch.train.step import (make_grad_fn, make_train_step,
                                        zero1_layout)

    cfg, tcfg = _cfg(case)
    name = case[0]
    tp = _tp(cfg, mesh)
    params = _params(inp, name, cfg, tp)
    if tp:
        params = shard_params(cfg, params, mesh)
    batch = _t(inp["batch", name])
    zero = zero1_layout(cfg, mesh)
    ocfg = AdamWConfig(lr=LR, warmup_steps=2)
    loss, metrics, grads = make_grad_fn(cfg, tcfg, mesh)(params, batch)
    opt = opt_state_from_jax(inp["state", name], "cpu", zero)
    step = make_train_step(cfg, ocfg, tcfg, mesh)
    collectives.reset()
    if tcfg.ef_compression:
        ef0 = ef_state_from_jax(inp["ef", name], "cpu")
        new_p, new_o, new_ef, m = step(params, opt, batch,
                                       ef_state_from_jax(inp["ef", name],
                                                         "cpu", zero))
    else:
        new_p, new_o, m = step(params, opt, batch)
    counts = dict(collectives.COUNTS)
    whole_o = gather_opt_state(new_o, zero)
    if tp:  # the whole tree from the ranks' slices
        grads, params, new_p = (gather_params(cfg, t, mesh)
                                for t in (grads, params, new_p))
    # the whole-leaf update of the same summed gradients, clipped by the
    # step's grad norm (a split leaf's squares are summed per rank first,
    # in another order than the whole leaf's)
    g = grads
    if tcfg.ef_compression:
        g, ref_ef = ef_compress_grads(grads, ef0)
        got_ef = gather_ef_state(new_ef, zero)
    norm = adamw.global_norm
    adamw.global_norm = lambda tree: m["grad_norm"] if tp else norm(tree)
    try:
        ref_p, ref_o, ref_m = adamw_update(
            ocfg, g, params, opt_state_from_jax(inp["state", name], "cpu"))
    finally:
        adamw.global_norm = norm
    exact = all(_equal(a, b) for a, b in zip(
        tree_leaves((new_p, whole_o.m, whole_o.v)),
        tree_leaves((ref_p, ref_o.m, ref_o.v))))
    exact &= _equal(m["grad_norm"], ref_m["grad_norm"])
    if tcfg.ef_compression:
        exact &= all(_equal(a, b) for a, b in zip(
            tree_leaves(got_ef.residual), tree_leaves(ref_ef.residual)))
    out = {"loss": float(loss), "grad_norm": float(m["grad_norm"]),
           "metrics": {k: float(v) for k, v in m.items()},
           "exact": exact, "step": int(new_o.step), "counts": counts,
           "tp": tp,
           "mv_bytes": sum(x.numel() * x.element_size()
                           for x in tree_leaves((new_o.m, new_o.v))),
           "params_sum": float(sum(float(x.double().sum())
                                   for x in tree_leaves(new_p)))}
    if mesh.rank == 0:
        out["grads"] = _np_tree(grads)
    return out


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, a NaN equal to a NaN (mamba2's NaN gradients)."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        a.nan_to_num(0.0, 0.0, 0.0), b.nan_to_num(0.0, 0.0, 0.0))


def _moe_case(inp: dict, mesh, l2r: bool) -> dict:
    """dp-local MoE under ``mesh``: the whole-rows and the split-rows
    calls, with whole and sharded expert stacks, each against the
    unmeshed ``moe_apply`` on this rank's group."""
    from repro_torch.models.convert import lm_params_from_jax
    from repro_torch.models.moe import moe_apply, shard_experts

    cfg = dataclasses.replace(get_smoke("deepseek-moe-16b"),
                              moe_dp_local=True,
                              l2r=QuantConfig() if l2r else None)
    params = lm_params_from_jax(inp["moe_params"], "cpu")
    x = torch.from_numpy(inp["moe_x"])
    b, s, d = x.shape
    g = mesh.index(("data", "model"))
    t_g = b * s // mesh.size
    x_g = x.reshape(b * s, d)[g * t_g:(g + 1) * t_g].reshape(1, t_g, d)
    oracle = moe_apply(cfg, params, x_g)[0].reshape(t_g, d)
    out = {"oracle_ok": [], "counts": []}
    sharded = shard_experts(cfg, params, mesh)
    out["expert_rows"] = sharded["wi"].shape[0]
    data_rows = b // mesh.shape["data"]
    r0 = mesh.index("data") * data_rows
    for p in (params, sharded):
        ctx.set_mesh(mesh)
        try:
            collectives.reset()
            y, aux = moe_apply(cfg, p, x)
            out["counts"].append(dict(collectives.COUNTS))
            with ctx.row_shard(mesh, "data"):
                y_l, aux_l = moe_apply(cfg, p, x[r0:r0 + data_rows])
        finally:
            ctx.set_mesh(None)
        got = y.reshape(b * s, d)[g * t_g:(g + 1) * t_g]
        out["oracle_ok"].append(bool(
            torch.equal(got, oracle)
            and torch.equal(y_l, y[r0:r0 + data_rows])
            and torch.equal(aux_l, aux)))
    out["y"], out["aux"] = y.numpy(), float(aux)
    return out


def _dump(path: str, name: str, obj) -> None:
    """Hand the ranks one part of the inputs: pickled to ``path.name``
    (written whole, then renamed)."""
    with open(f"{path}.{name}.tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(f"{path}.{name}.tmp", f"{path}.{name}")


def _load(path: str, name: str, timeout_s: float = 300.0) -> dict:
    """The part ``name`` of the parent's inputs (:func:`_dump`), once it
    is there; ``path.err`` says that the parent failed."""
    t_end = time.monotonic() + timeout_s
    while not os.path.exists(f"{path}.{name}"):
        if os.path.exists(path + ".err") or time.monotonic() > t_end:
            raise RuntimeError(f"no inputs at {path}.{name}")
        time.sleep(0.05)
    with open(f"{path}.{name}", "rb") as f:
        return pickle.load(f)


def _rank_main(path: str) -> dict:
    # the step's first torch.utils.checkpoint call imports torch._dynamo,
    # seconds a process: import it while the parent makes the inputs
    import torch._dynamo  # noqa: F401

    meshes = {shape: make_local_mesh(*shape) for shape in MESHES}
    out = {shape: {} for shape in MESHES}
    for arch in ARCHS:
        inp = _load(path, arch)
        for case in CASES:
            if case[1] == arch:
                for shape, mesh in meshes.items():
                    out[shape][case[0]] = _train_case(inp, case, mesh)
    inp = _load(path, "moe")
    for shape, mesh in meshes.items():
        out[shape]["moe"] = {l2r: _moe_case(inp, mesh, l2r)
                             for l2r in (False, True)}
    return out


# ------------------------------------------------------------ the parent
def _one_process(inp: dict) -> dict:
    """The port's unmeshed step of every case on the same inputs."""
    from repro_torch.models.convert import (ef_state_from_jax,
                                            opt_state_from_jax)
    from repro_torch.train.step import make_grad_fn, make_train_step

    out = {}
    for case in CASES:
        cfg, tcfg = _cfg(case)
        name = case[0]
        # the reference's init, and the rescaled weights of the split runs
        for scaled in (False, True):
            params = _params(inp, name, cfg, scaled)
            batch = _t(inp["batch", name])
            loss, _, grads = make_grad_fn(cfg, tcfg)(params, batch)
            step = make_train_step(cfg, AdamWConfig(lr=LR, warmup_steps=2),
                                   tcfg)
            opt = opt_state_from_jax(inp["state", name], "cpu")
            if tcfg.ef_compression:
                *_, m = step(params, opt, batch,
                             ef_state_from_jax(inp["ef", name], "cpu"))
            else:
                *_, m = step(params, opt, batch)
            out[name, scaled] = {"loss": float(loss),
                                 "grad_norm": float(m["grad_norm"]),
                                 "grads": _np_tree(grads)}
    return out


def _moe_reference(inp: dict) -> dict:
    """The reference's single-device ``moe_apply_dp_local`` with four
    dispatch groups (``_dp_groups`` patched, read while tracing), jitted,
    without and with L2R."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke as j_get_smoke
    from repro.core.quant import QuantConfig as JQuantConfig
    from repro.models import moe as jm

    real = jm._dp_groups
    jm._dp_groups = lambda t: WORLD
    try:
        out = {}
        for l2r in (False, True):
            jcfg = dataclasses.replace(j_get_smoke("deepseek-moe-16b"),
                                       moe_dp_local=True,
                                       l2r=JQuantConfig() if l2r else None)
            y, aux = jax.jit(lambda p, x: jm.moe_apply_dp_local(
                jcfg, p, x))({k: jnp.asarray(v) for k, v in
                              inp["moe_params"].items()},
                             jnp.asarray(inp["moe_x"]))
            out[l2r] = (np.asarray(y), float(aux))
    finally:
        jm._dp_groups = real
    return out


def _draw(desc, seed: int):
    """The reference's ``materialize(desc, PRNGKey(seed))`` as numpy,
    jitted with XLA's backend optimizations off: a third of the compile
    time, and the draw only has to be JAX's and the same for every run it
    feeds."""
    import jax

    from repro.models.common import materialize

    key = jax.random.PRNGKey(seed)
    fn = jax.jit(lambda k: materialize(desc, k)).lower(key).compile(
        {"xla_backend_optimization_level": 0})
    return jax.tree.map(np.asarray, fn(key))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, one-process results, reference MoE, inputs): the
    ranks start in a thread's spawn_local while this process makes the
    inputs (handed over in files, one an architecture) and then the
    oracles (the reference's MoE in a thread of its own)."""
    path = str(tmp_path_factory.mktemp("inputs") / "inputs.pkl")
    box = {}

    def ranks():
        try:
            box["out"] = spawn_local(WORLD, _rank_main, path, threads=1,
                                     deadline_s=600)
        except BaseException as e:  # re-raised below, on this thread
            box["err"] = e

    t = threading.Thread(target=ranks)
    t.start()
    # the one-process steps import torch._dynamo as the ranks do: here
    # beside jax's import and compiles
    warm = threading.Thread(target=lambda: __import__("torch._dynamo"))
    warm.start()
    try:
        from repro.configs import get_smoke as j_get_smoke
        from repro.models.encdec import encdec_build as j_encdec_build
        from repro.models.moe import moe_build as j_moe_build
        from repro.models.transformer import lm_build as j_lm_build

        inp = {}
        for n, arch in enumerate(ARCHS):  # one draw an architecture, jitted
            params, part = None, {}
            for i, case in enumerate(CASES):
                if case[1] != arch:
                    continue
                jcfg = dataclasses.replace(j_get_smoke(arch), **case[2])
                build = j_encdec_build if jcfg.family == "encdec" \
                    else j_lm_build
                if params is None:
                    params = _draw(build(jcfg), n)
                part["params", case[0]] = params
                part["batch", case[0]] = _batch(jcfg, seed=i + 1)
                part["state", case[0]] = _state(params, seed=i + 5)
                part["ef", case[0]] = EFState(
                    residual=_state(params, seed=i + 9).m)
            _dump(path, arch, part)
            inp.update(part)
        jcfg = j_get_smoke("deepseek-moe-16b")
        part = {"moe_params": _draw(j_moe_build(jcfg), 7),
            "moe_x": np.random.default_rng(3).standard_normal(
                (4, 32, jcfg.d_model)).astype(np.float32)}
        _dump(path, "moe", part)
        inp.update(part)
        moe_box = {}

        def moe():
            try:
                moe_box["ref"] = _moe_reference(inp)
            except BaseException as e:  # re-raised below
                moe_box["err"] = e

        moe_t = threading.Thread(target=moe)  # beside the one-process steps
        moe_t.start()
        try:
            warm.join()
            ref = _one_process(inp)
        finally:
            moe_t.join()
        if "err" in moe_box:
            raise moe_box["err"]
        moe_ref = moe_box["ref"]
    except BaseException:
        open(path + ".err", "w").close()  # the ranks stop waiting
        raise
    finally:
        t.join()
    if "err" in box:
        raise box["err"]
    return box["out"], ref, moe_ref, inp


def _leaf_close(got, want, rtol):
    """Within ``rtol`` of the leaf's norm; a NaN where and only where one
    process has one (mamba2), the finite elements so held."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    got, want = got[~nan], want[~nan]
    err = np.linalg.norm(got - want)
    assert err <= rtol * np.linalg.norm(want) + 1e-12, (err, rtol)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_mesh_step_matches_one_process(runs, shape, case):
    out, ref, _, _ = runs
    want = ref[case, out[0][shape][case]["tp"]]
    for rank in range(WORLD):
        got = out[rank][shape][case]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-6)
        assert got["step"] == 4
        # every rank returns the same global results
        for key in ("loss", "grad_norm", "metrics", "params_sum"):
            assert got[key] == out[0][shape][case][key], (rank, key)
    from repro_torch.sharding.axes import _desc, _paths

    grads = out[0][shape][case]["grads"]
    assert len(grads) == len(want["grads"])
    cfg, _ = _cfg(next(c for c in CASES if c[0] == case))
    paths = [p[0] for p in _paths(_desc(cfg, None))]
    whole = float(np.sqrt(sum(np.nansum(np.square(w))
                              for w in want["grads"])))
    heads_split = cfg.family == "encdec" and out[0][shape][case]["tp"]
    for path, g, w in zip(paths, grads, want["grads"]):
        if heads_split and path.endswith(".bk"):
            # whisper's key biases with its heads split: softmax does not
            # see a key bias, so its gradient is zero to rounding
            # (~1e-10), which the split rounds apart; zero to rounding in
            # both runs, each within 1e-5 of the whole gradient's norm
            assert np.linalg.norm(g) <= 1e-5 * whole, (path, whole)
            assert np.linalg.norm(w) <= 1e-5 * whole, (path, whole)
        else:
            _leaf_close(g, w, 1e-5)


def test_split_sums_need_the_rescaled_weights(runs):
    """Why the split cases read the width-rescaled weights: smollm's
    one-process gradients with every float product summing its
    contraction in two halves (the reassociation of a model split in
    two) against the plain ones, as each leaf's error over its norm
    (the worst is printed).  On the reference's own init the stack
    magnifies it past the 1e-5 the split cases are held to; on the
    rescaled weights it stays within."""
    from repro_torch.device import no_tf32
    from repro_torch.models import common
    from repro_torch.train.step import make_grad_fn

    _, ref, _, inp = runs
    cfg, tcfg = _cfg(CASES[0])

    def halves(x, w, _cfg):
        k = x.shape[-1] // 2
        with no_tf32():
            return x[..., :k] @ w[:k].to(x.dtype) \
                + x[..., k:] @ w[k:].to(x.dtype)

    worst = {}
    real = common.l2r_dense
    common.l2r_dense = halves
    try:
        for scaled in (False, True):
            params = _params(inp, "smollm", cfg, scaled)
            _, _, grads = make_grad_fn(cfg, tcfg)(
                params, _t(inp["batch", "smollm"]))
            worst[scaled] = max(
                float(np.linalg.norm(g - w) / np.linalg.norm(w))
                for g, w in zip(_np_tree(grads),
                                ref["smollm", scaled]["grads"]))
    finally:
        common.l2r_dense = real
    print(f"two-halves sums, worst leaf error / norm: reference init "
          f"{worst[False]:.3e}, rescaled {worst[True]:.3e}")
    assert worst[True] <= 1e-5 < worst[False], worst


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_zero1_state_is_the_whole_leaf_update(runs, shape, case):
    """The gathered params, m, v (and EF residual) after the mesh step
    equal a whole-leaf update of the same summed gradients bit for bit;
    each rank's m and v are its ZeRO-1 share: its zero1_specs share, of
    the rank's held block where the params are split (a leaf the layout
    keeps whole, the RG-LRU's gate weights, or holds head-aligned,
    Mamba-2's in_proj, by sharding/axes.py:held_layouts)."""
    from repro_torch.sharding.axes import _desc, zero1_spec
    from repro_torch.train.step import _tp, zero1_layout

    out, _, _, _ = runs
    cfg, _ = _cfg(next(c for c in CASES if c[0] == case))
    desc = tree_leaves(_desc(cfg, None))
    for rank in range(WORLD):
        mesh = Mesh({"data": shape[0], "model": shape[1]}, rank=rank)
        zero = zero1_layout(cfg, mesh) if _tp(cfg, mesh) else None
        share = 0
        for i, p in enumerate(desc):
            if zero is None:
                held, spec = p.shape, zero1_spec(p, mesh)
            else:
                held, spec = zero._held_shape(i), zero._sub(i)
            n = int(np.prod(held))
            for ax in spec:
                n //= ctx.mesh_axis_size(mesh, ax)
            share += 2 * 4 * n
        got = out[rank][shape][case]
        assert got["exact"], (rank, case)
        assert got["mv_bytes"] == share, (rank, got["mv_bytes"], share)


def _loss_collectives(cfg, tcfg, shape, tp: bool) -> dict:
    """The all-reduces and all-gathers of one forward and backward of
    the mesh loss, derived from the code's rules (the batch of
    :func:`_batch`: 8 x 8, one cross-entropy chunk a rank).  The metrics
    are summed over the data group (one all-reduce where it has ranks)
    and a dp-local MoE layer sums its aux's means over the mesh (one).
    Split over ``model`` (``tp``), per layer: ``copy_in`` at the input of
    each column-parallel region (attention, an MLP or shared MLP) sums
    its gradient; a row-parallel float ``wo`` sums its output (under
    sequence parallelism a reduce-scatter, whose gradient is gathered);
    attention on heads the model axis does not divide gathers q, k, v
    and gathers the gradient of the slice it keeps of the output;
    sequence parallelism gathers the normed input of the mixer and of
    the FFN; a dp-local MoE layer gathers its groups' outputs over the
    split axes and the gradient of its group's slice.  The vocab-split
    embedding gathers its lookups; sequence parallelism gathers the final
    hidden and the gradient of the rank's part of the embedded sequence.
    The vocab-parallel cross-entropy chunk: MAX of the row max, the sum
    of (exp-sum, gold), MIN of the argmax in the forward, the gradient
    of ``copy_in`` in the backward, and the recompute of its
    checkpoint, which stops at the last tensor saved for the backward
    (``log`` of the sum: the MAX and the sum again, not the MIN).  Under
    remat a block's recompute stops likewise, at the MLP's ``wo``
    product: every collective of the forward but the MLP's output sum."""
    data, m = shape
    ar = int(data > 1)
    ag = 0
    dp_local = bool(cfg.moe_dp_local and cfg.n_experts)
    if not tp:  # a dp-local layer splits its rows over the model group
        n_moe = sum(ffn == "moe" for _, ffn in cfg.layer_kinds())
        return {"all_reduce": ar + n_moe * dp_local,
                "all_gather": 2 * n_moe * dp_local * (m > 1)}
    seq = tcfg.seq_shard and 8 % m == 0
    gathered = cfg.n_kv % m != 0
    for mixer, ffn in cfg.layer_kinds():
        assert mixer == "global" and not (tcfg.remat and ffn != "mlp")
        fwd_ar, fwd_ag = 1, 3 * gathered + seq  # attention
        bwd_ar, bwd_ag = 1, gathered + seq
        if ffn == "mlp" or (ffn == "moe" and cfg.n_shared_experts):
            fwd_ar, fwd_ag = fwd_ar + 1, fwd_ag + seq
            bwd_ar, bwd_ag = bwd_ar + 1, bwd_ag + seq
        if ffn == "moe":
            assert dp_local and not seq
            fwd_ar, fwd_ag, bwd_ag = fwd_ar + 1, fwd_ag + 1, bwd_ag + 1
        ar, ag = ar + fwd_ar + bwd_ar, ag + fwd_ag + bwd_ag
        if tcfg.remat:
            ar, ag = ar + fwd_ar - 1, ag + fwd_ag
    ag += 1 + 2 * seq  # the embedding; the sequence split and gathered
    ar += 3 + 1 + 2  # the cross-entropy chunk
    return {"all_reduce": ar, "all_gather": ag}


@pytest.mark.parametrize("shape", MESHES)
def test_train_step_collectives(runs, shape):
    """The loss's forward and backward (:func:`_loss_collectives`), then
    one bucket a reduction: the gradient sum over the data group, over
    the model group too for the norms under sequence parallelism and
    over the mesh for the whole leaves of a dp-local MoE layer, the
    split leaves' squares for the grad norm, one gather of the updated
    params, plus the EF amax and the gather of the compressed
    gradients."""
    out, _, _, _ = runs
    data = shape[0]
    for case in ("smollm", "smollm_ef", "smollm_seq", "deepseek_dp"):
        cfg, tcfg = _cfg(next(c for c in CASES if c[0] == case))
        got = out[0][shape][case]
        tp = got["tp"]
        loss = _loss_collectives(cfg, tcfg, shape, tp)
        grad_sums = (data > 1) + (case == "deepseek_dp") \
            + (case == "smollm_seq" and tp)
        ef = case == "smollm_ef"
        want_reduce = loss["all_reduce"] + grad_sums + int(ef) + int(tp)
        assert got["counts"]["all_reduce"] == want_reduce, (case, got)
        assert got["counts"]["all_gather"] == \
            loss["all_gather"] + 1 + int(ef), (case, got)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("l2r", [False, True])
def test_dp_local_moe_matches_group_oracle(runs, shape, l2r):
    out, _, moe_ref, _ = runs
    want_y, want_aux = moe_ref[l2r]
    for rank in range(WORLD):
        got = out[rank][shape]["moe"][l2r]
        assert got["oracle_ok"] == [True, True], rank
        assert got["expert_rows"] == 8 // shape[1]
        # a2a there and back, the gather over the split axes, one sum
        a2a = 2 if shape[1] > 1 else 0
        assert got["counts"][0] == {"all_to_all": a2a, "all_gather": 1,
                                    "all_reduce": 1}, got["counts"]
        assert got["counts"][1] == got["counts"][0]
        np.testing.assert_array_equal(got["y"], out[0][shape]["moe"][l2r]
                                      ["y"])
        y = got["y"]
        err = np.abs(y - want_y).max() / np.abs(want_y).max()
        assert err <= MOE_REL, err
        np.testing.assert_allclose(got["aux"], want_aux, rtol=AUX_REL)
