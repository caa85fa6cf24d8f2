"""The consensus level walk on four gloo CPU ranks against the
single-device reference.

One ``spawn_local`` of 4 ranks serves the whole module: each rank builds
the meshes 1x4, 2x2 and 4x1 in turn, runs the sharded paths and returns
numpy results; the parent meanwhile computes the reference's
single-device results on the same inputs (tests/test_sharded_serving.py
:250 and :409, tests/test_policy.py:505 are the specs; the reference's
own sharded tests fail on today's JAX, so the oracle is its unmeshed
walk).  Every comparison is bit for bit:

* ``streaming_argmax(mesh=)``: two digit configs, both control flows,
  every ``levels`` truncation (power-of-two scales: equal logits are
  equal integer prefixes), the vocab-sharded cached stack, a mixed
  LevelPolicy, and a vocabulary no model axis divides (the fallback);
  the collectives counted against ``sharded_walk_collectives``;
* ``vgg16_classify_progressive(mesh=)`` (16 classes, 32x32, 2x2, early
  exit; the scan on the same head input): against the reference's walk
  on the head input the trunk made;
* the smoke SmolLM: the progressive head on fixed hidden states against
  the reference's; progressive prefill and decode, the batcher and the
  gateway against the port's unmeshed runs (the float backbone is the
  port's; tests/test_torch_serve_progressive.py holds it to the
  reference).

The parent also makes what every rank would otherwise make alike: the
VGG-16 params and the trunk's weight cache (fc6 alone is 25088 x 4096),
written once to a file each rank maps (fc8's cache is split on the rank,
by ``vgg16_quantize_weights(mesh=)``), and the port's unmeshed serving
runs.

Every rank returns the global results, and the ranks must agree.
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.policy import LevelPolicy, PrecisionClass
from repro_torch.core.progressive import (sharded_walk_collectives,
                                          streaming_argmax)
from repro_torch.core.quant import QuantConfig, quantize, quantize_weights
from repro_torch.launch.mesh import make_local_mesh, spawn_local
from repro_torch.models.protohead import prototype_head
from repro_torch.sharding import collectives, ctx

WORLD = 4
MESHES = ((1, 4), (2, 2), (4, 1))
CONFIGS = ((8, 2), (4, 2))
CLASSES = (PrecisionClass.exact(), PrecisionClass.budget(3),
           PrecisionClass.bounded(), PrecisionClass.budget(5),
           PrecisionClass.bounded(0.01))
ARCH = "smollm-135m"
N_LEVELS = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here as in the ranks (the suite's workers share
    a few cores; test_torch_train.py's fixture, which that module's
    imports would pull into every rank)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(out):
    return tuple(t.numpy() for t in out)


# ---------------------------------------------------------------- inputs
def _inputs() -> dict:
    """The seeded numpy operands every rank and the reference share."""
    rng = np.random.default_rng(0)
    m, k, n = 8, 48, 16
    inp = {"x": rng.standard_normal((m, k)).astype(np.float32),
           "w": (rng.standard_normal((k, n)) * 0.3).astype(np.float32),
           "bias": rng.standard_normal((n,)).astype(np.float32),
           "w9": (rng.standard_normal((k, 9)) * 0.3).astype(np.float32),
           "xq_int": rng.integers(-128, 128, (m, k), dtype=np.int8),
           "wq_int": rng.integers(-128, 128, (k, n), dtype=np.int8)}
    for bits, radix in CONFIGS:
        cfg = QuantConfig(n_bits=bits, log2_radix=radix)
        xq, xs = quantize(torch.from_numpy(inp["x"]), cfg, axis=0)
        wq = quantize_weights(torch.from_numpy(inp["w"]), cfg)
        inp[bits] = tuple(t.numpy() for t in (xq, wq.q, xs, wq.scale))
    wq9 = quantize_weights(torch.from_numpy(inp["w9"]), QuantConfig())
    inp["w9q"] = (wq9.q.numpy(), wq9.scale.numpy())
    xq, xs, w_q, _ = prototype_head(np.random.default_rng(3), 96, 16, 8,
                                    device="cpu")
    inp["proto"] = tuple(t.numpy() for t in (xq, w_q.q, xs, w_q.scale))
    inp["hidden"] = rng.standard_normal((8, 1, 96)).astype(np.float32)
    inp["prompt"] = rng.integers(0, 512, (4, 6)).astype(np.int32)
    inp["prompts"] = [rng.integers(0, 512, (n,)).astype(np.int32)
                      for n in (5, 7, 6)]
    inp["image"] = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    return inp


# ------------------------------------------------------------- the ranks
def _walk_cases(inp: dict, mesh) -> dict:
    """streaming_argmax under ``mesh``: the explicit argument and the
    installed mesh, with the collectives of each flow counted."""
    out = {}
    for bits, radix in CONFIGS:
        xq, wq, xs, ws = (torch.from_numpy(a) for a in inp[bits])
        bias = torch.from_numpy(inp["bias"])
        for ee in (False, True):
            kw = dict(n_bits=bits, log2_radix=radix, bias=bias,
                      early_exit=ee)
            collectives.reset()
            out["sweep", bits, ee] = _np(streaming_argmax(
                xq, wq, xs, ws, mesh=mesh, **kw))
            out["count", bits, ee] = dict(collectives.COUNTS)
            ctx.set_mesh(mesh)
            out["sweep_ctx", bits, ee] = _np(streaming_argmax(
                xq, wq, xs, ws, **kw))
            ctx.set_mesh(None)
    xq, wq = torch.from_numpy(inp["xq_int"]), torch.from_numpy(inp["wq_int"])
    xs = torch.full((8, 1), 2.0 ** -7)
    ws = torch.full((1, 16), 2.0 ** -6)
    for t in range(1, N_LEVELS + 1):
        out["prefix", t] = _np(streaming_argmax(xq, wq, xs, ws, levels=t,
                                                mesh=mesh))
    cfg = QuantConfig()
    cache = quantize_weights(torch.from_numpy(inp["w"]), cfg, prestack=True,
                             window_pad=True, plane_shifted=True,
                             k_major=True, shard=(None, "model"), mesh=mesh)
    out["cache_bytes"] = cache.planes.stack.numel()
    xq8, xs8 = (torch.from_numpy(inp[8][i]) for i in (0, 2))
    for ee in (False, True):
        out["cached", ee] = _np(streaming_argmax(
            xq8, cache.planes, xs8, cache.scale, early_exit=ee, mesh=mesh))
    pxq, pwq, pxs, pws = (torch.from_numpy(a) for a in inp["proto"])
    pol = LevelPolicy.from_classes([CLASSES[i % len(CLASSES)]
                                    for i in range(8)])
    for ee in (False, True):
        out["policy", ee] = _np(streaming_argmax(
            pxq, pwq, pxs, pws, policy=pol, early_exit=ee, mesh=mesh))
    w9q, w9s = (torch.from_numpy(a) for a in inp["w9q"])
    out["uneven"] = _np(streaming_argmax(xq8, w9q, xs8, w9s,
                                         early_exit=True, mesh=mesh))
    return out


def _vgg_build(path: str) -> None:
    """VGG-16's params (16 classes) and its trunk's weight cache, saved
    to ``path`` (written whole, then renamed; ``path + ".err"`` on a
    failure)."""
    from repro_torch.models import cnn

    try:
        params = cnn.vgg16_build(n_classes=16, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
        trunk = {k: v for k, v in params.items() if k != "fc8"}
        cache = cnn.vgg16_quantize_weights(trunk, QuantConfig())
        torch.save({"params": params, "cache": cache}, path + ".tmp")
        os.replace(path + ".tmp", path)
    except BaseException:
        open(path + ".err", "w").close()
        raise


def _vgg_load(path: str, timeout_s: float = 300.0) -> dict:
    t_end = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if os.path.exists(path + ".err") or time.monotonic() > t_end:
            raise RuntimeError(f"no VGG-16 weights at {path}")
        time.sleep(0.05)
    return torch.load(path, mmap=True, weights_only=False)


def _vgg_case(inp: dict, mesh) -> dict:
    """VGG-16 (16 classes, 32x32) classified under ``mesh`` with early
    exit, the head input its trunk made (captured at the walk), the scan
    on that input with the classifier's own walk arguments (the one thing
    ``early_exit`` changes; one trunk instead of two), and fc8's
    weights.  fc8's cache is split here; the rest comes from the
    parent's file."""
    from repro_torch.models import cnn

    saved = _vgg_load(inp["vgg_path"])
    params = saved["params"]
    cache = {**saved["cache"], **cnn.vgg16_quantize_weights(
        {"fc8": params["fc8"]}, QuantConfig(), mesh=mesh)}
    out = {"fc8": (params["fc8"]["w"].numpy(), params["fc8"]["b"].numpy()),
           "fc8_cols": cache["fc8"].q.shape[-1]}

    def walk(xq, wq, xs, ws, *args, **kw):
        out["head_input"] = (xq.numpy(), xs.numpy())
        logits, tok, lv = streaming_argmax(xq, wq, xs, ws, *args,
                                           **{**kw, "early_exit": False})
        out["classify", False] = _np((tok, lv, logits))
        return streaming_argmax(xq, wq, xs, ws, *args, **kw)

    real, cnn.streaming_argmax = cnn.streaming_argmax, walk
    try:
        out["classify", True] = _np(cnn.vgg16_classify_progressive(
            params, torch.from_numpy(inp["image"]), QuantConfig(), cache,
            early_exit=True, device="cpu", mesh=mesh))
    finally:
        cnn.streaming_argmax = real
    return out


def _lm_model(raw: dict):
    from repro_torch.models.convert import lm_params_from_jax

    cfg = dataclasses.replace(get_smoke(ARCH), l2r=QuantConfig())
    return cfg, lm_params_from_jax(raw, device="cpu")


def _lm_engine(cfg, inp: dict, prep, mesh) -> list:
    """Progressive prefill of the prompt and 3 decode steps (early
    exit) through the step factories."""
    from repro_torch.serve import engine as te

    step = dict(progressive=True, early_exit=True, mesh=mesh)
    prefill = te.make_prefill_step(cfg, 24, torch.float32, **step)
    decode = te.make_decode_step(cfg, **step)
    state, logits, tok, lv = prefill(prep, {"tokens": torch.from_numpy(
        inp["prompt"])})
    got = [(logits, tok, lv)]
    for _ in range(3):
        state, tok, logits, lv = decode(prep, state, tok)
        got.append((logits, tok, lv))
    return [_np(g) for g in got]


def _lm_serve(kind: str, cfg, inp: dict, prep, mesh):
    """The batcher's or the gateway's requests and stats."""
    from repro_torch.serve.batching import ContinuousBatcher, Request
    from repro_torch.serve.gateway import ServingGateway

    eng_kw = dict(n_slots=2, max_len=32, progressive=True,
                  early_exit=True, device="cpu", mesh=mesh)
    eng = ContinuousBatcher(cfg, prep, **eng_kw) if kind == "batcher" \
        else ServingGateway(cfg, prep, prefill_group=2, **eng_kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4, precision=CLASSES[i])
            for i, p in enumerate(inp["prompts"])]
    for r in reqs:
        eng.submit(r)
    eng.run()
    stats = eng.stats(latency=False)
    stats.pop("tokens_per_s", None)  # the host clock's
    if kind == "gateway":
        eng.close()
    return [(r.output, r.exit_levels, r.prefill_exit_level)
            for r in reqs], stats


def _lm_unmeshed(inp: dict, raw: dict) -> dict:
    """The port's unmeshed engine, batcher and gateway runs."""
    from repro_torch.serve import engine as te

    cfg, params = _lm_model(raw)
    whole = te.prepare_params(cfg, params)
    return {"engine": _lm_engine(cfg, inp, whole, None),
            **{kind: _lm_serve(kind, cfg, inp, whole, None)
               for kind in ("batcher", "gateway")}}


def _lm_cases(inp: dict, raw: dict, meshes) -> dict:
    """The smoke SmolLM under each mesh of ``meshes``: the progressive
    head on fixed hidden states, the engine, and (on 2x2) the batcher and
    the gateway."""
    from repro_torch.serve import engine as te

    cfg, params = _lm_model(raw)
    hidden = torch.from_numpy(inp["hidden"])
    pol = LevelPolicy.from_classes([CLASSES[i % len(CLASSES)]
                                    for i in range(8)])
    out = {}
    for shape, mesh in meshes:
        prep = te.prepare_params(cfg, params, mesh=mesh)
        out["head_cols", shape] = prep["head_q"].q.shape[-1]
        for ee in (False, True):
            out["head", shape, ee] = _np(te.progressive_logits_from_hidden(
                cfg, prep, hidden, early_exit=ee, mesh=mesh))
        out["head_policy", shape] = _np(te.progressive_logits_from_hidden(
            cfg, prep, hidden, early_exit=True, mesh=mesh, policy=pol))
        out["engine", shape] = _lm_engine(cfg, inp, prep, mesh)
        if shape == (2, 2):
            for kind in ("batcher", "gateway"):
                out[kind, shape] = _lm_serve(kind, cfg, inp, prep, mesh)
    return out


def _rank_main(inp: dict, raw: dict) -> dict:
    out = {}
    meshes = []
    for shape in MESHES:
        mesh = make_local_mesh(*shape)
        meshes.append((shape, mesh))
        out[shape] = _walk_cases(inp, mesh)
    out["vgg"] = _vgg_case(inp, dict(meshes)[(2, 2)])
    out["lm"] = _lm_cases(inp, raw, meshes)
    return out


# ------------------------------------------------------------ the parent
def _references(inp: dict, jp) -> dict:
    """The reference's single-device results on the same inputs."""
    import jax.numpy as jnp

    from repro.configs import get_smoke as j_get_smoke
    from repro.core import policy as jpol
    from repro.core.progressive import streaming_argmax as j_walk
    from repro.core.quant import QuantConfig as JQuantConfig
    from repro.serve import engine as je

    def walk(*args, **kw):
        return tuple(np.asarray(v) for v in j_walk(
            *(jnp.asarray(a) for a in args), **kw))

    ref = {}
    for bits, radix in CONFIGS:
        for ee in (False, True):
            ref["sweep", bits, ee] = walk(
                *inp[bits], n_bits=bits, log2_radix=radix,
                bias=jnp.asarray(inp["bias"]), early_exit=ee)
    xs2 = np.full((8, 1), 2.0 ** -7, np.float32)
    ws2 = np.full((1, 16), 2.0 ** -6, np.float32)
    for t in range(1, N_LEVELS + 1):
        ref["prefix", t] = walk(inp["xq_int"], inp["wq_int"], xs2, ws2,
                                levels=t)
    for ee in (False, True):
        ref["cached", ee] = walk(*inp[8], early_exit=ee)
    jp_pol = jpol.LevelPolicy.from_classes([
        jpol.PrecisionClass(c.kind, c.levels, c.tol)
        for c in (CLASSES[i % len(CLASSES)] for i in range(8))])
    for ee in (False, True):
        ref["policy", ee] = walk(*inp["proto"], policy=jp_pol,
                                 early_exit=ee)
    ref["uneven"] = walk(inp[8][0], inp["w9q"][0], inp[8][2], inp["w9q"][1],
                         early_exit=True)
    jcfg = dataclasses.replace(j_get_smoke(ARCH), l2r=JQuantConfig())
    jprep = je.prepare_params(jcfg, jp)
    hidden = jnp.asarray(inp["hidden"])
    for ee in (False, True):
        ref["head", ee] = tuple(np.asarray(v) for v in
                                je.progressive_logits_from_hidden(
                                    jcfg, jprep, hidden, early_exit=ee))
    ref["head_policy"] = tuple(np.asarray(v) for v in
                               je.progressive_logits_from_hidden(
                                   jcfg, jprep, hidden, early_exit=True,
                                   policy=jp_pol))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, references, inputs): the ranks run in a thread's
    spawn_local while this process computes the references, and another
    thread saves VGG-16 for the ranks, then runs the port's unmeshed
    serving (``references["port"]``)."""
    import jax

    from repro.configs import get_smoke as j_get_smoke
    from repro.core.quant import QuantConfig as JQuantConfig
    from repro.models.common import materialize
    from repro.models.transformer import lm_build as j_lm_build

    inp = _inputs()
    inp["vgg_path"] = str(tmp_path_factory.mktemp("vgg") / "vgg16.pt")
    jcfg = dataclasses.replace(j_get_smoke(ARCH), l2r=JQuantConfig())
    jp = materialize(j_lm_build(jcfg), jax.random.PRNGKey(0))
    raw = jax.tree.map(np.asarray, jp)
    box = {}

    def ranks():
        box["out"] = spawn_local(WORLD, _rank_main, inp, raw, threads=1,
                                 deadline_s=600)

    def port():
        _vgg_build(inp["vgg_path"])
        box["port"] = _lm_unmeshed(inp, raw)

    def run(fn):
        try:
            fn()
        except BaseException as e:  # re-raised below, on this thread
            box.setdefault("err", e)

    threads = [threading.Thread(target=run, args=(fn,))
               for fn in (ranks, port)]
    for t in threads:
        t.start()
    try:
        ref = _references(inp, jp)
    finally:
        for t in threads:
            t.join()
        for suffix in ("", ".tmp"):  # about a GB
            if os.path.exists(inp["vgg_path"] + suffix):
                os.remove(inp["vgg_path"] + suffix)
    if "err" in box:
        raise box["err"]
    ref["port"] = box["port"]
    return box["out"], ref, inp


def _eq(got, ref, msg):
    assert len(got) == len(ref) == 3, msg
    for g, r, what in zip(got, ref, ("logits", "tok", "exit_level")):
        np.testing.assert_array_equal(g, np.asarray(r),
                                      err_msg=f"{msg} {what}")


def test_every_rank_returns_the_global_results(runs):
    out, _, _ = runs
    first = out[0]
    for rank, res in enumerate(out[1:], 1):
        for shape in MESHES:
            for key, val in first[shape].items():
                if isinstance(val, tuple):
                    for a, b in zip(val, res[shape][key]):
                        np.testing.assert_array_equal(
                            a, b, err_msg=f"rank {rank} {shape} {key}")
        for ee in (False, True):
            _eq(res["vgg"]["classify", ee], first["vgg"]["classify", ee],
                f"rank {rank} vgg")


@pytest.mark.parametrize("shape", MESHES)
def test_walk_sweep_matches_reference(runs, shape):
    out, ref, _ = runs
    for bits, _ in CONFIGS:
        for ee in (False, True):
            for route in ("sweep", "sweep_ctx"):
                _eq(out[0][shape][route, bits, ee], ref["sweep", bits, ee],
                    f"{shape} {route} bits={bits} ee={ee}")


@pytest.mark.parametrize("shape", MESHES)
def test_walk_prefix_at_every_truncation(runs, shape):
    out, ref, _ = runs
    for t in range(1, N_LEVELS + 1):
        _eq(out[0][shape]["prefix", t], ref["prefix", t],
            f"{shape} levels={t}")


@pytest.mark.parametrize("shape", MESHES)
def test_walk_on_the_vocab_sharded_cache(runs, shape):
    out, ref, _ = runs
    for ee in (False, True):
        _eq(out[0][shape]["cached", ee], ref["cached", ee],
            f"{shape} cached ee={ee}")
    # the cache holds this rank's columns: (2D-1)*K x N / model bytes
    assert out[0][shape]["cache_bytes"] == 7 * 48 * 16 // shape[1]


@pytest.mark.parametrize("shape", MESHES)
def test_walk_mixed_policy(runs, shape):
    out, ref, _ = runs
    for ee in (False, True):
        _eq(out[0][shape]["policy", ee], ref["policy", ee],
            f"{shape} policy ee={ee}")
    # decisive margins: bounded rows exit early, exact rows never
    lv = ref["policy", True][2]
    assert lv[0] == N_LEVELS - 1 and (lv[2::5] < N_LEVELS - 1).all()


@pytest.mark.parametrize("shape", MESHES)
def test_walk_non_divisible_vocab_falls_back(runs, shape):
    out, ref, _ = runs
    _eq(out[0][shape]["uneven"], ref["uneven"], f"{shape} 9 columns")


@pytest.mark.parametrize("shape", MESHES)
def test_walk_collectives_are_exact(runs, shape):
    out, ref, _ = runs
    data, model = shape
    for bits, _ in CONFIGS:
        n_levels = 2 * (bits // 2) - 1
        for ee in (False, True):
            run = 1 + int(ref["sweep", bits, ee][2].max()) if ee \
                else n_levels
            want = sharded_walk_collectives(run, model > 1, data > 1, ee)
            assert out[0][shape]["count", bits, ee] == want, (bits, ee)


def test_vgg16_classify_progressive_sharded(runs):
    """fc8's 16 classes over the 2x2 mesh (8 a rank), the 2 images over
    its data axis: predictions, exit levels and logits equal the
    reference's walk on the head input and fc8 weights of the trunk."""
    import jax.numpy as jnp

    from repro.core.progressive import streaming_argmax as j_walk
    from repro.core.quant import QuantConfig as JQuantConfig
    from repro.core.quant import quantize_weights as j_qw

    out, _, _ = runs
    vgg = out[0]["vgg"]
    assert vgg["fc8_cols"] == 8
    w, b = vgg["fc8"]
    wq = j_qw(jnp.asarray(w), JQuantConfig())
    xq, xs = vgg["head_input"]
    for ee in (False, True):
        logits, pred, lv = j_walk(jnp.asarray(xq), wq.q, jnp.asarray(xs),
                                  wq.scale, bias=jnp.asarray(b),
                                  early_exit=ee)
        got_pred, got_lv, got_logits = vgg["classify", ee]
        _eq((got_logits, got_pred, got_lv), (logits, pred, lv),
            f"vgg ee={ee}")
    # the two flows commit the same classes at the same levels
    for a, b2 in zip(vgg["classify", False][:2], vgg["classify", True][:2]):
        np.testing.assert_array_equal(a, b2)


@pytest.mark.parametrize("shape", MESHES)
def test_lm_head_sharded_matches_reference(runs, shape):
    out, ref, _ = runs
    lm = out[0]["lm"]
    assert lm["head_cols", shape] == 512 // shape[1]
    for ee in (False, True):
        got = lm["head", shape, ee]
        _eq(tuple(g.reshape(r.shape) for g, r in zip(got, ref["head", ee])),
            ref["head", ee], f"{shape} head ee={ee}")
    _eq(lm["head_policy", shape], ref["head_policy"], f"{shape} policy")


@pytest.mark.parametrize("shape", MESHES)
def test_lm_prefill_and_decode_equal_the_unmeshed_engine(runs, shape):
    lm, port = runs[0][0]["lm"], runs[1]["port"]
    for step, (got, ref) in enumerate(zip(lm["engine", shape],
                                          port["engine"])):
        _eq(got, ref, f"{shape} step {step}")


@pytest.mark.parametrize("kind", ["batcher", "gateway"])
def test_serving_engines_equal_their_unmeshed_runs(runs, kind):
    lm, port = runs[0][0]["lm"], runs[1]["port"]
    reqs, stats = lm[kind, (2, 2)]
    ref_reqs, ref_stats = port[kind]
    assert reqs == ref_reqs and stats == ref_stats
    assert stats["tokens"] > 0 and all(len(r[0]) == 4 for r in reqs)
