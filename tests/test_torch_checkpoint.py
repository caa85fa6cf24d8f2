"""Checkpoints of the port (checkpoint/manager.py, checkpoint/quantized.py)
and the int8 ``{"q", "scale"}`` record (models/common.py): the manager's
contracts as the reference's tests/test_checkpoint.py states them, the
int8 codec as test_quantized_checkpoint.py does, and the ``.npz`` files
crossing between repro and repro_torch in both directions bit for bit
(plain, quantized and prepared trees).  ``quantize_params`` and the
record's ``dense`` equal the reference's bit for bit on equal inputs.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jm
from repro.checkpoint import quantized as jqc
from repro.configs import get_smoke as j_get_smoke
from repro.core import quant as jq
from repro.models import common as jc
from repro.models import transformer as jt
from repro.serve import engine as je
from repro_torch.checkpoint import (CheckpointManager, load_prepared,
                                    load_pytree, load_quantized,
                                    quantized_nbytes, save_prepared,
                                    save_pytree, save_quantized)
from repro_torch.checkpoint.manager import _leaves
from repro_torch.configs import get_smoke
from repro_torch.core import quant as tq
from repro_torch.core.quant import PlaneOperands, QuantizedWeights
from repro_torch.models import common as tc
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.models.transformer import lm_build, lm_forward
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve import engine as te

ARCH = "smollm-135m"


@pytest.fixture
def tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.int32)},
            "d": [torch.zeros((1,)), torch.full((2, 2), 7.0)]}


def _flat(tree):
    out = []
    for key, leaf in _leaves(tree):
        out.append((key, leaf.stack if isinstance(leaf, PlaneOperands)
                    else leaf))
    return out


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


# ------------------------------------------------------------- manager
def test_pytree_roundtrip(tmp_path, tree):
    p = str(tmp_path / "t.npz")
    save_pytree(tree, p)
    _assert_trees_equal(tree, load_pytree(tree, p, device="cpu"))


def test_manager_save_restore_latest(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    assert mgr.latest_step() is None
    mgr.save(10, {"params": tree}, extra={"note": "x"})
    mgr.save(20, {"params": tree})
    assert mgr.latest_step() == 20
    step, out = mgr.restore_latest({"params": tree}, device="cpu")
    assert step == 20
    _assert_trees_equal(tree, out["params"])
    assert mgr.manifest(10)["note"] == "x"


def test_manager_gc_keeps_k(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": tree})
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]


def test_no_tmp_dirs_after_save(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(5, {"params": tree})
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_async_save_then_wait(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(7, {"params": tree})
    tree["a"].add_(1)  # the host copy was taken at save(): no effect
    mgr.wait()
    assert mgr.latest_step() == 7
    _, out = mgr.restore_latest({"params": tree}, device="cpu")
    assert torch.equal(out["params"]["a"], tree["a"] - 1)


def test_async_write_error_surfaces_on_wait(tmp_path, tree, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_write=True)

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    mgr.save(3, {"params": tree})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None
    monkeypatch.undo()
    mgr.save(4, {"params": tree})  # the error was reported once
    mgr.wait()
    assert mgr.latest_step() == 4


def test_restore_shape_mismatch_raises(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"params": tree})
    bad = dict(tree, a=torch.zeros((5, 5)))
    with pytest.raises(AssertionError):
        mgr.restore(1, {"params": bad}, device="cpu")


# -------------------------------------------------- the reference's files
@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = j_get_smoke(ARCH), get_smoke(ARCH)
    jdesc = jt.lm_build(jcfg)
    jp = jc.materialize(jdesc, jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jdesc, jp, tcfg, lm_build(tcfg), tp


def _j_flat(tree):
    return [("/".join(str(p) for p in path), np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_port_equals_reference(got, ref):
    """A port tree against a reference tree, key for key, bit for bit:
    plane stacks compared in the reference's raw-digit layout."""
    fg = [(k, np.asarray((x.with_layout(False).stack if isinstance(
        x, PlaneOperands) else x).cpu())) for k, x in _leaves(got)]
    fr = _j_flat(ref)
    assert [k for k, _ in fg] == [k for k, _ in fr]
    for (k, g), (_, r) in zip(fg, fr):
        assert g.dtype == r.dtype and g.shape == r.shape, k
        np.testing.assert_array_equal(g, r, err_msg=k)


def test_plain_params_cross_both_ways(tmp_path, model):
    jcfg, jdesc, jp, tcfg, tdesc, tp = model
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jm.save_pytree(jp, jpath)
    save_pytree(tp, tpath)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _assert_trees_equal(load_pytree(tp, jpath, device="cpu"), tp)
    _assert_port_equals_reference(tp, jm.load_pytree(jp, tpath))


def test_quantize_params_matches_the_reference(model):
    """The eager /127 scales and the codes, bit for bit, and the structure
    of quantize_desc."""
    jcfg, jdesc, jp, tcfg, tdesc, tp = model
    got = tc.quantize_params(tdesc, tp)
    _assert_port_equals_reference(got, jc.quantize_params(jdesc, jp))
    qdesc = tc.quantize_desc(tdesc)
    assert qdesc["stack"][0]["mixer"]["wq"]["q"].dtype == torch.int8
    assert qdesc["stack"][0]["mixer"]["wq"]["scale"].shape == (6, 1, 1)
    assert [k for k, _ in _leaves(tc.tree_map(
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
        qdesc))] == [k for k, _ in _leaves(got)]


@pytest.mark.parametrize("shape", [(5, 96), (2, 3, 96)])
def test_record_dense_matches_the_reference(model, shape):
    jcfg, jdesc, jp, tcfg, tdesc, tp = model
    jrec = jc.quantize_params(jdesc, jp)["stack"][0]["ffn"]["wi"]
    jrec = {"q": jrec["q"][2], "scale": jrec["scale"][2]}  # layer 2
    trec = {k: torch.from_numpy(np.array(v)) for k, v in jrec.items()}
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jc.dense(jnp.asarray(x), jrec))
    got = tc.dense(torch.from_numpy(x), trec)
    assert got.shape == ref.shape == (*shape[:-1], 2, 256)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_quantized_checkpoint_smaller_and_bounded(tmp_path, model):
    jcfg, jdesc, jp, tcfg, tdesc, tp = model
    path = str(tmp_path / "q.npz")
    q = save_quantized(tdesc, tp, path)
    assert quantized_nbytes(q) < 0.45 * quantized_nbytes(tp)
    restored = load_quantized(tdesc, tp, path, dequantize=True,
                              device="cpu")
    checked = []

    def check(d, a, b):
        err = (a - b).abs().max().item()
        if tc._quantizable(d):
            assert err <= (a.abs().max().item() / 127.0 * 0.5 + 1e-6) \
                * 1.01, d.shape
        else:
            assert err == 0, d.shape  # norms and embeddings kept exactly
        checked.append(tc._quantizable(d))

    tc.tree_map(check, tdesc, tp, restored)
    assert any(checked) and not all(checked)


def test_serve_directly_from_quantized(tmp_path, model):
    jcfg, jdesc, jp, tcfg, tdesc, tp = model
    path = str(tmp_path / "q.npz")
    save_quantized(tdesc, tp, path)
    qp = load_quantized(tdesc, tp, path, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab, (2, 12)).astype(np.int32))
    h_f, _, _ = lm_forward(tcfg, tp, tokens=toks, mode="train")
    h_q, _, _ = lm_forward(tcfg, qp, tokens=toks, mode="train")
    assert ((h_f - h_q).abs().max() / h_f.abs().max()).item() < 0.35


def test_quantized_checkpoints_cross_both_ways(tmp_path, model):
    jcfg, jdesc, jp, tcfg, tdesc, tp = model
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jq_tree = jqc.save_quantized(jdesc, jp, jpath)
    tq_tree = save_quantized(tdesc, tp, tpath)
    _assert_port_equals_reference(load_quantized(tdesc, tp, jpath,
                                                 device="cpu"), jq_tree)
    _assert_port_equals_reference(tq_tree, jqc.load_quantized(jdesc, jp,
                                                              tpath))
    _assert_port_equals_reference(
        load_quantized(tdesc, tp, jpath, dequantize=True, device="cpu"),
        jqc.load_quantized(jdesc, jp, tpath, dequantize=True))


# ------------------------------------------------ prepared serving trees
@pytest.fixture(scope="module")
def prepared(model):
    jcfg, jdesc, jp, tcfg, tdesc, tp = model
    jcfg = dataclasses.replace(jcfg, l2r=jq.QuantConfig())
    tcfg = dataclasses.replace(tcfg, l2r=tq.QuantConfig())
    return (jcfg, je.prepare_params(jcfg, jp, jdesc), tcfg,
            te.prepare_params(tcfg, tp, tdesc))


def test_prepared_roundtrip_bit_exact(tmp_path, model, prepared):
    """Payloads, scales, plane stacks (values, layout and memory order)
    and the padded head cache round-trip leaf for leaf."""
    tp, tdesc = model[5], model[4]
    _, _, tcfg, tprep = prepared
    path = str(tmp_path / "prep.npz")
    save_prepared(tprep, path)
    restored = load_prepared(tcfg, tp, path, desc=tdesc, device="cpu")
    _assert_trees_equal(tprep, restored)
    for (k, a), (_, b) in zip(_leaves(tprep), _leaves(restored)):
        if isinstance(a, PlaneOperands):
            assert (a.shifted, a.axis, a.k, a.pad_planes) == \
                (b.shifted, b.axis, b.k, b.pad_planes), k
            assert a.stack.stride() == b.stack.stride(), k  # K-major
    assert isinstance(restored["head_q"], QuantizedWeights)
    assert restored["head_q"].planes.pad_planes == 3


def test_prepared_checkpoints_cross_both_ways(tmp_path, model, prepared):
    """The reference's prepared file loads into the port as the port's own
    prepared tree, and the port's file is the reference's."""
    jdesc, jp, tdesc, tp = model[1], model[2], model[4], model[5]
    jcfg, jprep, tcfg, tprep = prepared
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jqc.save_prepared(jprep, jpath)
    save_prepared(tprep, tpath)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _assert_trees_equal(load_prepared(tcfg, tp, jpath, desc=tdesc,
                                      device="cpu"), tprep)
    _assert_port_equals_reference(
        tprep, jqc.load_prepared(jcfg, jp, tpath, desc=jdesc))


def test_prepared_checkpoint_serves_identically(tmp_path, model, prepared):
    tdesc, tp = model[4], model[5]
    _, _, tcfg, tprep = prepared
    path = str(tmp_path / "prep.npz")
    save_prepared(tprep, path)
    restored = load_prepared(tcfg, tp, path, desc=tdesc, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, (n,)).astype(np.int32)
               for n in (5, 9)]

    def serve(tree):
        eng = ContinuousBatcher(tcfg, tree, n_slots=2, max_len=24,
                                progressive=True, early_exit=True,
                                device="cpu")
        reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=200)
        return [(r.output, r.exit_levels, r.prefill_exit_level)
                for r in reqs]

    assert serve(tprep) == serve(restored)


# ---------------------------------------------------------------- KV caches
@pytest.mark.parametrize("quant", [False, True])
def test_kv_cache_roundtrip_and_reference_keys(tmp_path, quant):
    """KVCache NamedTuples keep the reference's attribute keys; None
    fields write no key, so a cache without planes loads from a file of
    the three-field layout, and a plane-stacked one restores exactly."""
    from repro.models import attention as ja
    from repro_torch.models import attention as ta

    b, length, kv, dh, s = 2, 8, 2, 4, 3
    rng = np.random.default_rng(5)
    k_new = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    v_new = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    tquant = tq.QuantConfig() if quant else None
    jquant = jq.QuantConfig() if quant else None
    tcache = ta.update_kv_cache(
        ta.init_kv_cache(b, length, kv, dh, torch.float32, quant=tquant,
                         device="cpu"), torch.from_numpy(k_new),
        torch.from_numpy(v_new), torch.from_numpy(pos.copy()), quant=tquant)
    jcache = ja.update_kv_cache(
        ja.init_kv_cache(b, length, kv, dh, dtype=jnp.float32, quant=jquant),
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pos),
        quant=jquant)
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    save_pytree(tcache, tpath)
    jm.save_pytree(jcache, jpath)
    with np.load(jpath) as a, np.load(tpath) as c:
        assert sorted(a.files) == sorted(c.files)
        assert len(a.files) == (5 if quant else 3)
    restored = load_pytree(tcache, jpath, device="cpu")
    assert (restored.k_planes is None) == (not quant)
    _assert_trees_equal(tcache, restored)
