"""The port's training: ``chunked_xent`` against the reference, the
port's step on all ten architectures, remat, microbatching, EF
compression, descent over 30 steps, and the gradients of kernels B5 and
B4 (fault C2) on their routes, run here on their plain versions.  One
step of five families against the reference's is
tests/test_torch_train_parity.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QuantConfig as JQuantConfig
from repro.models.attention import chunked_attention as j_chunked_attention
from repro.train.step import chunked_xent as j_chunked_xent
from repro_torch.configs import ARCHS, get_smoke
from repro_torch.core.quant import QuantConfig
from repro_torch.data.pipeline import DataConfig, ShardedPipeline
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as ta
from repro_torch.models.common import materialize
from repro_torch.models.encdec import encdec_build
from repro_torch.models.transformer import lm_build
from repro_torch.models.common import tree_leaves
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.compression import ef_init
from repro_torch.train import step as ts
from repro_torch.train.step import (TrainConfig, chunked_xent,
                                    make_loss_fn, make_train_step)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small ops: the suite
    runs several worker processes on a few cores, where torch's default
    pool (a thread per core in every worker) oversubscribes them and
    these tests slow down by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LR = 1e-3
TCFG = dict(remat=False, seq_shard=False, xent_chunk=8)


def _batch(cfg, b=2, s=16, seed=1) -> dict:
    """numpy inputs of tests/test_models_smoke.py:_batch."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    elif cfg.embeds_input:
        batch["embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
        if cfg.rope_mode == "mrope":
            pos = np.tile(np.arange(s), (b, 1))
            batch["rope_positions"] = np.stack([pos, pos * 0, pos * 0]) \
                .astype(np.int32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return batch


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_params(cfg, seed=0):
    build = encdec_build if cfg.family == "encdec" else lm_build
    return materialize(build(cfg), torch.Generator().manual_seed(seed),
                       device="cpu")


def _grads(cfg, params, batch, **tcfg):
    _, metrics, grads = ts.value_and_grad(
        make_loss_fn(cfg, TrainConfig(**{**TCFG, **tcfg})), params,
        _t(batch))
    return metrics, grads


# ----------------------------------------------------------- chunked_xent
@pytest.mark.parametrize("chunk,z_loss", [(8, 0.0), (8, 1e-4), (32, 1e-4)])
def test_chunked_xent_value_and_grad_match_reference(chunk, z_loss):
    rng = np.random.default_rng(0)
    b, s, d, v = 2, 32, 16, 50
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)
    w[:, 7] = w[:, 3]  # tied logits: argmax takes the first index
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, :8] = 7
    h_t = torch.from_numpy(hidden).requires_grad_(True)
    w_t = torch.from_numpy(w).requires_grad_(True)
    loss, acc = chunked_xent(h_t, w_t, torch.from_numpy(labels), chunk,
                             z_loss)
    loss.backward()
    f = jax.jit(jax.value_and_grad(
        lambda h, w: j_chunked_xent(h, w, jnp.asarray(labels), chunk,
                                    z_loss), argnums=(0, 1), has_aux=True))
    (j_loss, j_acc), (j_gh, j_gw) = f(jnp.asarray(hidden), jnp.asarray(w))
    assert loss.dtype == acc.dtype == torch.float32
    assert float(acc) == float(j_acc)  # the same argmax, ties included
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(h_t.grad.numpy(), np.asarray(j_gh),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(j_gw),
                               rtol=1e-5, atol=1e-8)


def test_chunked_xent_keeps_the_chunk_assert():
    with pytest.raises(AssertionError):
        chunked_xent(torch.zeros(1, 12, 4), torch.zeros(4, 5),
                     torch.zeros(1, 12, dtype=torch.int32), chunk=8)


# ---------------------------------------------------------- port alone
@pytest.mark.parametrize("arch", ARCHS)
def test_port_train_step_every_arch(arch):
    """tests/test_models_smoke.py::test_smoke_train_step on the port."""
    cfg = get_smoke(arch)
    params = _port_params(cfg)
    opt = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(lr=LR, warmup_steps=1),
                           TrainConfig(remat=False, seq_shard=False,
                                       xent_chunk=16))
    params2, opt2, metrics = step(params, opt, _t(_batch(cfg)))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["loss"]) > 0
    assert int(opt2.step) == 1
    assert any(not torch.allclose(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(params2)))


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b",
                                  "recurrentgemma-2b", "whisper-base"])
def test_remat_equals_no_remat(arch):
    """Checkpointed blocks recompute the same ops: loss, MoE aux and
    every gradient equal bit for bit."""
    cfg = get_smoke(arch)
    params, batch = _port_params(cfg), _batch(cfg)
    m1, g1 = _grads(cfg, params, batch, remat=False)
    m2, g2 = _grads(cfg, params, batch, remat=True)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        assert torch.equal(a, b)


def _run(cfg, params, dcfg, tcfg, n_steps, ef=False):
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=n_steps,
                       weight_decay=0.0)
    step = make_train_step(cfg, ocfg, tcfg)
    opt, efs = adamw_init(params), (ef_init(params) if ef else None)
    pipe, losses = ShardedPipeline(dcfg), []
    for _ in range(n_steps):
        batch = _t(next(pipe))
        if ef:
            params, opt, efs, m = step(params, opt, batch, efs)
        else:
            params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    return losses, params


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke("smollm-135m"), vocab=128)
    dcfg = DataConfig(vocab=128, seq_len=32, global_batch=8, structure=0.95)
    return cfg, _port_params(cfg), dcfg


def test_microbatch_accumulation_close(setup):
    """Four microbatches against the whole batch (the reference's spec:
    the first loss within 1e-3), and the accumulated step's params."""
    cfg, params, dcfg = setup
    tc = dict(remat=False, seq_shard=False, xent_chunk=32)
    l1, p1 = _run(cfg, params, dcfg, TrainConfig(**tc), 3)
    l4, p4 = _run(cfg, params, dcfg, TrainConfig(**tc, microbatch=4), 3)
    np.testing.assert_allclose(l1[0], l4[0], rtol=1e-6)
    np.testing.assert_allclose(l1, l4, rtol=1e-3)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


def test_loss_decreases(setup):
    cfg, params, dcfg = setup
    losses, _ = _run(cfg, params, dcfg, TrainConfig(
        remat=False, seq_shard=False, xent_chunk=32), 30)
    # 30 steps on the structured stream: clear descent from ln(128)=4.85
    assert losses[-1] < losses[0] - 0.4, losses[::5]


def test_ef_compression_still_converges(setup):
    cfg, params, dcfg = setup
    losses, _ = _run(cfg, params, dcfg, TrainConfig(
        remat=True, seq_shard=False, xent_chunk=32, ef_compression=True),
        30, ef=True)
    assert losses[-1] < losses[0] - 0.35, losses[::5]


def test_mesh_raises_naming_its_slice():
    """``make_train_step(mesh=)`` checks its mesh: it needs a data axis
    and ranks on a process group (the data-parallel step itself runs on
    spawned ranks in test_torch_sharded_train.py)."""
    from repro_torch.launch.mesh import Mesh, make_production_mesh

    cfg = get_smoke("smollm-135m")
    with pytest.raises(ValueError, match="'data' axis"):
        make_train_step(cfg, AdamWConfig(), mesh=object())
    with pytest.raises(ValueError, match="'data' axis"):
        make_train_step(cfg, AdamWConfig(), mesh=Mesh({"model": 2}, rank=0))
    with pytest.raises(ValueError, match="shapes only"):
        make_train_step(cfg, AdamWConfig(), mesh=make_production_mesh())


# ------------------------------------------------ C2: B5 and B4 gradients
def _fit_everything(monkeypatch):
    """Kernel routes on CPU tensors: the *_fits checks hold and each
    launch is its kernel's plain version, counted."""
    calls = {"B5": 0, "B4": 0}

    def b5(*a, **kw):
        calls["B5"] += 1
        return fa_kernel.flash_attention_kernel_plain(*a, **kw)

    def b4(*a, **kw):
        calls["B4"] += 1
        return fa_kernel.flash_attention_l2r_plain(*a, **kw)

    monkeypatch.setattr(ta, "b5_fits", lambda *a: True)
    monkeypatch.setattr(ta, "b4_fits", lambda *a: True)
    monkeypatch.setattr(fa_ops, "flash_attention_kernel", b5)
    monkeypatch.setattr(fa_kernel, "flash_attention_l2r", b4)
    return calls


def _qkv(shape_q, shape_kv, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype).requires_grad_(True)
            for s in (shape_q, shape_kv, shape_kv)]


def _plain_grads(q, k, v, w, **kw):
    qs, ks, vs = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = ta._chunked_plain(qs, ks, vs, kw.get("causal", True),
                            kw.get("window"), kw.get("scale"), None, None,
                            None, 0, torch.float32, kw.get("l2r"), None)
    return torch.autograd.grad((out.float() * w).sum(), (qs, ks, vs))


CASES = [  # (q shape, kv shape, kwargs): C2's smallest input first
    ((1, 8, 1, 64), (1, 8, 1, 64), {}),
    ((2, 40, 4, 16), (2, 40, 2, 16), {"window": 9}),
    ((1, 24, 3, 32), (1, 24, 1, 32), {"causal": False, "scale": 0.3})]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_b5_function_gradients_are_the_plain_loops(monkeypatch, case,
                                                   dtype):
    """Fault C2: the output of B5's route carries a gradient, equal bit
    for bit to the plain query-chunk loop's with the call's arguments."""
    calls = _fit_everything(monkeypatch)
    shape_q, shape_kv, kw = case
    q, k, v = _qkv(shape_q, shape_kv, dtype)
    out = ta.chunked_attention(q, k, v, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert calls == {"B5": 1, "B4": 0}
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (out.float() * w).sum().backward()
    assert calls == {"B5": 1, "B4": 0}  # the backward launches nothing
    for got, want in zip((q.grad, k.grad, v.grad),
                         _plain_grads(q, k, v, w, **kw)):
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("case", CASES[:2])
def test_b4_function_gradients_are_the_plain_loops_and_jax(monkeypatch,
                                                          case):
    """B4's route: the gradient of the digit-serial plain loop, bit for
    bit, and that loop's gradient against ``jax.grad`` of the reference's
    ``chunked_attention(l2r=)``: q and k receive theirs through the
    per-vector scales alone (rounding has no gradient)."""
    calls = _fit_everything(monkeypatch)
    shape_q, shape_kv, kw = case
    q, k, v = _qkv(shape_q, shape_kv)
    out = ta.chunked_attention(q, k, v, l2r=QuantConfig(), **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionL2RBackward"
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (out * w).sum().backward()
    assert calls == {"B5": 0, "B4": 1}
    plain = _plain_grads(q, k, v, w, l2r=QuantConfig(), **kw)
    for got, want in zip((q.grad, k.grad, v.grad), plain):
        assert torch.equal(got, want)
    j = jax.jit(jax.grad(lambda q, k, v: jnp.sum(j_chunked_attention(
        q, k, v, l2r=JQuantConfig(), **kw) * jnp.asarray(w.numpy())),
        argnums=(0, 1, 2)))(*(jnp.asarray(x.detach().numpy())
                              for x in (q, k, v)))
    for got, want in zip(plain, j):
        want = np.asarray(want)
        # nonzero only at each vector's largest |x| for q and k
        assert np.array_equal(got.numpy() != 0, want != 0) or \
            np.abs(got.numpy() - want).max() < 1e-6
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("remat,launches", [(False, 1), (True, 2)])
def test_train_step_launches_b5_per_layer_exactly(monkeypatch, remat,
                                                  launches):
    """A step on B5's route launches it once a layer, twice with remat
    (the checkpointed forward runs again in the backward), and its
    gradients are the plain step's within the kernels' online-softmax
    reordering."""
    cfg = get_smoke("smollm-135m")
    params, batch = _port_params(cfg), _batch(cfg)
    _, plain = _grads(cfg, params, batch, remat=remat)
    calls = _fit_everything(monkeypatch)
    _, grads = _grads(cfg, params, batch, remat=remat)
    assert calls == {"B5": launches * cfg.n_layers, "B4": 0}
    for a, b in zip(tree_leaves(grads), tree_leaves(plain)):
        assert torch.count_nonzero(a) and torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(b.abs().max()))


def test_fma_f32_differentiates_as_a_product_and_a_sum():
    """The RG-LRU scan's fused combine has its own backward: torch builds
    without a derivative of ``nextafter`` (2.11 among them) train
    recurrentgemma all the same."""
    from repro_torch.models.resize import fma_f32

    g = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn(s, generator=g).requires_grad_(True)
               for s in ((3, 1), (3, 4), (4,)))
    out = fma_f32(a, b, c)
    assert type(out.grad_fn).__name__ == "_FmaF32Backward"
    w = torch.randn(out.shape, generator=g)
    (out * w).sum().backward()
    assert torch.equal(a.grad, (w * b).sum(1, keepdim=True).detach())
    assert torch.equal(b.grad, (w * a).detach())
    assert torch.equal(c.grad, w.sum(0))
