"""The port's AdamW and EF gradient compression against the reference.

The reference's optimizer runs inside its jitted train step, so every
comparison is against ``jax.jit`` of the reference function.  Float
results (schedule, norm, clip, AdamW) are held to a few f32 ulps; the
int8 wire format (``_q8`` codes and scale, the EF round trip's
compressed gradients and residuals) bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ja
from repro.optim import compression as jc
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw as ta
from repro_torch.optim import compression as tc


RTOL = 4e-7  # a few f32 ulps: XLA and torch order or fuse a product alike
CFG = dict(lr=3e-3, warmup_steps=5, total_steps=40, weight_decay=0.1,
           clip_norm=1.0)


def _tree(rng, scale=1.0):
    """A small param-shaped tree: dicts (unsorted keys) and a list."""
    mk = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa
    return {"w": mk(6, 5), "b": mk(5), "stack": [{"z": mk(2, 3, 4)},
                                                 {"a": mk(7)}]}


def _torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_tree_leaves_walk_jax_order():
    tree = _tree(np.random.default_rng(0))
    for a, b in zip(jax.tree.leaves(tree), tree_leaves(_torch(tree))):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("cfg", [
    CFG, dict(CFG, warmup_steps=0, total_steps=1, min_lr_ratio=0.0),
    dict(CFG, lr=1e-3, warmup_steps=100, total_steps=10_000)])
def test_cosine_schedule(cfg):
    jcfg, tcfg = ja.AdamWConfig(**cfg), ta.AdamWConfig(**cfg)
    f = jax.jit(lambda s: ja.cosine_schedule(jcfg, s))
    for step in (0, 1, 2, 4, 5, 6, 17, 39, 40, 41, 100, 5000, 10_000):
        got = ta.cosine_schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got, f(jnp.asarray(step, jnp.int32)))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_global_norm_and_clip(scale):
    tree = _tree(np.random.default_rng(1), scale)
    got_n = ta.global_norm(_torch(tree))
    _close(got_n, jax.jit(ja.global_norm)(tree))
    clipped, n = ta.clip_by_global_norm(_torch(tree), 1.0)
    want, wn = jax.jit(lambda t: ja.clip_by_global_norm(t, 1.0))(tree)
    _close(n, wn)
    for a, b in zip(tree_leaves(clipped), jax.tree.leaves(want)):
        _close(a, b, atol=1e-9)


@pytest.mark.parametrize("clip", [1.0, None])
def test_three_adamw_steps(clip):
    cfg = dict(CFG, clip_norm=clip)
    jcfg, tcfg = ja.AdamWConfig(**cfg), ta.AdamWConfig(**cfg)
    rng = np.random.default_rng(2)
    params = _tree(rng)
    jp, jo = params, ja.adamw_init(params)
    tp = _torch(params)
    to = ta.adamw_init(tp)
    upd = jax.jit(lambda g, p, o: ja.adamw_update(jcfg, g, p, o))
    for _ in range(3):
        grads = _tree(rng, 0.3)
        jp, jo, jm = upd(grads, jp, jo)
        tp, to, tm = ta.adamw_update(tcfg, _torch(grads), tp, to)
        assert int(to.step) == int(jo.step) and to.step.dtype == torch.int32
        for key in ("grad_norm", "lr"):
            _close(tm[key], jm[key])
        # XLA fuses b1 * m + (1 - b1) * g into one FMA: where the sum
        # cancels, m's last bits move relative to the tensor's scale
        for tt, jt in ((tp, jp), (to.m, jo.m), (to.v, jo.v)):
            for a, b in zip(tree_leaves(tt), jax.tree.leaves(jt)):
                assert a.dtype == torch.float32
                _close(a, b, rtol=2e-6,
                       atol=2e-7 * float(np.abs(np.asarray(b)).max()))


def _q8_cases():
    rng = np.random.default_rng(3)
    cases = [np.zeros(7, np.float32), np.full(5, 1e-35, np.float32),
             np.array([3.0, -3.0, 1.5], np.float32)]
    for i in range(60):  # four lengths: four compiles of the reference
        n = (1, 7, 64, 300)[i % 4]
        cases.append((rng.standard_normal(n)
                      * 10 ** rng.uniform(-8, 4)).astype(np.float32))
    return cases


def test_q8_bit_for_bit():
    """Codes and scale equal the jitted reference's (it multiplies by
    f32(1/127) under jit; eager JAX divides, and differs in some scale's
    last bit)."""
    f = jax.jit(jc._q8)
    differs = 0
    for x in _q8_cases():
        q, s = tc._q8(torch.from_numpy(x))
        wq, ws = f(jnp.asarray(x))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(wq))
        assert s.numpy().tobytes() == np.asarray(ws).tobytes()
        differs += np.asarray(jc._q8(jnp.asarray(x))[1]) != np.asarray(ws)
    assert differs  # the eager form is another function


def test_ef_round_trips_bit_for_bit():
    """Three rounds of error feedback: the compressed gradients and the
    residuals equal the jitted reference's (its ``x - q * scale`` is one
    fused multiply-add there)."""
    rng = np.random.default_rng(4)
    jr = ja.adamw_init(_tree(rng)).m  # zero residuals
    ef_j, ef_t = jc.EFState(residual=jr), tc.ef_init(_torch(_tree(rng)))
    f = jax.jit(jc.ef_compress_grads)
    for rnd in range(3):
        grads = _tree(rng, 10.0 ** (rnd - 2))
        wg, ef_j = f(grads, ef_j)
        tg, ef_t = tc.ef_compress_grads(_torch(grads), ef_t)
        for a, b in zip(tree_leaves(tg) + tree_leaves(ef_t.residual),
                        jax.tree.leaves(wg) + jax.tree.leaves(ef_j.residual)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_compress_decompress_bit_for_bit():
    """The round trip alone under jit.  A one-element vector is left out:
    XLA compiles its residual as a product and a subtraction, two
    roundings, where every longer leaf (and every leaf of the models'
    trees) gets the fused multiply-add the port computes."""
    f = jax.jit(jc.compress_decompress)
    for x in (x for x in _q8_cases()[:24] if x.size > 1):
        xhat, err = tc.compress_decompress(torch.from_numpy(x))
        wx, we = f(jnp.asarray(x))
        assert np.array_equal(xhat.numpy(), np.asarray(wx))
        assert np.array_equal(err.numpy(), np.asarray(we))
