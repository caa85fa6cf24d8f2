"""Port parity for the Mamba-2 SSD mixer (models/ssm.py) against repro's,
at ``get_smoke("mamba2-130m")`` (d 64, d_inner 128, 8 heads of 16, state
16, chunk 16, f32), params built by JAX's ``materialize`` and carried
across by value, the same seeded numpy inputs to both.

The causal conv is bit for bit: the same products added in the same
order (the reference eager; under ``jit`` XLA fuses the multiply-adds).
The rest holds to SSM_REL of the output's largest |value|: torch and
XLA:CPU round ``exp``, ``log1p``, the cumsum and the chunk einsums (here
contracted in another association) apart in the last bits; measured
about 5e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import common as jc
from repro.models import ssm as js
from repro_torch.configs import get_smoke
from repro_torch.models import ssm as ts
from repro_torch.models.convert import lm_params_from_jax

ARCH = "mamba2-130m"
SSM_REL = 2e-6


def _close(got, ref, rel=SSM_REL):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rel, err


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = j_get_smoke(ARCH), get_smoke(ARCH)
    jp = jc.materialize(js.ssm_build(jcfg), jax.random.PRNGKey(1))
    return jcfg, jp, tcfg, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                              device="cpu")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_bit_identical(with_state):
    x, w, b = _rand(0, 2, 9, 12), _rand(1, 4, 12), _rand(2, 12)
    st = _rand(3, 2, 3, 12) if with_state else None
    jy, jst = js._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              None if st is None else jnp.asarray(st))
    ty, tst = ts._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b),
                              None if st is None else torch.from_numpy(st))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def test_segsum_scores_masks_without_nan():
    """exp(ca_i - ca_j) on and below the diagonal (within SSM_REL: exp
    rounds apart; XLA:CPU flushes subnormal results to zero, hence the
    absolute floor of the smallest normal f32), exact zeros above it,
    even where the masked exponent overflows to inf (cumsums of -200 a
    step)."""
    tiny = float(np.finfo(np.float32).tiny)
    ca = np.cumsum(-200.0 * np.abs(_rand(4, 2, 3, 16, 5)), axis=-2) \
        .astype(np.float32)
    ref = np.asarray(js._segsum_scores(jnp.asarray(ca)))
    got = ts._segsum_scores(torch.from_numpy(ca)).numpy()
    assert np.isfinite(got).all()
    upper = np.triu(np.ones((16, 16), bool), 1)
    assert (got[..., upper] == 0).all() and (ref[..., upper] == 0).all()
    np.testing.assert_allclose(got, ref, rtol=SSM_REL, atol=tiny)
    ca = np.cumsum(-np.abs(_rand(5, 2, 3, 16, 5)), axis=-2).astype(np.float32)
    np.testing.assert_allclose(ts._segsum_scores(torch.from_numpy(ca)).numpy(),
                               np.asarray(js._segsum_scores(jnp.asarray(ca))),
                               rtol=SSM_REL, atol=0)


def _ssd_inputs(s):
    bsz, h, p, n = 2, 4, 8, 16
    x, b, c = _rand(6, bsz, s, h, p), _rand(7, bsz, s, n), _rand(8, bsz, s, n)
    dt = np.log1p(np.exp(_rand(9, bsz, s, h))).astype(np.float32)
    a = (-np.exp(_rand(10, h) * 0.5) * dt).astype(np.float32)
    return x, dt, a, b, c


@pytest.mark.parametrize("s,chunk", [(32, 16), (16, 16), (48, 8)])
def test_ssd_chunked(s, chunk):
    ins = _ssd_inputs(s)
    jy, jf = js.ssd_chunked(*map(jnp.asarray, ins), chunk)
    ty, tf = ts.ssd_chunked(*map(torch.from_numpy, ins), chunk)
    _close(ty, jy)
    _close(tf, jf)


@pytest.mark.parametrize("s", [16, 40, 3])
def test_ssm_apply_without_state(model, s):
    """S a multiple of the chunk, and not (zero-padded to one)."""
    jcfg, jp, tcfg, tp = model
    u = _rand(11, 2, s, tcfg.d_model)
    jy, jst = js.ssm_apply(jcfg, jp, jnp.asarray(u))
    ty, tst = ts.ssm_apply(tcfg, tp, torch.from_numpy(u))
    _close(ty, jy)
    _close(tst["ssd"], jst["ssd"])
    _close(tst["conv"], jst["conv"])


def test_ssm_apply_with_state_keeps_the_reference_quirk(model):
    """A continued prefill: the conv state carries over, and the incoming
    ``state["ssd"]`` is ignored in both packages (the chunked scan starts
    from zeros)."""
    jcfg, jp, tcfg, tp = model
    u = _rand(12, 2, 20, tcfg.d_model)
    st = {"ssd": _rand(13, 2, 8, 16, 16), "conv": _rand(14, 2, 3, 160)}
    zero = {"ssd": np.zeros_like(st["ssd"]), "conv": st["conv"]}
    outs = {}
    for name, s in (("state", st), ("zero_ssd", zero)):
        jy, jst = js.ssm_apply(jcfg, jp, jnp.asarray(u),
                               jax.tree.map(jnp.asarray, s))
        ty, tst = ts.ssm_apply(tcfg, tp, torch.from_numpy(u),
                               {k: torch.from_numpy(v) for k, v in s.items()})
        _close(ty, jy)
        _close(tst["ssd"], jst["ssd"])
        outs[name] = (np.asarray(jy), ty.numpy())
    np.testing.assert_array_equal(outs["state"][0], outs["zero_ssd"][0])
    np.testing.assert_array_equal(outs["state"][1], outs["zero_ssd"][1])
    jy0, _ = js.ssm_apply(jcfg, jp, jnp.asarray(u))
    assert not np.array_equal(np.asarray(jy0), outs["state"][0])  # conv did


def test_ssm_decode(model):
    jcfg, jp, tcfg, tp = model
    st = {"ssd": _rand(15, 2, 8, 16, 16), "conv": _rand(16, 2, 3, 160)}
    jst = jax.tree.map(jnp.asarray, st)
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    for step in range(3):
        u = _rand(17 + step, 2, 1, tcfg.d_model)
        jy, jst = js.ssm_decode(jcfg, jp, jnp.asarray(u), jst)
        ty, tst = ts.ssm_decode(tcfg, tp, torch.from_numpy(u), tst)
        _close(ty, jy)
        _close(tst["ssd"], jst["ssd"])
        _close(tst["conv"], jst["conv"])


def test_init_ssm_state_matches(model):
    jcfg, _, tcfg, _ = model
    jst = js.init_ssm_state(jcfg, 3)
    tst = ts.init_ssm_state(tcfg, 3, device="cpu")
    for k in ("ssd", "conv"):
        assert tuple(tst[k].shape) == jst[k].shape
        assert tst[k].dtype == torch.float32 and not tst[k].any()
