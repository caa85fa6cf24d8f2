"""Port parity for the RG-LRU block (models/rglru.py) against repro's, at
``get_smoke("recurrentgemma-2b")`` (d 64, LRU width 64, conv width 4,
f32), params built by JAX's ``materialize`` and carried across by value,
the same seeded numpy inputs to both.

Bit for bit: the scan (``lru_scan``) against the reference's
``jax.lax.associative_scan`` with its combine, jitted (XLA fuses the
combine's ``a2 * b1 + b2`` into one FMA, which the port emulates), on
equal (a, b) at S in {1, 2, 3, 7, 16, 2048}: h in every element, and the
running product of a wherever XLA:CPU does not flush a subnormal to zero
(the port's product keeps it; rglru_apply discards that product).  The
conv is bit for bit against the eager reference.

Within ulps: the gates (softplus as ``logaddexp(x, 0)``, sigmoid and exp
round apart in about 7 %, 0.4 % and a few % of elements), held to
GATES_REL of their largest |value|.  The block's output and state hold
to RGLRU_REL of their largest |value| (the float ``w_a``/``w_x`` matmuls
and the projections sum in other orders; measured about 2e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import common as jc
from repro.models import rglru as jr
from repro_torch.configs import get_smoke
from repro_torch.models import rglru as tr
from repro_torch.models.convert import lm_params_from_jax

ARCH = "recurrentgemma-2b"
GATES_REL = 1e-6
RGLRU_REL = 2e-6


def _close(got, ref, rel):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rel, err


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _combine(left, right):  # rglru.py's combine, as the reference has it
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


_j_scan = jax.jit(lambda a, b: jax.lax.associative_scan(_combine, (a, b),
                                                        axis=1))


@pytest.mark.parametrize("s", [1, 2, 3, 7, 16, 2048])
@pytest.mark.parametrize("lo", [0.001, 0.5])
def test_lru_scan_bit_identical(s, lo):
    rng = np.random.default_rng(s)
    a = rng.uniform(lo, 1.0, (2, s, 64)).astype(np.float32)
    b = rng.standard_normal((2, s, 64)).astype(np.float32)
    ja, jb = _j_scan(a, b)
    ta, tb = tr.lru_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    tiny = np.finfo(np.float32).tiny
    ta = ta.numpy()
    np.testing.assert_array_equal(np.where(np.abs(ta) < tiny, 0, ta),
                                  np.asarray(ja))


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_bit_identical(with_state):
    x, w, b = _rand(0, 2, 11, 64), _rand(1, 4, 64), _rand(2, 64)
    st = _rand(3, 2, 3, 64) if with_state else None
    jy, jst = jr._conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         None if st is None else jnp.asarray(st))
    ty, tst = tr._conv1d(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b),
                         None if st is None else torch.from_numpy(st))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = j_get_smoke(ARCH), get_smoke(ARCH)
    jp = jc.materialize(jr.rglru_build(jcfg), jax.random.PRNGKey(2))
    # non-trivial gate biases and Lambda, so every gate path is exercised
    jp = {**jp, "b_a": jnp.asarray(_rand(4, 64)),
          "b_x": jnp.asarray(_rand(5, 64)),
          "lam": jnp.asarray(2.0 * _rand(6, 64))}
    return jcfg, jp, tcfg, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                              device="cpu")


def test_gates_within_ulps(model):
    _, jp, _, tp = model
    xi = _rand(7, 2, 19, 64)
    ja, jb = jr._gates(jp, jnp.asarray(xi))
    ta, tb = tr._gates(tp, torch.from_numpy(xi))
    _close(ta, ja, GATES_REL)
    _close(tb, jb, GATES_REL)


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` within two ulps (exp and log1p round apart;
    XLA:CPU flushes subnormal results to zero)."""
    x = np.concatenate([_rand(8, 4096) * 30, [0.0, -0.0, 1e-30, 88.0,
                                               -88.0, 100.0]]
                       ).astype(np.float32)
    got = tr.softplus(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=2 ** -22,
                               atol=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("s", [1, 19])
def test_rglru_apply_without_state(model, s):
    jcfg, jp, tcfg, tp = model
    u = _rand(9, 2, s, tcfg.d_model)
    jy, jst = jr.rglru_apply(jcfg, jp, jnp.asarray(u))
    ty, tst = tr.rglru_apply(tcfg, tp, torch.from_numpy(u))
    _close(ty, jy, RGLRU_REL)
    _close(tst["h"], jst["h"], RGLRU_REL)
    _close(tst["conv"], jst["conv"], RGLRU_REL)


def test_rglru_apply_with_carried_state(model):
    jcfg, jp, tcfg, tp = model
    st = {"h": _rand(10, 2, 64), "conv": _rand(11, 2, 3, 64)}
    u = _rand(12, 2, 13, tcfg.d_model)
    jy, jst = jr.rglru_apply(jcfg, jp, jnp.asarray(u),
                             jax.tree.map(jnp.asarray, st))
    ty, tst = tr.rglru_apply(tcfg, tp, torch.from_numpy(u),
                             {k: torch.from_numpy(v) for k, v in st.items()})
    _close(ty, jy, RGLRU_REL)
    _close(tst["h"], jst["h"], RGLRU_REL)
    _close(tst["conv"], jst["conv"], RGLRU_REL)


def test_rglru_decode(model):
    jcfg, jp, tcfg, tp = model
    st = {"h": _rand(13, 2, 64), "conv": _rand(14, 2, 3, 64)}
    jst = jax.tree.map(jnp.asarray, st)
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    for step in range(3):
        u = _rand(15 + step, 2, 1, tcfg.d_model)
        jy, jst = jr.rglru_decode(jcfg, jp, jnp.asarray(u), jst)
        ty, tst = tr.rglru_decode(tcfg, tp, torch.from_numpy(u), tst)
        _close(ty, jy, RGLRU_REL)
        _close(tst["h"], jst["h"], RGLRU_REL)


def test_decode_continues_the_scan(model):
    """The port alone: rglru_apply over S tokens == rglru_apply over S-1
    tokens, then one rglru_decode step (the recurrence and the conv carry
    agree within RGLRU_REL: the scan and the step round apart, and the
    CPU's float matmuls over 9 rows and over 8 + 1 sum in other
    orders)."""
    _, _, tcfg, tp = model
    u = torch.from_numpy(_rand(18, 2, 9, tcfg.d_model))
    y, st = tr.rglru_apply(tcfg, tp, u)
    _, st8 = tr.rglru_apply(tcfg, tp, u[:, :8])
    yd, std = tr.rglru_decode(tcfg, tp, u[:, 8:], st8)
    _close(yd, y[:, 8:], RGLRU_REL)
    _close(std["h"], st["h"], RGLRU_REL)
    _close(std["conv"], st["conv"], RGLRU_REL)
