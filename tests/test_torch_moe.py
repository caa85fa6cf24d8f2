"""Port parity for the MoE ffn (models/moe.py) against repro's, at
``get_smoke("deepseek-moe-16b")`` (8 experts, top-2, 2 shared, d 64,
expert hidden 48) and ``get_smoke("llama4-maverick-400b-a17b")`` (8
experts, top-1, 1 shared), f32, params built by JAX's ``materialize``
and carried across by value.

Exact: ``moe_capacity``; the routing integers (``expert_idx``, ``slot``,
``keep``) on equal router logits, with dropped assignments and with
tied logits (the top-k takes the lower expert index first, as
``jax.lax.top_k``); and, with an L2R config, every expert matmul's
output on an equal dispatch buffer (zero capacity rows included): the
int8 codes, the int32 accumulators of B1's plain version and the
dequantization are the reference's.  Float results hold to MOE_REL of
their largest |value| (softmax, silu and the f32 matmuls round apart
in the last bits; measured about 2e-7), the aux loss to AUX_REL
(the mean of the router probabilities sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import quant as jq
from repro.kernels.l2r_gemm.ops import l2r_matmul_f as j_l2r_matmul_f
from repro.models import common as jc
from repro.models import moe as jm
from repro_torch.configs import get_smoke
from repro_torch.core import quant as tq
from repro_torch.kernels.l2r_gemm.ops import l2r_matmul_f
from repro_torch.models import moe as tm
from repro_torch.models.convert import lm_params_from_jax

ARCHS = ["deepseek-moe-16b", "llama4-maverick-400b-a17b"]
MOE_REL = 2e-6
AUX_REL = 1e-6


def _cfgs(arch, l2r):
    jcfg, tcfg = j_get_smoke(arch), get_smoke(arch)
    if l2r:
        jcfg = dataclasses.replace(jcfg, l2r=jq.QuantConfig())
        tcfg = dataclasses.replace(tcfg, l2r=tq.QuantConfig())
    return jcfg, tcfg


def _close(got, ref, rel=MOE_REL):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rel, err


@pytest.fixture(scope="module")
def params():
    out = {}
    for arch in ARCHS:
        jp = jc.materialize(jm.moe_build(j_get_smoke(arch)),
                            jax.random.PRNGKey(3))
        out[arch] = (jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                            device="cpu"))
    return out


@pytest.mark.parametrize("arch", ARCHS + ["mamba2-130m"])
def test_moe_capacity_matches(arch):
    jcfg, tcfg = j_get_smoke(arch), get_smoke(arch)
    for t in [1, 2, 7, 8, 9, 24, 100, 1000, 16384, 16386]:
        assert tm.moe_capacity(tcfg, t) == jm.moe_capacity(jcfg, t), t
    full_j = dataclasses.replace(jcfg, n_experts=64, experts_per_token=6)
    full_t = dataclasses.replace(tcfg, n_experts=64, experts_per_token=6)
    for t in [8, 16384, 16386]:
        assert tm.moe_capacity(full_t, t) == jm.moe_capacity(full_j, t)
    assert tm.moe_capacity(full_t, 16384) == 1920


def _j_route(cfg, logits, cap):
    """The reference's routing, moe.py:111-121 as it stands there."""
    e, k = cfg.n_experts, cfg.experts_per_token
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True), 1e-9)
    flat_e = expert_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(onehot, axis=0) - onehot
    slot = jnp.take_along_axis(pos_in_e, flat_e[:, None], axis=1)[:, 0]
    return probs, gate_vals, expert_idx, slot, slot < cap


def _logits(case, t, e):
    rng = np.random.default_rng(20)
    if case == "ties":  # a handful of distinct values: ties everywhere
        return rng.integers(0, 3, (t, e)).astype(np.float32)
    lg = rng.standard_normal((t, e)).astype(np.float32)
    if case == "drops":  # experts 0 and 1 favoured: over capacity
        lg[:, :2] += 2.0
    return lg


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["random", "drops", "ties"])
def test_routing_integers_exact(arch, case):
    jcfg, tcfg = _cfgs(arch, False)
    t = 24
    cap = tm.moe_capacity(tcfg, t)
    lg = _logits(case, t, tcfg.n_experts)
    ref = _j_route(jcfg, jnp.asarray(lg), cap)
    got = tm.moe_route(tcfg, torch.from_numpy(lg), cap)
    for name, g, r in zip(("probs", "gate_vals"), got[:2], ref[:2]):
        _close(g, r)
    for name, g, r in zip(("expert_idx", "slot", "keep"), got[2:], ref[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    keep = got[4].numpy()
    if case == "drops" or (case == "ties" and arch == ARCHS[0]):
        assert not keep.all()  # assignments were dropped
    if case == "ties":
        p = np.asarray(ref[0])
        k = tcfg.experts_per_token
        kth = np.sort(p, -1)[:, ::-1][:, k - 1:k]
        assert ((p == kth).sum(-1) > 1).any()  # a tie at the top-k edge


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_matmuls_on_b1_plain_bit_identical(params, arch):
    """Each expert's L2R matmul (the quantization of its activation rows
    and of its weight inside the call, B1's plain accumulators, the
    dequantization) equals the reference's vmapped ``l2r_matmul_f`` bit
    for bit, on a buffer with empty (zero) capacity rows."""
    jp, tp = params[arch]
    tcfg = get_smoke(arch)
    e, cap, d = tcfg.n_experts, 8, tcfg.d_model
    buf = np.random.default_rng(21).standard_normal((e, cap, d)) \
        .astype(np.float32)
    buf[:, 5:] = 0.0
    buf[3] = 0.0
    h = np.random.default_rng(25).standard_normal((e, cap, tcfg.moe_d_ff)) \
        .astype(np.float32)
    h[:, 6:] = 0.0
    wi2 = np.array(jp["wi"]).reshape(e, d, -1)
    ref = jax.vmap(lambda xe, we: j_l2r_matmul_f(xe, we, jq.QuantConfig()))(
        jnp.asarray(buf), jnp.asarray(wi2))
    got = torch.stack([l2r_matmul_f(torch.from_numpy(buf[i]),
                                    torch.from_numpy(wi2[i]),
                                    tq.QuantConfig()) for i in range(e)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for levels in (None, 5):
        qc = jq.QuantConfig()
        ref = jax.vmap(lambda he, we: j_l2r_matmul_f(he, we, qc, levels))(
            jnp.asarray(h), jp["wo"])
        got = torch.stack([l2r_matmul_f(
            torch.from_numpy(h[i]), tp["wo"][i], tq.QuantConfig(), levels)
            for i in range(e)])
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("l2r", [False, True])
def test_expert_ffn(params, arch, l2r):
    jp, tp = params[arch]
    jcfg, tcfg = _cfgs(arch, l2r)
    buf = np.random.default_rng(22).standard_normal(
        (tcfg.n_experts, 8, tcfg.d_model)).astype(np.float32)
    buf[:, 6:] = 0.0
    ref = jm._expert_ffn(jcfg, jp["wi"], jp["wo"], jnp.asarray(buf))
    got = tm._expert_ffn(tcfg, tp["wi"], tp["wo"], torch.from_numpy(buf))
    _close(got, ref)
    assert not got[:, 6:].any() and not np.asarray(ref)[:, 6:].any()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("l2r", [False, True])
@pytest.mark.parametrize("s", [12, 3])
def test_moe_apply(params, arch, l2r, s):
    """The whole layer (routing, dispatch, experts, combine, shared
    experts) and its aux loss; at T = 24 the capacity is 8 for a mean
    load of 6 (deepseek) or 3 (llama4), at T = 6 it is 8 for 1.5 or
    0.75."""
    jp, tp = params[arch]
    jcfg, tcfg = _cfgs(arch, l2r)
    x = np.random.default_rng(23).standard_normal((2, s, tcfg.d_model)) \
        .astype(np.float32)
    jy, jaux = jm.moe_apply(jcfg, jp, jnp.asarray(x))
    ty, taux = tm.moe_apply(tcfg, tp, torch.from_numpy(x))
    _close(ty, jy)
    assert taux.dtype == torch.float32 and taux.shape == ()
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_REL)


def test_shared_experts_and_aux_loss(params):
    """Without the shared experts the output changes by exactly their
    contribution's scale, and the aux loss is the reference's Switch
    formula: E * sum(mean prob * kept share) * weight."""
    arch = ARCHS[0]
    jp, tp = params[arch]
    jcfg, tcfg = _cfgs(arch, False)
    x = np.random.default_rng(24).standard_normal((2, 12, 64)) \
        .astype(np.float32)
    no_shared_j = dataclasses.replace(jcfg, n_shared_experts=0)
    no_shared_t = dataclasses.replace(tcfg, n_shared_experts=0)
    jy, _ = jm.moe_apply(no_shared_j, jp, jnp.asarray(x))
    ty, taux = tm.moe_apply(no_shared_t, tp, torch.from_numpy(x))
    _close(ty, jy)
    xt = torch.from_numpy(x).reshape(24, 64)
    probs, _, idx, _, keep = tm.moe_route(tcfg, xt @ tp["router"], 8)
    share = np.bincount(idx.reshape(-1)[keep].numpy(), minlength=8) / 48
    want = 8 * float((probs.mean(0).numpy() * share).sum()) * 0.01
    np.testing.assert_allclose(float(taux), want, rtol=AUX_REL)
