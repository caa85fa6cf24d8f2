"""Port parity for the LM with digit-serial attention (ROADMAP A9b):
``cfg.attn_l2r`` through ``lm_forward``'s prefill and decode (the
plane-stacked KV cache filled by the prefill and appended by every
decode step, the decode walk on its planes), ``attn_levels``, and
``greedy_generate`` with and without ``attn_early_exit``, against
repro's at ``get_smoke("smollm-135m")`` (6 layers, d = 96, f32), params
built by JAX's ``materialize`` and carried across by value.

Hidden states and the caches' k, v hold to tests/test_torch_lm.py's
two-level rule: within 2e-5 on at least half of the rows, and within 5 %
of a row's largest |value| on every row.  Each quantization (of an L2R
dense's input, and here of every query and key vector) can round an
int8 code the other way after a last-bit float difference upstream, and
that moves the row by a few percent.  Integer parts compare bit for bit:
the plane cache against re-extraction from the cache's own keys, the
positions, and the greedy tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import quant as jq
from repro.models import common as jc
from repro.models import transformer as jt
from repro.serve import engine as je
from repro_torch.configs import get_smoke
from repro_torch.core import quant as tq
from repro_torch.core.l2r_attention import quantize_per_vector
from repro_torch.models import attention as ta
from repro_torch.models import transformer as tt
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.serve import engine as te

ARCH = "smollm-135m"
HIDDEN_TIGHT, FLIP = 2e-5, 0.05  # tests/test_torch_lm.py's two levels
PROMPT = np.random.default_rng(3).integers(0, 512, (2, 8)).astype(np.int32)


def _cfgs(variant):
    """(reference cfg, port cfg) with digit-serial attention: "attn" alone,
    "attn5" truncated at 5 levels, "both" with the L2R denses too."""
    jcfg, tcfg = j_get_smoke(ARCH), get_smoke(ARCH)
    jkw = dict(attn_l2r=jq.QuantConfig())
    tkw = dict(attn_l2r=tq.QuantConfig())
    if variant == "attn5":
        jkw["attn_levels"] = tkw["attn_levels"] = 5
    if variant == "both":
        jkw["l2r"], tkw["l2r"] = jq.QuantConfig(), tq.QuantConfig()
    return (dataclasses.replace(jcfg, **jkw),
            dataclasses.replace(tcfg, **tkw))


@pytest.fixture(scope="module")
def params():
    jp = jc.materialize(jt.lm_build(j_get_smoke(ARCH)), jax.random.PRNGKey(0))
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _rows(got, ref):
    """(largest |got - ref|, largest |ref|) of each row (last axis)."""
    got = np.asarray(got, np.float32).reshape(-1, ref.shape[-1])
    ref = np.asarray(ref, np.float32).reshape(-1, ref.shape[-1])
    return np.stack([np.abs(got - ref).max(-1), np.abs(ref).max(-1)], -1)


def _assert_rows(rows):
    d, mag = np.concatenate(rows).T
    assert (d <= FLIP * mag).all(), (d / mag).max()
    assert (d <= HIDDEN_TIGHT).mean() >= 0.5, d


@pytest.mark.parametrize("variant", ["attn", "attn5", "both"])
def test_prefill_then_decode_on_the_plane_cache(params, variant):
    """Prefill 9 tokens into a 16-slot state, then two decode steps: the
    hidden states and the caches' k, v within the two-level rule; the
    positions and ``pos`` bit for bit; every layer's plane cache equal to
    re-extraction from its own float keys, bit for bit, empty slots
    included."""
    jcfg, tcfg = _cfgs(variant)
    jp, tp = je.prepare_params(jcfg, params[0]), te.prepare_params(tcfg,
                                                                   params[1])
    tokens = np.random.default_rng(9).integers(0, 512, (2, 11)).astype(
        np.int32)
    jst = jt.init_lm_state(jcfg, 2, 16, jnp.float32)
    tst = tt.init_lm_state(tcfg, 2, 16, torch.float32, device="cpu")
    steps = {m: jax.jit(lambda p, t, st, m=m: jt.lm_forward(
        jcfg, p, tokens=t, mode=m, state=st)) for m in ("prefill", "decode")}
    rows = []
    for mode, a, b in [("prefill", 0, 9), ("decode", 9, 10),
                       ("decode", 10, 11)]:
        ref, jst, _ = steps[mode](jp, jnp.asarray(tokens[:, a:b]), jst)
        got, tst, _ = tt.lm_forward(tcfg, tp,
                                    tokens=torch.from_numpy(tokens[:, a:b]),
                                    mode=mode, state=tst)
        rows.append(_rows(got.numpy(), ref))
        np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    jc0, tc0 = jst.stack[0], tst.stack[0]
    np.testing.assert_array_equal(tc0.positions.numpy(),
                                  np.asarray(jc0.positions))
    for name in ("k", "v"):  # one row per (layer, batch, slot, kv head)
        rows.append(_rows(getattr(tc0, name).numpy(), getattr(jc0, name)))
    _assert_rows(rows)
    assert tc0.k_planes.shape == tuple(jc0.k_planes.shape)
    kq, ks = quantize_per_vector(tc0.k, tcfg.attn_l2r)
    restack = torch.nn.functional.pad(
        tq.stack_planes_rhs(kq, 8, 2, axis=-1, shifted=False),
        (0, 3 * tcfg.head_dim))
    assert torch.equal(tc0.k_planes, restack)
    assert torch.equal(tc0.k_scale, ks[..., 0])


def test_decode_step_reads_the_cache_planes(params, monkeypatch):
    """A decode step walks the cache's own plane stack: it never
    quantizes the float key cache (only the new token's keys, once per
    layer, for the append)."""
    _, tcfg = _cfgs("attn")
    tp = params[1]
    state, _ = te.make_prefill_step(tcfg, 12, torch.float32)(
        tp, {"tokens": torch.from_numpy(PROMPT)})
    seen = []
    real = ta.quantize_per_vector

    def spy(x, cfg):
        seen.append(tuple(x.shape))
        return real(x, cfg)

    monkeypatch.setattr(ta, "quantize_per_vector", spy)
    te.make_decode_step(tcfg)(tp, state, torch.zeros((2, 1),
                                                     dtype=torch.int32))
    n, kv, dh = tcfg.n_layers, tcfg.n_kv, tcfg.head_dim
    assert seen.count((2, 1, kv, dh)) == n  # the appended keys
    assert seen.count((2, 1, kv, tcfg.n_heads // kv, dh)) == n  # queries
    assert len(seen) == 2 * n


@pytest.mark.parametrize("early_exit", [False, True])
def test_greedy_generate_equals_the_reference_tokens(params, early_exit):
    """greedy_generate with attn_l2r, with and without the margin-bounded
    progressive decode attention (tolerance 1e-4): the reference's tokens
    exactly, which are also the full-depth tokens (the reference's own
    acceptance criterion, tests/test_l2r_attention.py)."""
    jcfg, tcfg = _cfgs("attn")
    if early_exit:
        jcfg = dataclasses.replace(jcfg, attn_early_exit=True,
                                   attn_exit_tol=1e-4)
        tcfg = dataclasses.replace(tcfg, attn_early_exit=True,
                                   attn_exit_tol=1e-4)
    ref = np.asarray(je.greedy_generate(jcfg, params[0],
                                        jnp.asarray(PROMPT), steps=5))
    with ta.attn_exit_tap() as rec:
        got = te.greedy_generate(tcfg, params[1], torch.from_numpy(PROMPT),
                                 steps=5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    n = tcfg.n_layers
    assert len(rec) == (4 * n if early_exit else 0)  # 4 decode steps
    if early_exit:
        full = te.greedy_generate(dataclasses.replace(tcfg,
                                                      attn_early_exit=False),
                                  params[1], torch.from_numpy(PROMPT), 5)
        assert torch.equal(got, full)
