"""Port parity: per-row precision classes (repro_torch.core.policy against
repro.core.policy, single device).

The decision fold runs on float scores, so it is where the float order
matters: the port keeps the reference's operands and order, and
decisions, committed tokens, exit levels and logits compare bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpol
from repro.core import progressive as jp
from repro.core import quant as jq
from repro_torch.core import policy as tpol
from repro_torch.core import progressive as tp
from repro_torch.core import quant as tq


def _eq(t, ref, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref), err_msg=msg)


def test_precision_class_validation_labels_and_rows():
    with pytest.raises(ValueError, match="unknown precision class"):
        tpol.PrecisionClass("fast")
    with pytest.raises(ValueError, match="levels >= 1"):
        tpol.PrecisionClass.budget(0)
    for t, j in ((tpol.PrecisionClass.exact(), jpol.PrecisionClass.exact()),
                 (tpol.PrecisionClass.budget(3),
                  jpol.PrecisionClass.budget(3)),
                 (tpol.PrecisionClass.bounded(0.1),
                  jpol.PrecisionClass.bounded(0.1))):
        assert t.label() == j.label() and t.row() == j.row()
    assert (tpol.MODE_EXACT, tpol.MODE_BUDGET, tpol.MODE_BOUNDED,
            tpol.NO_CLAMP) == (jpol.MODE_EXACT, jpol.MODE_BUDGET,
                               jpol.MODE_BOUNDED, jpol.NO_CLAMP)


def test_level_policy_rows_and_set_row():
    classes = [tpol.PrecisionClass.exact(), tpol.PrecisionClass.budget(2),
               tpol.PrecisionClass.bounded(0.25)]
    got = tpol.LevelPolicy.from_classes(classes)
    ref = jpol.LevelPolicy.from_classes(
        [jpol.PrecisionClass(c.kind, c.levels, c.tol) for c in classes])
    for g, r in zip(got, ref):
        _eq(g, r)
    assert got.rows == 3 and got.mode.dtype == torch.int32
    pol = tpol.LevelPolicy.exact(3)
    new = pol.set_row(1, tpol.PrecisionClass.budget(2))
    assert int(new.mode[1]) == tpol.MODE_BUDGET and int(new.clamp[1]) == 2
    assert int(pol.mode[1]) == tpol.MODE_EXACT  # the old policy is kept
    for g, r in zip(tpol.LevelPolicy.bounded(2, 0.5),
                    jpol.LevelPolicy.bounded(2, 0.5)):
        _eq(g, r)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decision_state_matches_reference(seed):
    """Decided rows and argmax (first index on ties), with a per-entry
    and a per-row bound."""
    rng = np.random.default_rng(seed)
    values = rng.standard_normal((16, 9)).astype(np.float32)
    values[0, 3] = values[0, 7] = values[0].max() + 1.0  # a tie
    values[1] += 10 * np.eye(9, dtype=np.float32)[2]      # a clear winner
    for bvec in (np.abs(rng.standard_normal((16, 9))).astype(np.float32),
                 np.full((16, 1), 0.3, np.float32)):
        ref = jpol.decision_state(jnp.asarray(values), jnp.asarray(bvec))
        got = tpol.decision_state(torch.from_numpy(values),
                                  torch.from_numpy(bvec))
        for g, r in zip(got, ref):
            _eq(g, r)
    assert bool(got[0][1]) and int(got[1][0]) == 3


def test_policy_commit_matches_reference():
    rng = np.random.default_rng(3)
    classes = [jpol.PrecisionClass.exact(), jpol.PrecisionClass.budget(3),
               jpol.PrecisionClass.bounded(), jpol.PrecisionClass.budget(1)]
    t_classes = [tpol.PrecisionClass(c.kind, c.levels, c.tol)
                 for c in classes]
    jpolicy = jpol.LevelPolicy.from_classes(classes * 2)
    tpolicy = tpol.LevelPolicy.from_classes(t_classes * 2)
    for idx in range(7):
        decided = rng.random(8) < 0.5
        done = rng.random(8) < 0.3
        for jp_, tp_ in ((None, None), (jpolicy, tpolicy)):
            ref = jpol.policy_commit(jp_, jnp.asarray(decided), idx,
                                     jnp.asarray(done))
            got = tpol.policy_commit(tp_, torch.from_numpy(decided), idx,
                                     torch.from_numpy(done))
            for g, r in zip(got, ref):
                _eq(g, r, f"idx={idx}")


@pytest.fixture(scope="module")
def head():
    """A decisive-margin head from the same seed in both packages."""
    from repro.models.protohead import prototype_head as j_head
    from repro_torch.models.protohead import prototype_head as t_head

    j = j_head(np.random.default_rng(3), 96, 12, 9)
    t = t_head(np.random.default_rng(3), 96, 12, 9, device="cpu")
    bias = np.random.default_rng(4).normal(size=(12,)).astype(np.float32)
    return j, t, bias


def _both(head, bias_on, j_policy=None, t_policy=None, rows=slice(None),
          **kw):
    (jx, jxs, jw, _), (tx, txs, tw, _), bias = head
    ref = jp.streaming_argmax(jx[rows], jw.q, jxs[rows], jw.scale,
                              bias=jnp.asarray(bias) if bias_on else None,
                              policy=j_policy, **kw)
    got = tp.streaming_argmax(tx[rows], tw.q, txs[rows], tw.scale,
                              bias=torch.from_numpy(bias) if bias_on
                              else None, policy=t_policy, **kw)
    for g, r in zip(got, ref):
        _eq(g, r, str(kw))
    return got


MIXED = [("exact", None, 0.0), ("budget", 3, 0.0), ("bounded", None, 0.0),
         ("bounded", None, 0.1)]


@pytest.mark.parametrize("bias_on", [False, True])
@pytest.mark.parametrize("early_exit", [False, True])
def test_mixed_policy_walk_matches_reference(head, early_exit, bias_on):
    """exact, budget(3), bounded(0) and bounded(0.1) rows in one batch:
    logits, tokens and exit levels bit for bit, on both control flows."""
    rows = head[1][0].shape[0]
    spec = [MIXED[i % len(MIXED)] for i in range(rows)]
    got = _both(head, bias_on,
                jpol.LevelPolicy.from_classes(
                    [jpol.PrecisionClass(*s) for s in spec]),
                tpol.LevelPolicy.from_classes(
                    [tpol.PrecisionClass(*s) for s in spec]),
                early_exit=early_exit)
    lv = got[2].numpy()
    for i, (kind, levels, _) in enumerate(spec):
        if kind == "exact":
            assert lv[i] == 6
        if kind == "budget":
            assert lv[i] <= levels - 1


@pytest.mark.parametrize("early_exit", [False, True])
def test_single_class_policies_match_reference(head, early_exit):
    rows = head[1][0].shape[0]
    for lvl in (1, 3, 7):
        _both(head, True, jpol.LevelPolicy.budget(lvl, rows),
              tpol.LevelPolicy.budget(lvl, rows), early_exit=early_exit)
    _both(head, False, jpol.LevelPolicy.exact(rows),
          tpol.LevelPolicy.exact(rows), early_exit=early_exit)
    bounded = _both(head, False, jpol.LevelPolicy.bounded(rows),
                    tpol.LevelPolicy.bounded(rows), early_exit=early_exit)
    plain = _both(head, False, early_exit=early_exit)
    for a, b in zip(bounded, plain):  # bounded(0) is the plain walk
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mixed_rows_commit_as_alone(head):
    """Rows are decision-independent: each row of a mixed batch commits
    what it commits alone."""
    rows = head[1][0].shape[0]
    classes = [tpol.PrecisionClass(*MIXED[i % len(MIXED)])
               for i in range(rows)]
    (_, tok, lv) = _both(head, False, jpol.LevelPolicy.from_classes(
        [jpol.PrecisionClass(c.kind, c.levels, c.tol) for c in classes]),
        tpol.LevelPolicy.from_classes(classes), early_exit=True)
    _, (tx, txs, tw, _), _ = head
    for i, c in enumerate(classes):
        _, tok_i, lv_i = tp.streaming_argmax(
            tx[i:i + 1], tw.q, txs[i:i + 1], tw.scale,
            policy=tpol.LevelPolicy.from_classes([c]), early_exit=True)
        assert int(tok[i]) == int(tok_i[0]) and int(lv[i]) == int(lv_i[0])


def test_policy_rows_must_match_batch(head):
    _, (tx, txs, tw, _), _ = head
    with pytest.raises(ValueError, match="policy rows"):
        tp.streaming_argmax(tx, tw.q, txs, tw.scale,
                            policy=tpol.LevelPolicy.exact(2))


def test_head_walk_fold_widens_safety_in_float32():
    """bvec's (1 + safety) is one f32 value, as JAX's weak-typed scalar:
    the fold's decisions at a margin within that rounding agree."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 6)).astype(np.float32)
    jx, jxs = jq.quantize(jnp.asarray(x), jq.QuantConfig(), axis=0)
    jw = jq.quantize_weights(jnp.asarray(w), jq.QuantConfig())
    tx, txs = tq.quantize(torch.from_numpy(x), tq.QuantConfig(), axis=0)
    tw = tq.quantize_weights(torch.from_numpy(w), tq.QuantConfig())
    for safety in (1e-5, 0.3, 1e-9):
        ref = jp.streaming_argmax(jx, jw.q, jxs, jw.scale, safety=safety)
        got = tp.streaming_argmax(tx, tw.q, txs, tw.scale, safety=safety)
        for g, r in zip(got, ref):
            _eq(g, r, f"safety={safety}")
