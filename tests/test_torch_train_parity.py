"""One train step of five families, the port's against the reference's,
from the same params and optimizer state (crossed by value:
``lm_params_from_jax``, ``opt_state_from_jax``).

The reference's step runs under ``jax.jit`` (it reaches no Pallas
kernel: the configs train with ``l2r=None``), one compile a family that
also returns its gradient; the port's runs eagerly on the CPU.  A leaf's
gradient is held to ``|g - g_ref| <= rtol |g_ref| + 1e-6 |G_ref|`` (G the
whole gradient: a leaf whose exact gradient is 0, like a key bias under
softmax, carries only rounding noise), with rtol per family below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models.common import materialize as j_materialize
from repro.models.encdec import encdec_build as j_encdec_build
from repro.models.transformer import lm_build as j_lm_build
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import OptState as JOptState
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_loss_fn as j_make_loss_fn
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke
from repro_torch.models.convert import lm_params_from_jax, opt_state_from_jax
from repro_torch.models.common import tree_leaves
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import TrainConfig, make_train_step
from test_torch_train import (LR, TCFG, _batch, _grads,  # noqa: F401
                              _one_torch_thread, _t)


# per-leaf gradient rtol: reordered f32 sums, which whisper-base's smoke
# decoder magnifies (its stacked weights draw their std from the layers
# axis, ROADMAP Caveats: |x| grows layer by layer)
GRAD_RTOL = {"smollm-135m": 2e-4, "recurrentgemma-2b": 5e-4,
             "deepseek-moe-16b": 1e-3, "whisper-base": 3e-3,
             "mamba2-130m": 2e-4}


def _ref_state(params, seed=5):
    """A reached optimizer state: m ~ 1e-3, v = m^2 + 1e-6 (so the
    update's m/sqrt(v) is of order 1), at step 3."""
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32) * 1e-3), params)
    v = jax.tree.map(lambda x: jnp.square(x) + 1e-6, m)
    return JOptState(step=jnp.asarray(3, jnp.int32), m=m, v=v)


def _leaf_close(got, want, rtol, global_norm):
    got, want = got.numpy(), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    err = np.linalg.norm(got[ok] - want[ok])
    assert err <= rtol * np.linalg.norm(want[ok]) + 1e-6 * global_norm, err


@pytest.mark.parametrize("arch", list(GRAD_RTOL))
def test_train_step_matches_reference(arch):
    """From the same params and optimizer state, one step: the loss and
    metrics, every leaf's gradient, the updated params and moments.

    mamba2-130m's gradient is NaN in both packages: the SSD's
    ``where(mask, exp(segsum), 0)`` overflows exp in the masked upper
    triangle and 0 * inf poisons the backward (ROADMAP Caveats); the
    port keeps it, with the same NaN leaves and elements."""
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    build = j_encdec_build if jcfg.family == "encdec" else j_lm_build
    params = j_materialize(build(jcfg), jax.random.PRNGKey(0))
    opt = _ref_state(params)
    batch = _batch(jcfg)
    ocfg = dict(lr=LR, warmup_steps=2)
    grad_fn = jax.value_and_grad(j_make_loss_fn(jcfg, JTrainConfig(**TCFG)),
                                 has_aux=True)
    step = j_make_train_step(jcfg, JAdamWConfig(**ocfg), JTrainConfig(**TCFG))

    def both(p, o, b):  # one compile: the gradient and the reference step
        return grad_fn(p, b)[1], step(p, o, b)

    j_grads, (j_p, j_o, j_m) = jax.jit(both)(
        params, opt, {k: jnp.asarray(v) for k, v in batch.items()})

    tp = lm_params_from_jax(params, "cpu")
    to = opt_state_from_jax(opt, "cpu")
    _, t_grads = _grads(cfg, tp, batch)
    t_p, t_o, t_m = make_train_step(cfg, AdamWConfig(**ocfg),
                                    TrainConfig(**TCFG))(tp, to, _t(batch))

    assert set(t_m) == set(j_m) == {"loss", "aux", "accuracy", "grad_norm",
                                    "lr"}
    for k in t_m:  # the norm sums every leaf's error
        np.testing.assert_allclose(
            float(t_m[k]), float(j_m[k]), atol=1e-7,
            rtol=GRAD_RTOL[arch] if k == "grad_norm" else 2e-5)
    gn = float(j_m["grad_norm"])
    nan = arch == "mamba2-130m"
    assert np.isnan(gn) == nan
    gn = 0.0 if nan else gn
    for a, b in zip(tree_leaves(t_grads), jax.tree.leaves(j_grads)):
        _leaf_close(a, b, GRAD_RTOL[arch], gn)
    assert int(t_o.step) == int(j_o.step) == 4
    # the moments move with the gradient (norm-wise, as the gradient);
    # a param moves by lr times an O(1) ratio, so 1e-5 is 1 % of lr
    for tt, jt in ((t_o.m, j_o.m), (t_o.v, j_o.v)):
        for a, b in zip(tree_leaves(tt), jax.tree.leaves(jt)):
            assert a.dtype == torch.float32
            _leaf_close(a, b, GRAD_RTOL[arch], 0.0)
    for a, b in zip(tree_leaves(t_p), jax.tree.leaves(j_p)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
