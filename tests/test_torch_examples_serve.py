"""The port's examples (examples/torch/), part 2: serving, the gateway,
training and precision classes on the CPU (``--device cpu``); and
tools/calibrate_levels.py, unchanged, on the port's histograms: the
budgets it fits to a port ``ContinuousBatcher.stats()`` dump are the
ones it fits to the reference's for the same requests.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np

from repro.configs import get_smoke as j_get_smoke
from repro.core.policy import PrecisionClass as JPrecisionClass
from repro.core.quant import QuantConfig as JQuantConfig
from repro.models import common as jc
from repro.models import transformer as jt
from repro.serve import batching as jb
from repro.serve import engine as je
from repro_torch.configs import get_smoke
from repro_torch.core.policy import PrecisionClass
from repro_torch.core.quant import QuantConfig
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.serve import engine as te
from repro_torch.serve.batching import ContinuousBatcher, Request
from test_torch_examples_core import example
from test_torch_train import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_serve_gateway(capsys):
    example("serve_gateway").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "output streams bit-identical to the plain batcher" in out
    assert "tokens still bit-identical" in out


def test_train_smollm(capsys, tmp_path):
    losses = example("train_smollm").main(
        ["--device", "cpu", "--steps", "40", "--seq-len", "32",
         "--ckpt-dir", str(tmp_path)])
    assert losses[-1] < losses[0]
    assert "checkpoints in" in capsys.readouterr().out


def test_precision_policies(capsys):
    st = example("precision_policies").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "fitted budgets @99% coverage" in out
    assert set(st["exit_level_hist_by_class"]) == {"exact", "budget(3)",
                                                   "bounded(0)"}


def _calibrate():
    spec = importlib.util.spec_from_file_location(
        "calibrate_levels", ROOT / "tools" / "calibrate_levels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CLASSES = [("exact", None), ("budget", 3), ("bounded", 0.0),
           ("bounded", 0.01)]


def _requests(cls, precision, vocab: int):
    rng = np.random.default_rng(11)
    out = []
    for i, n in enumerate((5, 7, 6, 9, 4, 8)):
        kind, arg = CLASSES[i % len(CLASSES)]
        pc = getattr(precision, kind)() if arg is None \
            else getattr(precision, kind)(arg)
        out.append(cls(uid=i, prompt=rng.integers(0, vocab, (n,)).astype(
            np.int32), max_new_tokens=6, precision=pc))
    return out


def test_calibrate_levels_reads_the_port_histograms(tmp_path):
    """The reference's and the port's batchers serve the same requests in
    mixed classes with early exit; their stats() dumps give the same
    per-class exit histograms, and fit_class_budgets and the tool's CLI
    give the same budgets on either dump."""
    jcfg = dataclasses.replace(j_get_smoke("smollm-135m"),
                               l2r=JQuantConfig())
    jparams = jc.materialize(jt.lm_build(jcfg), jax.random.PRNGKey(0))
    jeng = jb.ContinuousBatcher(jcfg, je.prepare_params(jcfg, jparams),
                                n_slots=3, max_len=32, progressive=True,
                                early_exit=True)
    for r in _requests(jb.Request, JPrecisionClass, jcfg.vocab):
        jeng.submit(r)
    jeng.run(max_steps=200)
    cfg = dataclasses.replace(get_smoke("smollm-135m"), l2r=QuantConfig())
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    eng = ContinuousBatcher(cfg, te.prepare_params(cfg, params), n_slots=3,
                            max_len=32, progressive=True, early_exit=True,
                            device="cpu")
    for r in _requests(Request, PrecisionClass, cfg.vocab):
        eng.submit(r)
    eng.run(max_steps=200)
    want, got = jeng.stats(), eng.stats()
    key = "exit_level_hist_by_class"
    assert {k: np.asarray(v).tolist() for k, v in want[key].items()} == \
        got[key]
    cal = _calibrate()
    for cov in (0.5, 0.9, 0.99):
        assert cal.fit_class_budgets(got[key], cov) == \
            cal.fit_class_budgets(want[key], cov)
    fitted = []
    for name, st in (("port", got), ("ref", want)):
        src, dst = tmp_path / f"{name}.json", tmp_path / f"{name}_out.json"
        src.write_text(json.dumps(st, default=lambda a: np.asarray(a)
                                  .tolist()))
        cal.main([str(src), "--coverage", "0.9", "-o", str(dst)])
        fitted.append(json.loads(dst.read_text()))
    assert fitted[0] == fitted[1] and fitted[0]
