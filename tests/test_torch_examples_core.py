"""The port's examples (examples/torch/), part 1: the arithmetic,
VGG-16, the progressive walks and the audits, each run on the CPU
(``--device cpu``) in this process, at smoke width where an option
gives one; and every example's default device is the card, so each
raises on a host without CUDA.

Part 2 (serving, training, calibration) is
tests/test_torch_examples_serve.py, part 3 (the mesh act)
tests/test_torch_examples_mesh.py: the files spread over the workers.
"""

import importlib
import sys
from pathlib import Path

import pytest
import torch

from test_torch_train import _one_torch_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"
NAMES = sorted(p.stem for p in EXAMPLES.glob("*.py"))


def example(name: str):
    """``examples/torch/<name>.py`` as a module (its directory on the
    path, so spawned ranks import it too)."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(name)


def test_there_are_the_nine_examples_of_the_reference():
    ref = sorted(p.stem for p in EXAMPLES.parent.glob("*.py"))
    assert NAMES == ref and len(NAMES) == 9


@pytest.mark.parametrize("name", NAMES)
def test_example_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        example(name).main([])


def test_quickstart(capsys):
    example("quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "max |err| = 0" in out and "kernel == oracle: True" in out
    assert "level 7/7: max err        0" in out


def test_vgg16_inference(capsys):
    example("vgg16_inference").main(["--device", "cpu", "--size", "32",
                                     "--batch", "1", "--width-div", "8"])
    out = capsys.readouterr().out
    assert "rel err vs float" in out and "paper: 3.40x" in out


def test_progressive_precision(capsys):
    example("progressive_precision").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "== full-precision greedy" in out and "saved" in out


def test_progressive_attention(capsys):
    example("progressive_attention").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "6 attention calls recorded" in out
    assert "bit-identical: True" in out


def test_exactness_audit(capsys):
    example("exactness_audit").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "gemm/stacked/cpu: ok=True" in out
    assert "CAUGHT mm: bf16/f16 contraction" in out
    assert "CAUGHT psum: float add all-reduce" in out
    assert "all audits behaved as expected" in out
