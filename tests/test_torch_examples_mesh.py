"""The port's examples (examples/torch/), part 3: serve_decode, whose
last act serves progressively on a 2 x 2 mesh of four gloo ranks
(launch/mesh.py:spawn_local) with every rank's stats equal to one
process's, on the CPU (``--device cpu``)."""

from test_torch_examples_core import example
from test_torch_train import _one_torch_thread  # noqa: F401


def test_serve_decode(capsys):
    example("serve_decode").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "token agreement" in out
    assert "sharded(2x2) == single process" in out
