"""The port's spec batches against the reference's.

``configs/registry.py:input_specs`` and ``data/pipeline.py:
lm_spec_batch`` give a cell's inputs as ``meta`` tensors; the
reference's give ``jax.ShapeDtypeStruct`` s.  For every (arch, shape)
that both registries accept, the keys, shapes and dtypes are equal
(exact: names, tuples, dtype names) and nothing is allocated.
"""

import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.data.pipeline import lm_spec_batch as ref_lm_spec_batch
from repro_torch.configs import registry
from repro_torch.data.pipeline import lm_spec_batch

CELLS = [(a, s) for a in registry.ARCHS for s in registry.SHAPES
         if registry.cell_supported(a, s)[0]]


def _ref_specs(specs: dict) -> dict:
    return {k: (tuple(v.shape), str(np.dtype(v.dtype))) for k, v in
            specs.items()}


def _port_specs(specs: dict) -> dict:
    assert all(v.device.type == "meta" for v in specs.values())
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in specs.items()}


def test_both_registries_accept_the_same_cells():
    assert registry.ARCHS == ref_registry.ARCHS
    assert tuple(registry.SHAPES) == tuple(ref_registry.SHAPES)
    for a in registry.ARCHS:
        for s in registry.SHAPES:
            assert registry.cell_supported(a, s) == \
                ref_registry.cell_supported(a, s)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    got = _port_specs(registry.input_specs(arch, shape))
    want = _ref_specs(ref_registry.input_specs(arch, shape))
    assert list(got) == list(want)
    assert got == want


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-vl-7b",
                                  "whisper-base"])
def test_input_specs_take_a_given_config(arch):
    cfg = registry.get_smoke(arch)
    got = _port_specs(registry.input_specs(arch, "train_4k", cfg))
    want = _ref_specs(ref_registry.input_specs(
        arch, "train_4k", ref_registry.get_smoke(arch)))
    assert got == want


@pytest.mark.parametrize("vocab,seq_len,batch", [(512, 32, 4),
                                                 (49152, 4096, 256)])
def test_lm_spec_batch_equals_the_reference(vocab, seq_len, batch):
    got = lm_spec_batch(vocab, seq_len, batch)
    assert _port_specs(got) == _ref_specs(ref_lm_spec_batch(vocab, seq_len,
                                                            batch))
    assert all(v.is_meta and v.untyped_storage().data_ptr() == 0
               for v in got.values())


def test_spec_tensors_allocate_nothing():
    specs = registry.input_specs("llama4-maverick-400b-a17b", "prefill_32k")
    assert all(v.is_meta for v in specs.values())
    # a meta storage has a size but no memory behind it
    assert all(v.untyped_storage().data_ptr() == 0 for v in specs.values())
    assert specs["tokens"].dtype == torch.int32
