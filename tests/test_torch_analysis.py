"""The port's exactness audit, registry and overflow sweep against the
reference's.

* ``overflow.audit_registry`` and the certifier's extremes equal the
  reference's, dict for dict (exact: integers, bools, tuples);
* the registry's entry names map one to one onto the reference's under
  the backend table (``jnp`` -> ``cpu``, ``pallas-interpret`` ->
  ``cuda``), and each entry run on the CPU gives the reference entry's
  result bit for bit on the same numpy operands, the reference run as
  its own tests run it (``jnp``, ``pallas-interpret``);
* every ``cpu`` entry audits clean, and every injected fault is flagged
  (the reference's tests/test_analysis.py:61-133, plus the CPU's
  ``int8 @ int8`` wrap, a bf16 product, TF32 on an f32 product and a
  kernel node whose output is not int32).

Every comparison here is exact.  One intra-op thread.
"""

import numpy as np
import pytest
import torch

from repro.analysis import overflow as ref_overflow
from repro.analysis.registry import iter_entries as ref_iter_entries
from repro_torch.analysis import overflow, registry
from repro_torch.analysis.exactness import (ExactnessContract,
                                            audit_exactness)
from repro_torch.core.l2r_gemm import l2r_matmul_int_stacked
from repro_torch.kernels import _build
from repro_torch.sharding.collectives import level_loop


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_name(ref_name: str) -> str:
    parts = ref_name.split("/")
    if len(parts) >= 3 and parts[2] in registry.BACKEND_DEVICES:
        parts[2] = registry.BACKEND_DEVICES[parts[2]]
    return "/".join(parts)


REF = {e.name: e for e in ref_iter_entries()}
PORT = {e.name: e for e in registry.iter_entries()}
RUNNABLE = [n for n, e in REF.items() if e.sharding is None and not e.skip]
CPU_ENTRIES = [n for n, e in PORT.items()
               if e.device == "cpu" and e.sharding is None]


def _np(o):
    if isinstance(o, (tuple, list)):
        return tuple(_np(x) for x in o)
    if isinstance(o, torch.Tensor):
        return o.numpy()
    if o is None or isinstance(o, (int, float)):
        return o
    return np.asarray(o)


def _assert_same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray) and isinstance(got, int):
        assert want.ndim == 0 and got == int(want)  # a level count
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert int(got) == int(want) if want is not None else got is None


# ----------------------------------------------------- overflow sweep
def test_audit_registry_equals_the_reference():
    got, want = overflow.audit_registry(), ref_overflow.audit_registry()
    assert len(got) == len(want) == 20  # 10 archs x (head, attention)
    for g, w in zip(got, want):
        assert g == w
    assert all(r["sound"] for r in got)


@pytest.mark.parametrize("n_bits,log2_radix", [(8, 2), (8, 1), (8, 4),
                                               (4, 2), (16, 4)])
def test_certifier_extremes_equal_the_reference(n_bits, log2_radix):
    got = overflow.per_element_extremes(n_bits, log2_radix)
    want = ref_overflow.per_element_extremes(n_bits, log2_radix)
    assert got.exact == want.exact
    assert got.magnitude() == want.magnitude()
    for lv in range(1, 2 * (n_bits // log2_radix)):
        for k in (1, 7, 64):
            assert overflow.certify(n_bits, log2_radix, k, levels=lv) \
                .to_json() == ref_overflow.certify(
                    n_bits, log2_radix, k, levels=lv).to_json()


def test_certifier_known_extremes():
    cert = overflow.certify(8, 2, 1)
    assert cert.per_element == 16384 and cert.exact
    x, y, _ = cert.witness
    assert x * y == 16384
    prev = None
    for lv in range(1, 8):
        b = overflow.certify(8, 2, 7, levels=lv).bound
        if prev is not None:
            assert b >= prev
        prev = b
    wide = overflow.certify(16, 4, 64)
    assert not wide.exact and not wide.sound
    assert wide.per_element >= \
        overflow.per_element_extremes(8, 4).magnitude()


def test_certificate_bound_is_achievable():
    """Operands achieving the worst case run int32-exact at the bound and
    wrap one contraction element beyond it."""
    cert1 = overflow.certify(8, 2, 1)
    x, y, _ = cert1.witness
    k_max = overflow.INT32_LIMIT // cert1.per_element
    assert k_max == ref_overflow.INT32_LIMIT // \
        ref_overflow.certify(8, 2, 1).per_element
    assert overflow.certify(8, 2, k_max).sound
    assert not overflow.certify(8, 2, k_max + 1).sound

    def run(k):
        aq = torch.full((1, k), x, dtype=torch.int8)
        bq = torch.full((k, 1), y, dtype=torch.int8)
        return int(l2r_matmul_int_stacked(aq, bq, 8, 2)[0, 0]), x * y * k

    got, exact = run(k_max)
    assert got == exact == cert1.per_element * k_max
    got, exact = run(k_max + 1)
    assert got == exact - 2**32


# ----------------------------------------------------------- registry
def test_entry_names_map_one_to_one():
    assert sorted(_port_name(n) for n in REF) == sorted(PORT)
    for name, e in REF.items():
        p = PORT[_port_name(name)]
        assert (p.contract is None) == (e.contract is None)
        assert (p.sharding is None) == (e.sharding is None)
        if e.contract is not None:
            assert (p.contract.n_bits, p.contract.log2_radix, p.contract.k,
                    p.contract.levels, p.contract.mode) == \
                (e.contract.n_bits, e.contract.log2_radix, e.contract.k,
                 e.contract.levels, e.contract.mode)


def test_cuda_and_split_entries_skip_here():
    for e in registry.iter_entries():
        if e.device == "cuda" or e.sharding is not None:
            assert e.skip, e.name
        else:
            assert e.skip is None, e.name


@pytest.mark.parametrize("name", RUNNABLE)
def test_entry_on_the_cpu_is_the_reference_entry(name):
    """The port's entry on CPU tensors (a ``cuda`` entry then runs its
    kernels' plain versions) against the reference entry, bit for bit."""
    fn, args = REF[name].build()
    want = _np(fn(*args))
    pfn, pargs = PORT[_port_name(name)].build(device="cpu")
    got = _np(pfn(*pargs))
    _assert_same(got, want)


@pytest.mark.parametrize("name", CPU_ENTRIES)
def test_cpu_entries_audit_clean(name):
    e = PORT[name]
    fn, args = e.build(device="cpu")
    rep = audit_exactness(fn, args, e.contract, entry=name)
    assert rep.ok, [v.to_json() for v in rep.violations]
    assert rep.tainted_eqns > 0  # the walk was on the taint path
    assert rep.int_dots + rep.f32_fastpath_dots > 0
    assert _build.AUDIT is None


@pytest.mark.parametrize("name", sorted(PORT))
def test_entries_certify_overflow(name):
    c = PORT[name].contract
    if c is None:
        assert PORT[name].sharding is not None  # swept by the sharding pass
        return
    assert overflow.certify(c.n_bits, c.log2_radix, c.k,
                            levels=c.levels).sound


# ------------------------------------------------------ injected faults
def _i8(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -128, 128, shape).astype(np.int8))


def _ops():
    return _i8((4, 8)), _i8((8, 5), 1)


def _reasons(rep) -> str:
    return " | ".join(v.reason for v in rep.violations)


def test_flags_unguarded_f32_product():
    """An f32 product of digits where the guard cannot hold for K."""
    def bad(aq, bq):
        return (aq.to(torch.float32) @ bq.to(torch.float32)).to(torch.int32)

    rep = audit_exactness(bad, _ops(), ExactnessContract(k=10**9))
    assert not rep.ok
    assert "fast path" in _reasons(rep)


def test_flags_float_op_on_exact_path():
    def bad(aq, bq):
        a = aq.to(torch.float32) * 1.0001  # inexact scale mid-path
        return (a @ bq.to(torch.float32)).to(torch.int32)

    rep = audit_exactness(bad, _ops(), ExactnessContract(k=8))
    assert not rep.ok
    assert "inexact op on a guarded f32 fast-path value" in _reasons(rep)


def test_flags_f32_under_a_contract_that_forbids_it():
    def walk(aq, bq):
        return (aq.to(torch.float32) @ bq.to(torch.float32)).to(torch.int32)

    assert audit_exactness(walk, _ops(), ExactnessContract(k=8)).ok
    rep = audit_exactness(walk, _ops(),
                          ExactnessContract(k=8, allow_f32=False))
    assert not rep.ok


def test_flags_int8_matmul_accumulating_in_int8():
    """The CPU hazard: ``int8 @ int8`` returns int8 and wraps."""
    def bad(aq, bq):
        return aq @ bq

    rep = audit_exactness(bad, _ops(), ExactnessContract(k=8))
    assert rep.output.dtype == torch.int8
    assert not rep.ok
    assert "int32 accumulation" in _reasons(rep)

    def good(aq, bq):
        return aq.to(torch.int64) @ bq.to(torch.int64)

    rep = audit_exactness(good, _ops(), ExactnessContract(k=8))
    assert rep.ok and rep.int_dots == 1


def test_flags_bf16_contraction():
    def bad(aq, bq):
        return (aq.to(torch.bfloat16) @ bq.to(torch.bfloat16)).float()

    rep = audit_exactness(bad, _ops(), ExactnessContract(k=8))
    assert not rep.ok
    assert "bf16" in _reasons(rep)


def test_flags_violation_inside_a_level_loop():
    """A violation at one level of a data-dependent Python loop: the
    recorded run follows the loop."""
    def bad(aq, bq):
        acc = torch.zeros((4, 5), dtype=torch.int64)
        t = 0
        with level_loop():
            while int(acc.abs().sum()) < 10**9 and t < 3:
                a = aq.to(torch.float32)
                if t == 2:
                    a = a * 0.5
                acc = acc + (a @ bq.to(torch.float32)).to(torch.int64)
                t += 1
        return acc

    rep = audit_exactness(bad, _ops(), ExactnessContract(k=8))
    assert not rep.ok
    assert rep.f32_fastpath_dots == 2  # levels 0 and 1 were clean


def test_flags_f32_product_with_tf32_allowed():
    def walk(aq, bq):
        return (aq.to(torch.float32) @ bq.to(torch.float32)).to(torch.int32)

    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        rep = audit_exactness(walk, _ops(), ExactnessContract(k=8))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert not rep.ok
    assert "TF32" in _reasons(rep)


def test_flags_kernel_node_without_int32_output():
    """A fake launch through the kernels' hook: the node's accumulator
    must be int32, its operands int8 / int16."""
    def launch(out_dtype):
        def fn(aq, bq):
            out = torch.empty((4, 5), dtype=out_dtype)
            _build.note_launch("fake_gemm", (aq, bq), (out,))
            return out
        return fn

    good = audit_exactness(launch(torch.int32), _ops(),
                           ExactnessContract(k=8, mode="kernel-int"))
    assert good.ok and good.kernel_nodes == {"fake_gemm": 1}
    bad = audit_exactness(launch(torch.int16), _ops(),
                          ExactnessContract(k=8, mode="kernel-int"))
    assert not bad.ok
    assert "not int32" in _reasons(bad)
    assert _build.AUDIT is None


def test_flags_kernel_int_entry_that_ran_no_kernel():
    """A ``kernel-int`` entry must go through a kernel node: on CPU
    tensors the stacked entry runs the plain version and is flagged."""
    e = PORT["gemm/stacked/cuda"]
    fn, args = e.build(device="cpu")
    rep = audit_exactness(fn, args, e.contract)
    assert not rep.ok
    assert "launched no kernel" in _reasons(rep)
