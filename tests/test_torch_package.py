"""The port stands alone and follows the device rule.

* ``repro_torch`` imports neither jax nor any module of ``repro``;
* entry points with no ``device=`` on a host without CUDA raise rather
  than run on the CPU;
* the kernel wrappers (B1-B6) and the entry points above them on a CPU
  tensor take the plain versions and never build a kernel.  (A CUDA tensor cannot be tried on a host without a
  card: tests/test_torch_cuda.py and chip_smoke.py cover that route.)
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import msdf_ipu
from repro_torch.kernels.l2r_gemm import kernel
from repro_torch.core.quant import stack_planes_lhs, stack_planes_rhs

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = ["repro_torch", "repro_torch.device", "repro_torch.core.quant",
                "repro_torch.core.l2r_gemm", "repro_torch.core.policy",
                "repro_torch.core.progressive",
                "repro_torch.analysis.overflow",
                "repro_torch.kernels.l2r_gemm.ops",
                "repro_torch.kernels.l2r_gemm.ref",
                "repro_torch.configs.vgg16_l2r", "repro_torch.models.cnn",
                "repro_torch.models.convert", "repro_torch.models.protohead",
                "repro_torch.core.ipu", "repro_torch.core.hw_model",
                "repro_torch.core.l2r_attention",
                "repro_torch.kernels.msdf_ipu",
                "repro_torch.kernels.msdf_ipu.ops",
                "repro_torch.kernels.msdf_ipu.ref",
                "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.kernels.flash_attention.ref",
                "repro_torch.configs", "repro_torch.configs.registry",
                "repro_torch.models.config", "repro_torch.models.common",
                "repro_torch.models.mlp", "repro_torch.models.attention",
                "repro_torch.models.ssm", "repro_torch.models.rglru",
                "repro_torch.models.moe", "repro_torch.models.encdec",
                "repro_torch.models.transformer", "repro_torch.serve",
                "repro_torch.serve.engine", "repro_torch.launch.serve",
                "repro_torch.serve.batching", "repro_torch.serve.gateway",
                "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
                "repro_torch.checkpoint.quantized", "repro_torch.optim",
                "repro_torch.optim.adamw", "repro_torch.optim.compression",
                "repro_torch.data", "repro_torch.data.pipeline",
                "repro_torch.runtime", "repro_torch.runtime.fault",
                "repro_torch.train", "repro_torch.train.step",
                "repro_torch.launch.train", "repro_torch.sharding",
                "repro_torch.sharding.ctx", "repro_torch.sharding.axes",
                "repro_torch.sharding.collectives",
                "repro_torch.launch.mesh", "repro_torch.launch.roofline",
                "repro_torch.launch.dryrun",
                "repro_torch.launch.graph_analysis",
                "repro_torch.launch.reanalyze"]
EXAMPLES = sorted((ROOT / "examples" / "torch").glob("*.py"))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_neither_jax_nor_repro():
    """Every port module and every example of examples/torch/ (loaded
    by path, as a module: its acts do not run) imports no jax and no
    repro."""
    assert len(EXAMPLES) == 9
    code = ("import sys, importlib.util\n"
            f"for m in {PORT_MODULES!r}: __import__(m)\n"
            f"for f in {[str(f) for f in EXAMPLES]!r}:\n"
            "    spec = importlib.util.spec_from_file_location("
            "'ex_' + f.split('/')[-1][:-3], f)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'repro.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_have_no_jax_or_repro_imports():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", *EXAMPLES]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert len(files) > 10 and not hits, hits


def test_core_imports_no_kernel_module():
    """repro_torch.core holds the plain arithmetic; the kernels' device
    routing lives in repro_torch.kernels, which depends on core and not
    the other way round."""
    code = ("import sys\n"
            "import repro_torch.core.progressive, repro_torch.core.policy\n"
            "bad = sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.kernels'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_without_device_raise_on_a_host_without_cuda(
        monkeypatch):
    import numpy as np

    from repro_torch.models.cnn import (vgg16_apply, vgg16_build,
                                        vgg16_classify_progressive)
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.protohead import prototype_head

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = torch.zeros(1, 32, 32, 3)
    for call in (lambda: vgg16_apply({}, img), lambda: vgg16_build(10),
                 lambda: params_from_jax({}),
                 lambda: vgg16_apply({}, img, device="cuda"),
                 lambda: vgg16_classify_progressive({}, img),
                 lambda: vgg16_classify_progressive({}, img, device="cuda"),
                 lambda: prototype_head(np.random.default_rng(0), 8, 4, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_lm_entry_points_without_device_raise_on_a_host_without_cuda(
        monkeypatch, tmp_path):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import main
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.attention import init_kv_cache
    from repro_torch.models.common import materialize
    from repro_torch.models.convert import lm_params_from_jax
    from repro_torch.models.encdec import init_encdec_state
    from repro_torch.models.rglru import init_rglru_state
    from repro_torch.models.ssm import init_ssm_state
    from repro_torch.models.transformer import init_lm_state, lm_build

    import dataclasses

    from repro_torch.checkpoint import (CheckpointManager, load_prepared,
                                        load_pytree, load_quantized)
    from repro_torch.core.quant import QuantConfig
    from repro_torch.serve import ContinuousBatcher, ServingGateway

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("smollm-135m")
    desc = lm_build(cfg)
    params = materialize(desc, device="cpu")
    l2r = dataclasses.replace(cfg, l2r=QuantConfig())
    mgr = CheckpointManager(str(tmp_path))
    for call in (lambda: materialize(desc), lambda: lm_params_from_jax({}),
                 lambda: materialize(desc, device="cuda"),
                 lambda: init_kv_cache(1, 4, 1, 8),
                 lambda: init_kv_cache(1, 4, 1, 8, device="cuda"),
                 lambda: init_lm_state(cfg, 1, 4),
                 lambda: init_lm_state(cfg, 1, 4, device="cuda"),
                 lambda: init_lm_state(get_smoke("mamba2-130m"), 1, 4),
                 lambda: init_ssm_state(get_smoke("mamba2-130m"), 1),
                 lambda: init_rglru_state(get_smoke("recurrentgemma-2b"), 1),
                 lambda: init_encdec_state(get_smoke("whisper-base"), 1, 4),
                 lambda: init_encdec_state(get_smoke("whisper-base"), 1, 4,
                                           device="cuda"),
                 lambda: main(["--arch", "smollm-135m", "--smoke"]),
                 lambda: main(["--arch", "smollm-135m", "--smoke", "--wq"]),
                 lambda: main(["--arch", "smollm-135m", "--smoke",
                               "--gateway"]),
                 lambda: train_main(["--arch", "smollm-135m", "--smoke"]),
                 lambda: train_main(["--arch", "whisper-base", "--smoke",
                                     "--device", "cuda"]),
                 lambda: ContinuousBatcher(cfg, params),
                 lambda: ContinuousBatcher(cfg, params, device="cuda"),
                 lambda: ServingGateway(cfg, params),
                 lambda: ServingGateway(cfg, params, device="cuda"),
                 lambda: load_pytree(params, str(tmp_path / "p.npz")),
                 lambda: load_quantized(desc, params,
                                        str(tmp_path / "q.npz")),
                 lambda: load_prepared(l2r, params,
                                       str(tmp_path / "r.npz")),
                 lambda: mgr.restore(1, {"params": params})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_chunked_attention_on_cpu_takes_the_plain_loop(monkeypatch):
    """On CPU tensors chunked_attention never reaches kernel B5's wrapper,
    whatever its arguments."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.attention import b5_fits, chunked_attention

    def no_kernel(*a, **k):
        raise AssertionError("B5's wrapper called for a CPU tensor")

    monkeypatch.setattr(ops, "flash_attention_kernel", no_kernel)
    q, k, v = (torch.randn((1, 8, 2, 16)) for _ in range(3))
    assert not b5_fits(q, k, v, None, 0)
    out = chunked_attention(q, k, v)
    assert torch.allclose(out, fa.flash_attention_kernel_plain(q, k, v),
                          atol=1e-6)


def test_wrapper_on_cpu_takes_plain_version_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError(f"tried to build {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "_FNS", {})
    before = dict(kernel.LAUNCHES)
    a = torch.randint(-128, 128, (6, 5), dtype=torch.int8)
    b = torch.randint(-128, 128, (5, 4), dtype=torch.int8)
    sa, sb = stack_planes_lhs(a), stack_planes_rhs(b)
    exact = a.to(torch.int32) @ b.to(torch.int32)
    got = kernel.l2r_gemm_stacked_planes(sa, sb)
    assert torch.equal(got, exact)
    assert torch.equal(kernel.l2r_gemm_streaming_planes(sa, sb)[-1], exact)
    assert torch.equal(kernel.l2r_gemm_pairs(a, b), exact)
    assert kernel.LAUNCHES == before and _build._FNS == {}


def test_slice3_entry_points_on_cpu_take_plain_versions(monkeypatch):
    """simulate_pe_array (B6) and flash_attention / flash_attention_l2r
    (B5, B4) on CPU tensors run the plain versions: no build, no launch."""
    def no_build(name):
        raise AssertionError(f"tried to build {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "_FNS", {})
    before = (dict(msdf_ipu.LAUNCHES), dict(fa.LAUNCHES))
    g = torch.Generator().manual_seed(0)
    a = torch.randint(0, 256, (5, 9), generator=g, dtype=torch.int32)
    b = torch.randint(0, 256, (5, 9), generator=g, dtype=torch.int32)
    assert torch.equal(msdf_ipu.simulate_pe_array(a, b),
                       (a * b).sum(-1, dtype=torch.int32))
    q, k, v = (torch.randn((1, 8, 2, 16), generator=g) for _ in range(3))
    assert torch.equal(fa.flash_attention(q, k, v),
                       fa.flash_attention_kernel_plain(q, k, v))
    assert torch.equal(fa.flash_attention_l2r(q, k, v, levels=3),
                       fa.flash_attention_l2r_plain(q, k, v, levels=3))
    assert (dict(msdf_ipu.LAUNCHES), dict(fa.LAUNCHES)) == before
    assert _build._FNS == {}


def test_build_finds_the_sources_and_builds_into_an_ignored_directory():
    srcs = _build.sources()
    names = [*kernel.LAUNCHES, *msdf_ipu.LAUNCHES, *fa.LAUNCHES]
    assert sorted(names) == sorted(srcs)  # one library per kernel
    for name in names:  # ... and one count each
        assert srcs[name].name == f"{name}.cu"
    assert _build.BUILD_DIR == ROOT / "build" / "repro_torch"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result on a host
    without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: chip_smoke.py would run")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       env=_env(), cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
