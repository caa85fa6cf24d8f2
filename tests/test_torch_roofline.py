"""launch/roofline.py against the reference's roofline accounting.

``model_flops`` over the port's Param trees equals the reference's for
all ten configs and the three kinds; ``attn_decode_step_bytes`` gives
the reference's byte counts (the spec of tests/test_l2r_attention.py:
test_attn_decode_bytes_accounting, ported), its ``memory_s`` at the
H100's HBM rate; the roofline terms take the H100 data sheet's rates,
which are the only copy of the card's constants (chip_smoke.py and
analysis/collective_cost.py read them from here).
"""

import importlib.util
from pathlib import Path

import pytest

from repro.configs import get_config as j_get_config
from repro.launch import roofline as jr
from repro.models.encdec import encdec_build as j_encdec_build
from repro.models.transformer import lm_build as j_lm_build
from repro_torch.analysis import collective_cost
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import roofline as rl
from repro_torch.sharding.axes import _desc

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_are_the_reference(arch, kind):
    jcfg = j_get_config(arch)
    jdesc = j_encdec_build(jcfg) if jcfg.family == "encdec" \
        else j_lm_build(jcfg)
    cfg = get_config(arch)
    n = 4096 * 256 if kind != "decode" else 128
    assert rl.model_flops(cfg, _desc(cfg, None), n, kind) == \
        jr.model_flops(jcfg, jdesc, n, kind)


CASES = [(4, 512, 4, 64, 8, 2, 2, None), (4, 512, 4, 64, 8, 2, 2, 2),
         (1, 300, 3, 128, 8, 1, 4, 0), (2, 64, 1, 256, 16, 2, 2, 5),
         (8, 2080, 3, 64, 8, 2, 4, 7)]


@pytest.mark.parametrize("case", CASES)
def test_attn_decode_bytes_are_the_reference(case):
    b, length, kvh, dh, n_bits, log2_radix, kv_bytes, levels = case
    kw = dict(n_bits=n_bits, log2_radix=log2_radix, kv_dtype_bytes=kv_bytes,
              levels=levels)
    got = rl.attn_decode_step_bytes(b, length, kvh, dh, **kw)
    want = jr.attn_decode_step_bytes(b, length, kvh, dh, **kw)
    for mode, m in got["modes"].items():
        for k in ("k_bytes", "v_bytes", "scale_bytes", "total_bytes"):
            assert m[k] == want["modes"][mode][k], (mode, k)
        assert m["memory_s"] == m["total_bytes"] / rl.HBM_BYTES_PER_S
    for k in want:
        if k != "modes":
            assert got[k] == want[k], k


def test_attn_decode_bytes_accounting():
    """tests/test_l2r_attention.py's spec on the port: re-extraction moves
    the float path's bytes, the plane cache trades a widened K read for
    the float K, a truncated walk touches the union of its windows."""
    b, length, kvh, dh = 4, 512, 4, 64
    acct = rl.attn_decode_step_bytes(b, length, kvh, dh, n_bits=8,
                                     log2_radix=2, kv_dtype_bytes=2)
    m = acct["modes"]
    slots = b * length * kvh
    assert m["float"]["total_bytes"] == 2 * slots * dh * 2
    assert m["quant_reextract"]["total_bytes"] == m["float"]["total_bytes"]
    assert m["plane_cache"]["k_bytes"] == slots * 7 * dh
    assert m["plane_cache"]["scale_bytes"] == slots * 4
    assert acct["plane_blocks_touched"] == 7
    assert (m["plane_cache_truncated"]["total_bytes"]
            == m["plane_cache"]["total_bytes"])
    trunc = rl.attn_decode_step_bytes(b, length, kvh, dh, n_bits=8,
                                      log2_radix=2, kv_dtype_bytes=2,
                                      levels=2)
    assert trunc["plane_blocks_touched"] == 5
    assert (trunc["modes"]["plane_cache_truncated"]["k_bytes"]
            == slots * 5 * dh)
    assert trunc["truncated_vs_plane_cache"] < 1.0


def test_roofline_terms_take_the_h100_rates():
    r = rl.roofline_terms(2e12, 6.7e10, 9e8, 4)
    assert r.compute_s == 2e12 / 989e12
    assert r.memory_s == 6.7e10 / 3.35e12
    assert r.collective_s == 9e8 / 450e9
    assert r.dominant == "memory" and r.bound_s == r.memory_s
    d = r.asdict()
    assert set(d) == {"compute_s", "memory_s", "collective_s", "flops",
                      "bytes_hbm", "wire_bytes", "chips", "dominant",
                      "bound_s"}
    assert rl.roofline_terms(2e15, 0, 0, 1, "int8").compute_s == \
        2e15 / 1979e12
    assert rl.PEAKS == {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12,
                        "f32": 67e12}
    # never the reference's TPU v5e figures
    assert rl.PEAK_BF16_FLOPS != jr.PEAK_FLOPS
    assert rl.HBM_BYTES_PER_S != jr.HBM_BW


def test_the_card_constants_have_one_home():
    assert collective_cost.NVLINK_BYTES_PER_S is rl.NVLINK_BYTES_PER_S
    spec = importlib.util.spec_from_file_location("chip_smoke_consts",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.PEAK_INT8_OPS is rl.PEAK_INT8_OPS
    assert smoke.PEAK_BYTES is rl.HBM_BYTES_PER_S
    assert smoke.PEAK_BF16_FLOPS is rl.PEAK_BF16_FLOPS
    assert smoke.PEAK_TF32_FLOPS is rl.PEAK_TF32_FLOPS
    # chip_smoke's bounds are the same numbers as before the move
    assert smoke.bound(1979e9, 0) == (1.0, "operations")
    assert smoke.bound(0, 3.35e9) == (1.0, "bytes")
    text = (ROOT / "chip_smoke.py").read_text()
    for literal in ("1979e12", "3.35e12", "989e12", "495e12", "450e9"):
        assert literal not in text, literal
