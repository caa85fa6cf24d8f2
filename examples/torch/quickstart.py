"""Quickstart: the L2R composite inner-product unit in five acts, on the
PyTorch port.

    python examples/torch/quickstart.py [--device cuda|cpu]

1. cycle-accurate CIPU simulation (the paper's Fig. 1 datapath), and the
   PE array's exact SOPs (kernel B6 on the card),
2. MSDF digit-plane GEMM == exact integer matmul,
3. progressive precision (online early output) with hard error bounds,
4. the level-stacked GEMM kernel (B1 on the card) against the integer
   oracle ``int_gemm_ref``,
5. the accelerator model reproducing the paper's Tables I/II.

Runs on the card unless ``--device cpu`` (where every kernel wrapper takes
its plain version); raises on a host without CUDA otherwise.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import hw_model  # noqa: E402
from repro_torch.core.cycle_model import network_cycles, peak_gops  # noqa
from repro_torch.core.ipu import simulate_cipu  # noqa: E402
from repro_torch.core.l2r_gemm import l2r_matmul_int  # noqa: E402
from repro_torch.core.progressive import progressive_matmul  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.l2r_gemm.ops import CUDA_WALK, l2r_gemm  # noqa
from repro_torch.kernels.l2r_gemm.ref import int_gemm_ref  # noqa: E402
from repro_torch.kernels.msdf_ipu import simulate_pe_array  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    print("=" * 70)
    print("1) Cycle-accurate composite IPU (k=72 products, n=8 bits)")
    a = rng.integers(0, 256, (1, 72))
    b = rng.integers(0, 256, (1, 72))
    ta = torch.as_tensor(a, dtype=torch.int32, device=dev)
    tb = torch.as_tensor(b, dtype=torch.int32, device=dev)
    trace = simulate_cipu(ta, tb, 8)
    print(f"   exact SOP     : {int((a * b).sum())}")
    print(f"   CIPU result   : {int(trace.final[0])}  (64 cycles, carry-free)")
    sb = trace.stable_bits[0].cpu().numpy()
    print(f"   stable MSBs over cycles 1,8,16,32,64: "
          f"{[int(sb[i - 1]) for i in (1, 8, 16, 32, 64)]}  <- online output")
    pe = simulate_pe_array(ta, tb, 8)
    print(f"   PE array (kernel B6 on the card): {int(pe[0])}")
    assert int(trace.final[0]) == int(pe[0]) == int((a * b).sum())

    print("=" * 70)
    print("2) MSDF digit-plane GEMM (radix-4) == integer matmul, bit-exact")
    A = rng.integers(-128, 128, (64, 128), dtype=np.int8)
    B = rng.integers(-128, 128, (128, 32), dtype=np.int8)
    exact = np.asarray(A, np.int64) @ np.asarray(B, np.int64)
    tA, tB = torch.from_numpy(A).to(dev), torch.from_numpy(B).to(dev)
    out = l2r_matmul_int(tA, tB).cpu().numpy().astype(np.int64)
    print(f"   max |err| = {np.abs(out - exact).max()} (must be 0)")
    assert np.abs(out - exact).max() == 0

    print("=" * 70)
    print("3) Progressive precision: error vs MSDF levels (bound always holds)")
    res = progressive_matmul(tA, tB, cuda_walk=CUDA_WALK)
    for lv in range(res.partial.shape[0]):
        err = np.abs(res.partial[lv].cpu().numpy().astype(np.int64)
                     - exact).max()
        bound = int(res.tail_bound[lv])
        print(f"   level {lv + 1}/7: max err {err:>8d}   bound {bound:>9d}")
        assert err <= bound

    print("=" * 70)
    print(f"4) Level-stacked GEMM ({'kernel B1' if dev.type == 'cuda' else 'its plain version'}"
          f" on {dev}), bit-exact vs the integer oracle")
    Ap = rng.integers(-128, 128, (128, 256), dtype=np.int8)
    Bp = rng.integers(-128, 128, (256, 128), dtype=np.int8)
    kout = l2r_gemm(torch.from_numpy(Ap).to(dev), torch.from_numpy(Bp).to(dev))
    kref = int_gemm_ref(torch.from_numpy(Ap), torch.from_numpy(Bp))
    same = bool(torch.equal(kout.cpu(), kref))
    print(f"   kernel == oracle: {same}")
    assert same

    print("=" * 70)
    print("5) Accelerator model vs the paper")
    print(f"   peak GOPS   : L2R {peak_gops():.2f} (paper 48.97) | "
          f"baseline {peak_gops(l2r=False):.2f} (paper 14.40)")
    print(f"   VGG-16 speedup: "
          f"{network_cycles(l2r=False) / network_cycles():.2f}x "
          f"(paper 3.40x)")
    t2 = hw_model.table2()
    print(f"   TOPS/W      : {t2['l2r_cipu']['tops_w']:.2f} (paper 1.20) | "
          f"GOPS/mm^2 {t2['l2r_cipu']['gops_mm2']:.1f} (paper 200.45)")


if __name__ == "__main__":
    main()
