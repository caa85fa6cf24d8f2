// Kernel B3: the D^2 pair-loop MSDF digit-plane GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/l2r_gemm/kernel.py:_l2r_gemm_kernel
// (reached through l2r_gemm_pallas).  On raw int8 operands aq (M, K) and
// bq (K, N) it computes
//
//     C (M, N) int32 = sum over the plane pairs (i, j) of msdf_pairs(D, levels)
//                      of  (A_i << b*i) @ (B_j << b*j),
//
// which equals the reference's sum of (A_i @ B_j) << b*(i+j) modulo 2^32.
// `levels` truncation is a shorter pair list.
//
// Design, against the TPU original:
//  * The TPU kernel extracts the D digit planes of each (bm, bk) tile into
//    int32 VMEM workspaces (`_plane`: shift and mask, the top plane signed by
//    an arithmetic shift) and runs one MXU pass per pair, shifting each term.
//    Here the raw tiles are staged in shared memory once per 64-deep chunk,
//    and each fragment register is masked per pair in registers: a
//    pre-shifted plane is a bit-field of the int8 operand (plane i < D-1
//    keeps bits [b*i, b*(i+1)); the top plane keeps bits b*(D-1) and up,
//    sign extension included, which is the arithmetic shift's plane scaled
//    back).  It fits int8 for n_bits <= 8, so each pair is one s8 mma whose
//    product lands at its final weight: no shifts (mode kPairs of the
//    level-walk template in l2r_walk.cuh, a one-slab table over K).
//  * Ragged M, N and K (K = 3 included) are masked in the loaders; no TPU
//    padding.  Split-K with int32 atomics at small M, as B1.
//  * Bound on this card (H100 SXM data sheet: int8 1,979 TOP/s dense, HBM
//    3.35 TB/s): the same tensor operations as B1, 2*M*N*K*D^2, over raw
//    int8 bytes (M*K + K*N read, M*N*4 written): D times fewer operand bytes
//    than B1, so it is operation bound on every VGG-16 shape but the smallest.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include "l2r_walk.cuh"

// C (m, n) int32 += the pair loop over a (m, k) and b (k, n) raw int8, with
// d = n_planes digit planes of log2_radix bits; pair p is (pi[p], pj[p]).
// C must be zeroed.  Returns a cudaError_t as int: 0 when accepted.
extern "C" int l2r_pairs_gemm(const void* a, const void* b, void* c, int m,
                              int n, int k, int n_planes, int log2_radix,
                              int n_pairs, const int* pi, const int* pj,
                              void* stream) {
  if (m < 1 || n < 1 || k < 1 || n_planes < 1 || n_planes > 8 ||
      log2_radix < 1 || n_planes * log2_radix > 8 || n_pairs < 1 ||
      n_pairs > l2r::kMaxPairs)
    return (int)cudaErrorInvalidValue;
  l2r::Walk w = {};
  w.lt.n = 1;  // one slab: the raw operands' K
  w.lt.len[0] = k;
  if (!l2r::finish_table(w.lt)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_planes; ++i) {
    const uint32_t byte = i < n_planes - 1
        ? ((1u << log2_radix) - 1u) << (log2_radix * i)
        : 0xFFu & ~((1u << (log2_radix * i)) - 1u);  // signed top bit-field
    w.mask[i] = byte * 0x01010101u;
  }
  w.n_pairs = n_pairs;
  for (int p = 0; p < n_pairs; ++p) {
    if (pi[p] < 0 || pi[p] >= n_planes || pj[p] < 0 || pj[p] >= n_planes)
      return (int)cudaErrorInvalidValue;
    w.pi[p] = (uint8_t)pi[p];
    w.pj[p] = (uint8_t)pj[p];
  }
  return (int)l2r::run<l2r::kPairs>(a, b, c, m, n, k, n, w, stream);
}
