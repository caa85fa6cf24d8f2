// Kernel B6: register-level simulation of an array of composite inner-product
// units (the paper's Fig. 1 datapath) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/msdf_ipu/kernel.py:_kernel (reached
// through cipu_array_pallas).  Each PE m streams one SOP of k products of
// unsigned n-bit operands a[m, :], b[m, :] through n^2 cycles.  Cycle (i, j),
// i the activation bit and j the weight bit, both MSB first:
//
//   cnt       = sum_k bit_{n-i}(a_k) & bit_{n-j}(b_k)          (counter circuit)
//   (s, c)    = 6:2 compressor (four 3:2 CSAs) of
//               ppr_s << 1, ppr_c << 1, cnt, and on the wrap cycle (j == n)
//               res_s << 1, res_c << 1
//   j <  n:     (ppr_s, ppr_c) = (s, c)
//   j == n:     (res_s, res_c) = (s, c), the PPR pair resets to zero
//
// and out[m] = res_s + res_c, the exact SOP (bit-identical to core/ipu.py).
//
// Design, against the TPU original:
//  * One thread per PE, as on the TPU one vector lane per PE; no padding of M
//    to a block multiple: the ragged end is masked.
//  * The counter circuit is a population count.  Per 32-deep chunk of k each
//    warp packs, for each of the n bit positions, the chunk's 32 operand bits
//    of each of its 32 PEs into one word: lane t loads column t of a row
//    (coalesced) and __ballot_sync gathers bit p of the 32 columns; the row's
//    own lane keeps the word.  cnt(i, j) is then __popc(A_{n-i} & B_{n-j})
//    summed over the chunks.  The counts depend on the operands only, so all
//    n^2 of them are taken before the cycle loop; the loop then runs the
//    carry-save registers exactly as the hardware clocks them.
//  * The n^2 cycles are unrolled at compile time (one instantiation per n),
//    so the counts and the four registers stay in registers.
//  * The CSA arithmetic is uint32: signed left-shift overflow is undefined in
//    C++, while the reference's int32 << wraps; uint32 wraps the same way.
//  * Operands are int32, the reference's interface.  At the paper's n = 8,
//    k = 72 they are read once (2 x 288 bytes per SOP) and each of the 64
//    cycles needs its counter (ceil(k/32) AND, popc and add) and 4 CSAs
//    (8 integer ops each).
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // PEs per block: four warps
constexpr int kMaxBits = 15;   // 2n + 1 <= 31: the widest int32 SOP at k = 1

__device__ __forceinline__ void csa(uint32_t x, uint32_t y, uint32_t z,
                                    uint32_t& s, uint32_t& c) {
  s = x ^ y ^ z;
  c = ((x & y) | (x & z) | (y & z)) << 1;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    cipu_array_kernel(const int32_t* __restrict__ a,
                      const int32_t* __restrict__ b,
                      int32_t* __restrict__ out, long long m, int k) {
  const int lane = threadIdx.x & 31;
  const long long row0 = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31);
  const long long row = row0 + lane;

  uint32_t cnt[N * N];
#pragma unroll
  for (int t = 0; t < N * N; ++t) cnt[t] = 0u;

  for (int k0 = 0; k0 < k; k0 += 32) {
    const int col = k0 + lane;
    uint32_t pa[N], pb[N];  // pa[p]: bit p of this PE's 32 chunk operands
#pragma unroll
    for (int p = 0; p < N; ++p) pa[p] = pb[p] = 0u;
    for (int r = 0; r < 32; ++r) {  // the warp's PEs, one row at a time
      const long long gr = row0 + r;
      uint32_t va = 0u, vb = 0u;
      if (gr < m && col < k) {  // absent rows and columns count as zeros
        va = (uint32_t)a[gr * k + col];
        vb = (uint32_t)b[gr * k + col];
      }
#pragma unroll
      for (int p = 0; p < N; ++p) {
        const uint32_t wa = __ballot_sync(0xffffffffu, (va >> p) & 1u);
        const uint32_t wb = __ballot_sync(0xffffffffu, (vb >> p) & 1u);
        pa[p] = lane == r ? wa : pa[p];
        pb[p] = lane == r ? wb : pb[p];
      }
    }
    // counter circuit of cycle (i, j): bit n-1-i of a against bit n-1-j of b
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        cnt[i * N + j] += __popc(pa[N - 1 - i] & pb[N - 1 - j]);
  }

  uint32_t ppr_s = 0u, ppr_c = 0u, res_s = 0u, res_c = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool wrap = j == N - 1;  // last weight bit of this activation row
      const uint32_t x3 = wrap ? res_s << 1 : 0u;
      const uint32_t x4 = wrap ? res_c << 1 : 0u;
      uint32_t s0, c0, s1, c1, s2, c2, s3, c3;
      csa(ppr_s << 1, ppr_c << 1, cnt[i * N + j], s0, c0);
      csa(x3, x4, 0u, s1, c1);
      csa(s0, c0, s1, s2, c2);
      csa(s2, c1, c2, s3, c3);
      if (wrap) {
        res_s = s3;
        res_c = c3;
        ppr_s = ppr_c = 0u;
      } else {
        ppr_s = s3;
        ppr_c = c3;
      }
    }
  }
  if (row < m) out[row] = (int32_t)(res_s + res_c);
}

template <int N>
cudaError_t launch_n(const void* a, const void* b, void* out, long long m,
                     int k, cudaStream_t stream) {
  const long long blocks = (m + kThreads - 1) / kThreads;
  cipu_array_kernel<N><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, m, k);
  return cudaGetLastError();
}

template <int N = 1>
cudaError_t dispatch(int n_bits, const void* a, const void* b, void* out,
                     long long m, int k, cudaStream_t stream) {
  if constexpr (N > kMaxBits) {
    return cudaErrorInvalidValue;
  } else {
    if (n_bits == N) return launch_n<N>(a, b, out, m, k, stream);
    return dispatch<N + 1>(n_bits, a, b, out, m, k, stream);
  }
}

}  // namespace

// out (m,) int32 = the simulated SOPs of the int32 a, b (m, k) row-major.
// Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int cipu_array(const void* a, const void* b, void* out, long long m,
                          int k, int n_bits, void* stream) {
  if (m < 1 || k < 0 || n_bits < 1 || n_bits > kMaxBits ||
      (m + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(n_bits, a, b, out, m, k, (cudaStream_t)stream);
}
