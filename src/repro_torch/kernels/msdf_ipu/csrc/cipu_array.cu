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
//  * Bound on this card: the operands, 2 x k int32 a SOP read once (at the
//    paper's n = 8, k = 72 that is 576 bytes a SOP), against the integer
//    work below.  The simulated datapath is cheap; what costs is turning
//    operands into bit planes, so the packing is done by each thread on its
//    own operands, in registers, with no warp votes.
//  * Staging: a persistent grid (as many blocks as fit on the card) walks
//    row blocks of 128 PEs; each row block is staged 32 operands deep at a
//    time (one plane word), both operands, through cp.async into a ring of
//    two stages, so the next stage is in flight while this one is packed.
//    Copies are 16 bytes where the rows allow it (k a multiple of 4, the
//    tensors 16-byte aligned; a warp then reads 4 rows x 128 contiguous
//    bytes), else 4 bytes; columns past k are zero-filled.  Shared rows are
//    36 words: each thread's 16-byte reads of its own row hit 8 distinct
//    bank groups across 8 neighbouring rows.  Global indices are 64-bit.
//  * The counter circuit is a population count over bit planes.  A thread
//    packs the low bytes of 8 operands into a 64-bit word (byte r = operand
//    r), transposes that 8x8 bit block in three delta swaps (Hacker's
//    Delight 7-3: masks 0x00AA00AA00AA00AA, 0x0000CCCC0000CCCC,
//    0x00000000F0F0F0F0, shifts 7, 14, 28, as 32-bit halves), so that byte p
//    holds bit p of the 8 operands, and byte-permutes four such blocks into
//    one 32-bit word per plane.  Widths 8 < n <= 15 transpose the second
//    byte too (planes 8..15).  Bits at or above n are never counted.
//    cnt(i, j) is __popc(A_{n-i} & B_{n-j}) summed over the chunks.  The
//    counts depend on the operands only, so all n^2 of them are taken before
//    the cycle loop; the loop then runs the carry-save registers exactly as
//    the hardware clocks them.
//  * The n^2 cycles are unrolled at compile time (one instantiation per n),
//    so the counts and the four registers stay in registers.
//  * The CSA arithmetic is uint32: signed left-shift overflow is undefined in
//    C++, while the reference's int32 << wraps; uint32 wraps the same way.
//  * At n = 8, k = 72 a SOP costs about 600 integer instructions of packing,
//    192 AND/POPC/ADD triples of counting and about 64 x 11 of datapath.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 128;   // PEs a row block: one thread each
constexpr int kChunk = 32;   // operands of a row a stage: one plane word
constexpr int kPitch = 36;   // words a shared row (16-byte rows, 9 units)
constexpr int kStages = 2;   // the cp.async ring
constexpr int kStageWords = 2 * kRows * kPitch;  // a's rows, then b's
constexpr int kSmemBytes = kStages * kStageWords * 4;
constexpr int kMaxBits = 15;  // 2n + 1 <= 31: the widest int32 SOP at k = 1

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Columns [col0, col0 + ncols) of rows [row0, row0 + kRows) of a and b into
// the stage st (row r of a at st + r * kPitch, of b kRows rows later); ncols
// is a multiple of 8 (whole groups), zeros past m and k.
__device__ __forceinline__ void stage(uint32_t* st, const int32_t* a,
                                      const int32_t* b, long long m, int k,
                                      long long row0, int col0, int ncols,
                                      bool vec) {
  if (vec) {  // 16-byte pieces: 8 a row
    for (int e = threadIdx.x; e < kRows * 8; e += kRows) {
      const int r = e >> 3, c = (e & 7) * 4;
      if (c >= ncols) continue;
      const long long row = row0 + r;
      const bool ok = row < m && col0 + c < k;
      const size_t off = ok ? (size_t)row * k + col0 + c : 0;
      cp_async16(st + r * kPitch + c, a + off, ok);
      cp_async16(st + (kRows + r) * kPitch + c, b + off, ok);
    }
  } else {  // 4-byte pieces
    for (int e = threadIdx.x; e < kRows * kChunk; e += kRows) {
      const int r = e >> 5, c = e & 31;
      if (c >= ncols) continue;
      const long long row = row0 + r;
      const bool ok = row < m && col0 + c < k;
      const size_t off = ok ? (size_t)row * k + col0 + c : 0;
      cp_async4(st + r * kPitch + c, a + off, ok);
      cp_async4(st + (kRows + r) * kPitch + c, b + off, ok);
    }
  }
}

// byte `byte` of 4 operands, operand i in byte i
__device__ __forceinline__ uint32_t bytes4(uint4 x, int byte) {
  const uint32_t sel = byte ? 0x0051u : 0x0040u;
  return __byte_perm(__byte_perm(x.x, x.y, sel), __byte_perm(x.z, x.w, sel),
                     0x5410u);
}

// The 8x8 bit block hi:lo (byte r = operand r) transposed in place: byte p
// then holds bit p of the 8 operands (bit r from operand r).
__device__ __forceinline__ void transpose8(uint32_t& lo, uint32_t& hi) {
  uint32_t t;
  t = (lo ^ (lo >> 7)) & 0x00AA00AAu;
  lo ^= t ^ (t << 7);
  t = (hi ^ (hi >> 7)) & 0x00AA00AAu;
  hi ^= t ^ (t << 7);
  t = (lo ^ (lo >> 14)) & 0x0000CCCCu;
  lo ^= t ^ (t << 14);
  t = (hi ^ (hi >> 14)) & 0x0000CCCCu;
  hi ^= t ^ (t << 14);
  t = (lo ^ (hi << 4)) & 0xF0F0F0F0u;
  lo ^= t;
  hi ^= t >> 4;
}

// bytes p and q (sel 0x5140: p, q = 0, 1; 0x7362: 2, 3) of the four blocks'
// words x[0..3] as two plane words, block g in byte g
__device__ __forceinline__ void gather(const uint32_t (&x)[4], uint32_t sel,
                                       uint32_t& pp, uint32_t& pq) {
  const uint32_t u = __byte_perm(x[0], x[1], sel);
  const uint32_t v = __byte_perm(x[2], x[3], sel);
  pp = __byte_perm(u, v, 0x5410u);
  pq = __byte_perm(u, v, 0x7632u);
}

// pl[p]: bit p of the chunk's operands row[0..32), operand 8g + r in bit
// 8g + r; `groups` groups of 8 operands are in play, the rest count as zero.
template <int N>
__device__ __forceinline__ void planes(const uint32_t* row, int groups,
                                       uint32_t (&pl)[N]) {
  constexpr int kBytes = N > 8 ? 2 : 1;  // operand bytes that hold bits < n
  uint32_t lo[kBytes][4], hi[kBytes][4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int y = 0; y < kBytes; ++y) lo[y][g] = hi[y][g] = 0u;
    if (g < groups) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * g);
      const uint4 w = *reinterpret_cast<const uint4*>(row + 8 * g + 4);
#pragma unroll
      for (int y = 0; y < kBytes; ++y) {
        lo[y][g] = bytes4(u, y);
        hi[y][g] = bytes4(w, y);
        transpose8(lo[y][g], hi[y][g]);
      }
    }
  }
  uint32_t all[8 * kBytes];
#pragma unroll
  for (int y = 0; y < kBytes; ++y) {
    gather(lo[y], 0x5140u, all[8 * y + 0], all[8 * y + 1]);
    gather(lo[y], 0x7362u, all[8 * y + 2], all[8 * y + 3]);
    gather(hi[y], 0x5140u, all[8 * y + 4], all[8 * y + 5]);
    gather(hi[y], 0x7362u, all[8 * y + 6], all[8 * y + 7]);
  }
#pragma unroll
  for (int p = 0; p < N; ++p) pl[p] = all[p];
}

__device__ __forceinline__ void csa(uint32_t x, uint32_t y, uint32_t z,
                                    uint32_t& s, uint32_t& c) {
  s = x ^ y ^ z;
  c = ((x & y) | (x & z) | (y & z)) << 1;
}

template <int N>
__global__ void __launch_bounds__(kRows, 3)
    cipu_array_kernel(const int32_t* __restrict__ a,
                      const int32_t* __restrict__ b,
                      int32_t* __restrict__ out, long long m, int k, int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int chunks = k > 0 ? (k + kChunk - 1) / kChunk : 1;
  const long long row_blocks = (m + kRows - 1) / kRows;
  // the (row block, chunk) packed now and the one prefetched next
  long long rb = blockIdx.x, next_rb = rb;
  int c = 0, next_c = 0;
  auto prefetch = [&](int slot) {
    const int col0 = next_c * kChunk;
    const int ncols = min(kChunk, (k - col0 + 7) / 8 * 8);
    stage(smem + slot * kStageWords, a, b, m, k, next_rb * kRows, col0, ncols,
          vec);
    if (++next_c == chunks) {
      next_c = 0;
      next_rb += gridDim.x;
    }
  };

  prefetch(0);
  cp_async_commit();
  uint32_t cnt[N * N];
  for (int slot = 0; rb < row_blocks; slot ^= 1) {
    if (next_rb < row_blocks) prefetch(slot ^ 1);  // in flight meanwhile
    cp_async_commit();
    cp_async_wait<1>();  // everything but the copies just started
    __syncthreads();

    if (c == 0) {
#pragma unroll
      for (int t = 0; t < N * N; ++t) cnt[t] = 0u;
    }
    const int groups = (min(kChunk, k - c * kChunk) + 7) / 8;
    const uint32_t* ra = smem + slot * kStageWords + threadIdx.x * kPitch;
    uint32_t pa[N], pb[N];
    planes<N>(ra, groups, pa);
    planes<N>(ra + kRows * kPitch, groups, pb);
    // counter circuit of cycle (i, j): bit n-1-i of a against bit n-1-j of b
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        cnt[i * N + j] += __popc(pa[N - 1 - i] & pb[N - 1 - j]);

    if (++c == chunks) {  // the row block's counts are complete: clock it
      uint32_t ppr_s = 0u, ppr_c = 0u, res_s = 0u, res_c = 0u;
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const bool wrap = j == N - 1;  // last weight bit of this row
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
      const long long row = rb * kRows + threadIdx.x;
      if (row < m) out[row] = (int32_t)(res_s + res_c);
      c = 0;
      rb += gridDim.x;
    }
    __syncthreads();  // this slot is refilled by the next prefetch
  }
  cp_async_wait<0>();
}

template <int N>
cudaError_t launch_n(const void* a, const void* b, void* out, long long m,
                     int k, cudaStream_t stream) {
  static int set_on = -1, per_sm = 0, sms = 0;  // for the card set_on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != set_on) {
    err = cudaFuncSetAttribute(cipu_array_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cipu_array_kernel<N>, kRows, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    set_on = dev;
  }
  const long long row_blocks = (m + kRows - 1) / kRows;
  const long long grid = row_blocks < (long long)per_sm * sms
                             ? row_blocks
                             : (long long)per_sm * sms;
  const bool vec = k % 4 == 0 && ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
  cipu_array_kernel<N><<<(unsigned)grid, kRows, kSmemBytes, stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, m, k, vec);
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
  if (m < 1 || k < 0 || n_bits < 1 || n_bits > kMaxBits)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(n_bits, a, b, out, m, k, (cudaStream_t)stream);
}
