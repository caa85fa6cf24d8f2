// The integer routine of kernel B2's int16 entry (l2r_streaming_gemm16:
// int16 digit planes, n_bits 9-16).  B1's and B3's int16 entries run on the
// tensor cores through the byte split (l2r_gemm16.cuh); this file stays until
// B2's entry moves there too.
//
// It runs on the CUDA cores.  Each product of the walk (one plane pair of a
// level) is
//
//     acc (int32) += (OR of A planes [a_lo, a_hi] & mask_a) . (OR of B planes [b_lo, b_hi] & mask_b)
//
// over the contraction.  A pre-shifted plane is a bit-field of its operand, so
// the OR of a range of planes gives the planes' sum, which fits int16.  The
// multiply-adds run in unsigned 32-bit arithmetic: signed overflow is
// undefined in C++, and the reference's int32 dot (preferred_element_type=
// int32) wraps.  Sums modulo 2^32 do not depend on the order, so every tiling,
// split and order gives the plain version's bits.
//
// The pieces:
//  * stage(): a (rows x BK) tile of an operand, planes OR-ed and masked in
//    registers, sign-extended to int32 and stored k-major in shared memory
//    (row r of contraction step k at S[k * pitch + r]).  Rows whose 16-byte
//    pieces are aligned are read 16 bytes a thread, any other element by
//    element.
//  * mac(): a thread's TM x TN register tile of acc over BK staged steps: TM
//    + TN shared loads, TM * TN multiply-adds a step.
//  * stream16_kernel / run(): the walk over a product list, each product a
//    pass over the block's contraction; a product may flush the running sum to
//    an output plane (the level prefixes).  Where the output tiles leave SMs
//    idle (the FC layers at batch 8) the contraction is split over blocks
//    that add with atomics.
// Bound on this card (H100 SXM data sheet: int8 1,979 TOP/s, HBM 3.35 TB/s):
// an int16 product is four int8 products on the tensor cores (the byte
// split), so the least time is 4 x the int8 operations at the int8 peak or the
// bytes, whichever is larger.  This route does one 32-bit multiply-add an
// int16 product on the CUDA cores (64 a clock and SM).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "l2r_mma.cuh"

namespace l2r16 {

constexpr int kMaxProducts = 256;  // D^2 plane pairs for D <= 16

// One operand: element (row r, contraction index k) of plane i at
// p[plane0 + i * plane_step + r * s_row + k]; rows >= n_rows and k >= n_k
// read as 0.  vec: every row's 16-byte pieces aligned.
struct Operand {
  const int16_t* p;
  long long s_row, plane0, plane_step;
  int n_rows, n_k;
  int vec;
};

// A product of the walk: A planes [a_lo, a_hi] under mask ma, B planes
// [b_lo, b_hi] under mask mb (bits of the raw operand); level: its MSDF level
// (the walk ends at the device-side level count); flush: the running sum is
// written to output plane `level` after it.
struct Product {
  uint8_t a_lo, a_hi, b_lo, b_hi;
  uint16_t ma, mb;
  uint8_t level, flush;
};

struct Walk {
  int n;
  Product p[kMaxProducts];
};

// S[k * pitch + r] = the operand's planes [lo, hi] & mask at (row r0 + r,
// contraction k0 + k) as int32, for r < R and k < BK
template <int R, int BK, int THREADS>
__device__ __forceinline__ void stage(int32_t* S, int pitch, const Operand& op,
                                      int r0, int k0, int lo, int hi,
                                      uint32_t mask) {
  constexpr int E = 8;  // elements of a 16-byte piece
  static_assert(BK % E == 0, "a staged row is whole 16-byte pieces");
  if (op.vec) {
    constexpr int PR = BK / E;  // pieces a row
    const uint32_t m = mask * 0x00010001u;
    for (int v = threadIdx.x; v < R * PR; v += THREADS) {
      const int r = v / PR, c = (v % PR) * E;
      const int row = r0 + r, k = k0 + c;
      uint32_t w[4] = {0, 0, 0, 0};
      if (row < op.n_rows && k < op.n_k) {  // n_k is whole pieces here
        const int16_t* base = op.p + op.plane0 + row * op.s_row + k;
        for (int i = lo; i <= hi; ++i) {
          const uint4 x =
              __ldg(reinterpret_cast<const uint4*>(base + i * op.plane_step));
          w[0] |= x.x;
          w[1] |= x.y;
          w[2] |= x.z;
          w[3] |= x.w;
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        S[(c + e) * pitch + r] =
            (int)(int16_t)(uint16_t)((w[e / 2] & m) >> (e % 2 * 16));
    }
  } else {
    for (int v = threadIdx.x; v < R * BK; v += THREADS) {
      const int r = v / BK, c = v % BK;
      const int row = r0 + r, k = k0 + c;
      uint32_t x = 0;
      if (row < op.n_rows && k < op.n_k) {
        const int16_t* base = op.p + op.plane0 + row * op.s_row + k;
        for (int i = lo; i <= hi; ++i) x |= (uint16_t)base[i * op.plane_step];
      }
      S[c * pitch + r] = (int)(int16_t)(uint16_t)(x & mask);
    }
  }
}

// acc[i][j] += sum over the BK staged steps of A row i . B row j, unsigned
// (wrapping); As and Bs point at this thread's first row of each, k-major
template <int TM, int TN, int BK>
__device__ __forceinline__ void mac(uint32_t (&acc)[TM][TN],
                                    const int32_t* As, int a_pitch,
                                    const int32_t* Bs, int b_pitch) {
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    uint32_t a[TM], b[TN];
    if constexpr (TM % 4 == 0) {
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(As + k * a_pitch + i);
        a[i] = x.x, a[i + 1] = x.y, a[i + 2] = x.z, a[i + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = (uint32_t)As[k * a_pitch + i];
    }
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(Bs + k * b_pitch + j);
      b[j] = x.x, b[j + 1] = x.y, b[j + 2] = x.z, b[j + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
  }
}

constexpr int kBK = 16;  // contraction steps a staged chunk

// The walk over a block's BM x BN tile of C and its share of the
// contraction; THREADS = (BM / TM) * (BN / TN).  A product at or above the
// device-side level count ends the walk.  A flush writes the running
// sum to plane `level` of C: added with atomics where the contraction is
// split, else added to C (add) or stored.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
stream16_kernel(Operand A, Operand B, int32_t* __restrict__ C,
            int M, int N, const Walk w, const int* __restrict__ level_count,
            int n_levels, int add, long long plane, int chunks_per_split) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int AP = BM + 4, BP = BN + 4;  // int32 pitches, 16-byte rows
  __shared__ __align__(16) int32_t As[kBK * AP];
  __shared__ __align__(16) int32_t Bs[kBK * BP];
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int chunks = (A.n_k + kBK - 1) / kBK;
  const int c_lo = blockIdx.z * chunks_per_split;
  const int c_hi = min(chunks, c_lo + chunks_per_split);
  const int count =
      level_count ? max(0, min(n_levels, *level_count)) : INT_MAX;
  const bool split = gridDim.z > 1;

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int p = 0; p < w.n; ++p) {
    const Product pr = w.p[p];
    if (pr.level >= count) break;  // the products come in level order
    for (int c = c_lo; c < c_hi; ++c) {
      stage<BM, kBK, THREADS>(As, AP, A, m0, c * kBK, pr.a_lo, pr.a_hi,
                              pr.ma);
      stage<BN, kBK, THREADS>(Bs, BP, B, n0, c * kBK, pr.b_lo, pr.b_hi,
                              pr.mb);
      __syncthreads();
      mac<TM, TN, kBK>(acc, As + ty * TM, AP, Bs + tx * TN, BP);
      __syncthreads();
    }
    if (!pr.flush) continue;
    int32_t* out = C + pr.level * plane;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty * TM + i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tx * TN + j;
        if (col >= N) continue;
        unsigned* dst = reinterpret_cast<unsigned*>(out + (size_t)row * N + col);
        if (split)
          atomicAdd(dst, acc[i][j]);
        else
          *dst = add ? *dst + acc[i][j] : acc[i][j];
      }
    }
  }
}

inline Operand operand(const void* p, long long s_row, long long plane0,
                       long long plane_step, int n_rows, int n_k) {
  Operand op = {(const int16_t*)p, s_row, plane0, plane_step, n_rows, n_k, 0};
  op.vec = s_row % 8 == 0 && plane0 % 8 == 0 && plane_step % 8 == 0 &&
           n_k % 8 == 0 && (uintptr_t)p % 16 == 0;
  return op;
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch(const Operand& a, const Operand& b,
                   int32_t* c, int m, int n, const Walk& w,
                   const int* level_count, int n_levels, bool add,
                   bool zero_first, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = l2r::sm_count(&sms);
  if (err != cudaSuccess) return err;
  // split the contraction where the tiles fill less than two blocks an SM,
  // at least two chunks a split
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int chunks = (a.n_k + kBK - 1) / kBK;
  const int want = tiles >= 2 * sms ? 1 : (2 * sms + tiles - 1) / tiles;
  const int splits = std::max(1, std::min(want, chunks / 2));
  const int per = (chunks + splits - 1) / splits;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN,
                  std::max(1, (chunks + per - 1) / per));
  const long long plane = (long long)m * n;
  if (grid.z > 1 && zero_first) {  // the blocks add into zeros
    err = cudaMemsetAsync(c, 0, (size_t)plane * n_levels * 4, stream);
    if (err != cudaSuccess) return err;
  }
  stream16_kernel<BM, BN, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      a, b, c, m, n, w, level_count, n_levels, add ? 1 : 0, plane, per);
  return cudaGetLastError();
}

// the tile by shape: 16 x 128 at M <= 16 (the FC layers at small batch),
// 128 x 64 where N <= 64 (conv1_x), else 128 x 128
inline cudaError_t run(const Operand& a, const Operand& b, void* c, int m,
                       int n, const Walk& w, const int* level_count,
                       int n_levels, bool add, bool zero_first,
                       cudaStream_t s) {
  auto* pc = (int32_t*)c;
  if (m <= 16)
    return launch<16, 128, 1, 8>(a, b, pc, m, n, w, level_count, n_levels,
                                 add, zero_first, s);
  if (n <= 64)
    return launch<128, 64, 8, 4>(a, b, pc, m, n, w, level_count, n_levels,
                                 add, zero_first, s);
  return launch<128, 128, 8, 8>(a, b, pc, m, n, w, level_count, n_levels,
                                add, zero_first, s);
}

}  // namespace l2r16
