// The integer routine of the int16 routes: kernels B1, B2 and B3 on int16
// digit planes (n_bits 9-16), and the QK^T of kernel B4 on int16 q and k (and
// on int8 q and k wider than its tensor-core tile, dh > 128).
//
// The tensor cores take no int16 operand, so this route runs on the CUDA
// cores.  Each product of the MSDF walk (the host's msdf_products, or one plane
// pair of a level for B2) is
//
//     acc (int32) += (OR of A planes [a_lo, a_hi] & mask_a) . (OR of B planes [b_lo, b_hi] & mask_b)
//
// over the contraction.  A pre-shifted plane is a bit-field of its operand and
// a raw operand under plane_bits' mask is a plane range, so the OR of a range of
// planes and the masked raw operand both give the planes' sum, which fits the
// operand's type.  The multiply-adds run in unsigned 32-bit arithmetic: signed
// overflow is undefined in C++, and the reference's int32 dot
// (preferred_element_type=int32) wraps.  Sums modulo 2^32 do not depend on the
// order, so every tiling, split and order gives the plain version's bits.
//
// The pieces:
//  * stage(): a (rows x BK) tile of an operand, planes OR-ed and masked in
//    registers, sign-extended to int32 and stored k-major in shared memory
//    (row r of contraction step k at S[k * pitch + r]).  Rows with a unit
//    stride along the contraction and 16-byte pieces are read 16 bytes a
//    thread; any other layout element by element with the unit-stride axis
//    fastest (B3's row-major weights).
//  * mac(): a thread's TM x TN register tile of acc over BK staged steps: TM
//    + TN shared loads, TM * TN multiply-adds a step.
//  * gemm_kernel / run(): B1, B2 and B3 as one walk over a product list, each
//    product a pass over the block's contraction; a product may flush the
//    running sum to an output plane (B2's level prefixes; B1's and B3's one
//    result).  Where the output tiles leave SMs idle (the FC layers at batch
//    8) the contraction is split over blocks that add with atomics.
// Bound on this card (H100 SXM data sheet: int8 1,979 TOP/s, HBM 3.35 TB/s):
// an int16 product is four int8 products on the tensor cores (the byte
// split), so the least time is 4 x the int8 operations at the int8 peak or the
// bytes, whichever is larger.  This route does one 32-bit multiply-add an
// int16 product on the CUDA cores (64 a clock and SM): simple and right first;
// the byte split on mma.sync is later work.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace l2r16 {

constexpr int kMaxProducts = 256;  // D^2 plane pairs for D <= 16

// One operand: element (row r, contraction index k) of plane i at
// p[plane0 + i * plane_step + r * s_row + k * s_k]; rows >= n_rows and
// k >= n_k read as 0.  vec: s_k == 1 and every row's 16-byte pieces aligned.
template <typename Q>
struct Operand {
  const Q* p;
  long long s_row, s_k, plane0, plane_step;
  int n_rows, n_k;
  int vec;
};

// A product of the walk: A planes [a_lo, a_hi] under mask ma, B planes
// [b_lo, b_hi] under mask mb (bits of the raw operand); level: its MSDF level
// (B2 skips the levels at or above its device-side count); flush: the running
// sum is written to output plane `level` after it.
struct Product {
  uint8_t a_lo, a_hi, b_lo, b_hi;
  uint16_t ma, mb;
  uint8_t level, flush;
};

struct Walk {
  int n;
  Product p[kMaxProducts];
};

template <typename Q>
struct Bits;
template <>
struct Bits<int8_t> {
  using U = uint8_t;
  static constexpr uint32_t rep = 0x01010101u;  // a mask in every lane
  __device__ static int sext(uint32_t x) { return (int)(int8_t)(uint8_t)x; }
};
template <>
struct Bits<int16_t> {
  using U = uint16_t;
  static constexpr uint32_t rep = 0x00010001u;
  __device__ static int sext(uint32_t x) { return (int)(int16_t)(uint16_t)x; }
};

// S[k * pitch + r] = the operand's planes [lo, hi] & mask at (row r0 + r,
// contraction k0 + k) as int32, for r < R and k < BK
template <typename Q, int R, int BK, int THREADS>
__device__ __forceinline__ void stage(int32_t* S, int pitch,
                                      const Operand<Q>& op, int r0, int k0,
                                      int lo, int hi, uint32_t mask) {
  using U = typename Bits<Q>::U;
  constexpr int E = 16 / (int)sizeof(Q);  // elements of a 16-byte piece
  static_assert(BK % E == 0, "a staged row is whole 16-byte pieces");
  if (op.vec) {
    constexpr int PR = BK / E;  // pieces a row
    const uint32_t m = mask * Bits<Q>::rep;
    for (int v = threadIdx.x; v < R * PR; v += THREADS) {
      const int r = v / PR, c = (v % PR) * E;
      const int row = r0 + r, k = k0 + c;
      uint32_t w[4] = {0, 0, 0, 0};
      if (row < op.n_rows && k < op.n_k) {  // n_k is whole pieces here
        const Q* base = op.p + op.plane0 + row * op.s_row + k;
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
      for (int e = 0; e < E; ++e) {
        const uint32_t word = w[e * (int)sizeof(Q) / 4] & m;
        const int sh = (e * (int)sizeof(Q) % 4) * 8;
        S[(c + e) * pitch + r] = Bits<Q>::sext(word >> sh);
      }
    }
  } else {
    const bool k_fast = op.s_k == 1;
    for (int v = threadIdx.x; v < R * BK; v += THREADS) {
      const int r = k_fast ? v / BK : v % R, c = k_fast ? v % BK : v / R;
      const int row = r0 + r, k = k0 + c;
      uint32_t x = 0;
      if (row < op.n_rows && k < op.n_k) {
        const Q* base = op.p + op.plane0 + row * op.s_row + k * op.s_k;
        for (int i = lo; i <= hi; ++i) x |= (U)base[i * op.plane_step];
      }
      S[c * pitch + r] = Bits<Q>::sext(x & mask);
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
// contraction; THREADS = (BM / TM) * (BN / TN).  KID (1, 2, 3: the kernel
// B1, B2 or B3 that launches it) only names the instantiation, so that a
// profile tells the three apart.  A product at or above the
// device-side level count (B2) ends the walk.  A flush writes the running
// sum to plane `level` of C: added with atomics where the contraction is
// split, else added to C (add) or stored.
template <int KID, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_kernel(Operand<int16_t> A, Operand<int16_t> B, int32_t* __restrict__ C,
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
      stage<int16_t, BM, kBK, THREADS>(As, AP, A, m0, c * kBK, pr.a_lo,
                                       pr.a_hi, pr.ma);
      stage<int16_t, BN, kBK, THREADS>(Bs, BP, B, n0, c * kBK, pr.b_lo,
                                       pr.b_hi, pr.mb);
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

inline cudaError_t sm_count(int* sms) {
  static int cached_dev = -1, cached = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev) {
    err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached_dev = dev;
  }
  *sms = cached;
  return cudaSuccess;
}

template <typename Q>
__host__ __device__ inline Operand<Q> operand(const void* p, long long s_row,
                                              long long s_k,
                          long long plane0, long long plane_step, int n_rows,
                          int n_k) {
  constexpr int E = 16 / (int)sizeof(Q);
  Operand<Q> op = {(const Q*)p, s_row, s_k, plane0, plane_step, n_rows, n_k,
                   0};
  op.vec = s_k == 1 && s_row % E == 0 && plane0 % E == 0 &&
           plane_step % E == 0 && n_k % E == 0 && (uintptr_t)p % 16 == 0;
  return op;
}

template <int KID, int BM, int BN, int TM, int TN>
cudaError_t launch(const Operand<int16_t>& a, const Operand<int16_t>& b,
                   int32_t* c, int m, int n, const Walk& w,
                   const int* level_count, int n_levels, bool add,
                   bool zero_first, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
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
  gemm_kernel<KID, BM, BN, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      a, b, c, m, n, w, level_count, n_levels, add ? 1 : 0, plane, per);
  return cudaGetLastError();
}

// the tile by shape: 16 x 128 at M <= 16 (the FC layers at small batch),
// 128 x 64 where N <= 64 (conv1_x), else 128 x 128
template <int KID>
cudaError_t run(const Operand<int16_t>& a, const Operand<int16_t>& b,
                       void* c, int m, int n, const Walk& w,
                       const int* level_count, int n_levels, bool add,
                       bool zero_first, cudaStream_t s) {
  auto* pc = (int32_t*)c;
  if (m <= 16)
    return launch<KID, 16, 128, 1, 8>(a, b, pc, m, n, w, level_count, n_levels,
                                 add, zero_first, s);
  if (n <= 64)
    return launch<KID, 128, 64, 8, 4>(a, b, pc, m, n, w, level_count, n_levels,
                                 add, zero_first, s);
  return launch<KID, 128, 128, 8, 8>(a, b, pc, m, n, w, level_count, n_levels,
                                add, zero_first, s);
}

}  // namespace l2r16
