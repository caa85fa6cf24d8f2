// Kernel B1: the level-stacked MSDF digit-plane GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/l2r_gemm/kernel.py:_l2r_stacked_kernel
// (reached through l2r_gemm_pallas_stacked_planes).  It computes
//
//     C (M, N) int32 = sum over the MSDF levels s of  A_stack[:, i_lo*K : (i_hi+1)*K]
//                                                  @ B_rev[(d-1-s+i_lo)*K : ..., :]
//
// over pre-shifted int8 digit-plane stacks: A_stack (M, D*K) with ascending
// planes, B_rev (D*K, N) with descending planes.  A level's plane pairs are one
// contiguous column slab of A_stack against one contiguous row slab of B_rev, so
// each level is a plain contraction of depth n_pairs(s)*K.  `levels` truncation
// is a shorter level table.
//
// Design, against the TPU original:
//  * The TPU walks the (level, k-block) schedule as a sequential grid axis with
//    scalar-prefetched index vectors and a VMEM accumulator.  Here one thread
//    block owns one output tile (128 x 128, 128 x 64 where N <= 64, 16 x 128
//    where M <= 16) and loops over the level table (passed by value) and,
//    inside each level, over 64-deep chunks of its slab.  The accumulator stays
//    in registers for the whole walk.
//  * int32 addition wraps and is associative, so any tiling or chunk order gives
//    the reference's bits.  The tensor cores accumulate s8 x s8 products in
//    wrapping s32 (mma.sync ... .s32.s8.s8.s32 without .satfinite); the epilogue
//    adds in unsigned arithmetic, never signed C++ overflow.
//  * No TPU block padding: ragged M, N and K edges are masked here and zero
//    filled in shared memory (zeros are exact), so conv1_1 (K=3) reads 3-deep
//    slabs instead of 128-padded ones.
//  * Bound on this card (H100 SXM data sheet: int8 1,979 TOP/s dense, HBM
//    3.35 TB/s), at batch 8: the deep conv taps (cin >= 256) are operation
//    bound; the shallow taps are bound by their int32 output, which the tap
//    sum reads and writes once per tap; fc6-fc8 by reading the plane-stacked
//    weights.  For the first, each warp runs 16 m16n8k32 mma.sync per 32-deep
//    step; for the second, N <= 64 gets a 128 x 64 tile so no tensor work
//    lands on absent columns; for the third, a 16-row tile wastes no tensor
//    work on empty rows and the level walk is split across blocks (split-K
//    with int32 atomics, exact because the sum wraps identically in any
//    order) so that every SM streams weights.
//  * Simple first: global loads go through registers into a two-stage shared
//    buffer (the next chunk's loads are in flight during this chunk's mma);
//    no cp.async/TMA, no wgmma.  Those are the next step for this kernel.
//
// The kernel adds into C, which the caller initialises.  The launch uses the
// caller's stream, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxLevels = 15;  // 2D-1 levels for D <= 8 (n_bits <= 8)
constexpr int kBK = 64;         // contraction depth per chunk (two k32 mma steps)
constexpr int kSA = kBK + 16;   // shared row stride in bytes: 16B aligned, and the
                                // 20-word stride keeps fragment loads bank-free
constexpr int kThreads = 256;   // 8 warps

struct LevelTable {
  int n;                        // levels in the walk
  int a_col[kMaxLevels];        // first A_stack column of the level's slab
  int b_row[kMaxLevels];        // first B_rev row of the level's slab
  int len[kMaxLevels];          // slab depth: n_pairs(s) * K
  int chunk0[kMaxLevels + 1];   // prefix sum of 64-deep chunks per level
};


__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C += v, wrapping: plainly when one block owns the element, atomically when
// the walk is split over blocks
__device__ __forceinline__ void put(int32_t* p, int v, bool atomic) {
  if (atomic)
    atomicAdd((unsigned int*)p, (unsigned int)v);
  else
    *p = (int32_t)((uint32_t)*p + (uint32_t)v);
}

// MT x NT m16n8 tiles per warp, WARPS_M x (8 / WARPS_M) warps: a BM x BN
// output tile per block, BM = 16 * MT * WARPS_M, BN = 8 * NT * (8 / WARPS_M).
// VEC: 16-byte A loads and 4x4-byte transposing B loads, double-buffered in
// shared memory so the next chunk's global loads overlap this chunk's mma;
// needs K % 16 == 0, N % 4 == 0 and aligned bases (the host checks).
// Otherwise (conv1_1's K=3) synchronous byte loads.
template <int MT, int NT, int WARPS_M, bool VEC>
__global__ void __launch_bounds__(kThreads)
l2r_stacked_gemm_kernel(const int8_t* __restrict__ A,
                        const int8_t* __restrict__ B, int32_t* __restrict__ C,
                        int M, int N, int lda, int ldb, LevelTable lt,
                        int steps_per_split) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int BM = MT * 16 * WARPS_M;
  constexpr int BN = NT * 8 * WARPS_N;
  constexpr int A_VECS = BM * (kBK / 16);           // 16-byte A pieces
  constexpr int B_BLKS = (kBK / 4) * (BN / 4);      // 4x4-byte B blocks
  constexpr int A_PER = (A_VECS + kThreads - 1) / kThreads;
  constexpr int B_PER = (B_BLKS + kThreads - 1) / kThreads;
  __shared__ __align__(16) int8_t As[2][BM * kSA];
  __shared__ __align__(16) int8_t Bs[2][BN * kSA];  // transposed: [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int step_lo = blockIdx.z * steps_per_split;
  const int step_hi = min(lt.chunk0[lt.n], step_lo + steps_per_split);

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  // the chunk `step` of the walk: level lv (advanced in place), offset kk0
  // into the level's slab, valid depth krem left in it
  auto chunk = [&](int step, int& l, int& k0, int& rem) {
    while (lt.chunk0[l + 1] <= step) ++l;
    k0 = (step - lt.chunk0[l]) * kBK;
    rem = lt.len[l] - k0;
  };

  // mma over the first kc (a multiple of 32) bytes of the staged chunk; each
  // fragment register is one 32-bit shared load (row g, bytes 4t .. 4t+3)
  auto compute = [&](int stage, int kc) {
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      if (ks >= kc) break;
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = As[stage] + (wm * MT * 16 + i * 16 + g) * kSA + ks + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kSA);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kSA + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* q = Bs[stage] + (wn * NT * 8 + j * 8 + g) * kSA + ks + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(q);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(q + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  };

  int lv = 0, kk0 = 0, krem = 0;
  if (VEC) {
    int4 ra[A_PER];
    uint32_t rb[B_PER][4];
    auto gload = [&](int lvl, int kk, int rem) {
      const int8_t* a_base = A + lt.a_col[lvl] + kk;
      const int8_t* b_base = B + (size_t)(lt.b_row[lvl] + kk) * ldb + n0;
#pragma unroll
      for (int i = 0; i < A_PER; ++i) {
        const int v = tid + i * kThreads;
        const int r = v / (kBK / 16), c = (v % (kBK / 16)) * 16;
        ra[i] = make_int4(0, 0, 0, 0);
        if (v < A_VECS && m0 + r < M && c < rem)
          ra[i] = *reinterpret_cast<const int4*>(a_base + (size_t)(m0 + r) * lda + c);
      }
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int v = tid + i * kThreads;
        const int kb = (v / (BN / 4)) * 4, nb = (v % (BN / 4)) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          rb[i][j] = 0;
          if (v < B_BLKS && kb + j < rem && n0 + nb < N)
            rb[i][j] = *reinterpret_cast<const uint32_t*>(b_base + (size_t)(kb + j) * ldb + nb);
        }
      }
    };
    auto sstore = [&](int stage) {
#pragma unroll
      for (int i = 0; i < A_PER; ++i) {
        const int v = tid + i * kThreads;
        if (v < A_VECS)
          *reinterpret_cast<int4*>(As[stage] + (v / (kBK / 16)) * kSA + (v % (kBK / 16)) * 16) = ra[i];
      }
      // each 4x4 block: rows k..k+3 of columns n..n+3, transposed into the
      // four words [n+q][k..k+3]
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int v = tid + i * kThreads;
        if (v >= B_BLKS) continue;
        const int kb = (v / (BN / 4)) * 4, nb = (v % (BN / 4)) * 4;
        const uint32_t t0 = __byte_perm(rb[i][0], rb[i][1], 0x5140);
        const uint32_t t1 = __byte_perm(rb[i][0], rb[i][1], 0x7362);
        const uint32_t u0 = __byte_perm(rb[i][2], rb[i][3], 0x5140);
        const uint32_t u1 = __byte_perm(rb[i][2], rb[i][3], 0x7362);
        int8_t* dst = Bs[stage] + nb * kSA + kb;
        *reinterpret_cast<uint32_t*>(dst + 0 * kSA) = __byte_perm(t0, u0, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + 1 * kSA) = __byte_perm(t0, u0, 0x7632);
        *reinterpret_cast<uint32_t*>(dst + 2 * kSA) = __byte_perm(t1, u1, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + 3 * kSA) = __byte_perm(t1, u1, 0x7632);
      }
    };

    if (step_lo < step_hi) {
      chunk(step_lo, lv, kk0, krem);
      gload(lv, kk0, krem);
      sstore(0);
    }
    __syncthreads();
    int stage = 0;
    for (int step = step_lo; step < step_hi; ++step) {
      const bool more = step + 1 < step_hi;
      if (more) {  // next chunk's loads in flight during this chunk's mma
        chunk(step + 1, lv, kk0, krem);
        gload(lv, kk0, krem);
      }
      compute(stage, kBK);
      if (more) sstore(stage ^ 1);
      __syncthreads();
      stage ^= 1;
    }
  } else {
    for (int step = step_lo; step < step_hi; ++step) {
      chunk(step, lv, kk0, krem);
      const int8_t* a_base = A + lt.a_col[lv] + kk0;
      const int8_t* b_base = B + (size_t)(lt.b_row[lv] + kk0) * ldb + n0;
      // stage only the first kc bytes the mma reads: a short slab (K=3
      // gives levels 3..12 deep) skips the all-zero second half
      const int kc = min(kBK, (krem + 31) & ~31);
      for (int v = tid; v < BM * kc; v += kThreads) {
        const int r = v / kc, c = v % kc;
        As[0][r * kSA + c] = (m0 + r < M && c < krem) ? a_base[(size_t)(m0 + r) * lda + c] : 0;
      }
      for (int v = tid; v < kc * BN; v += kThreads) {
        const int kk = v / BN, n = v % BN;
        Bs[0][n * kSA + kk] = (kk < krem && n0 + n < N) ? b_base[(size_t)kk * ldb + n] : 0;
      }
      __syncthreads();
      compute(0, kc);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = m0 + wm * MT * 16 + i * 16 + g;
      const int col = n0 + wn * NT * 8 + j * 8 + t * 2;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = row + (q >> 1) * 8, cc = col + (q & 1);
        if (rr < M && cc < N) put(C + (size_t)rr * N + cc, acc[i][j][q], gridDim.z > 1);
      }
    }
  }
}

template <int MT, int NT, int WARPS_M>
cudaError_t launch(bool vec, int m, int n, cudaStream_t stream, const int8_t* a,
                   const int8_t* b, int32_t* c, int lda, int ldb,
                   const LevelTable& lt) {
  constexpr int BM = MT * 16 * WARPS_M, BN = NT * 8 * (8 / WARPS_M);
  // split the walk over blocks when the output tiles alone leave the card
  // idle: aim at two blocks per SM, four for the small-M tile whose blocks
  // mostly stream weights (fc6-fc8 at small batch); keep >= 8 chunks each
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int total = lt.chunk0[lt.n];
  const int want = ((BM == 16 ? 4 : 2) * sms + tiles - 1) / tiles;
  const int splits = std::max(1, std::min(want, total / 8));
  const int per = (total + splits - 1) / splits;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, (total + per - 1) / per);
  if (vec)
    l2r_stacked_gemm_kernel<MT, NT, WARPS_M, true><<<grid, kThreads, 0, stream>>>(
        a, b, c, m, n, lda, ldb, lt, per);
  else
    l2r_stacked_gemm_kernel<MT, NT, WARPS_M, false><<<grid, kThreads, 0, stream>>>(
        a, b, c, m, n, lda, ldb, lt, per);
  return cudaGetLastError();
}

}  // namespace

// C (m, n) int32 += the level walk over a (m, lda) and b (rows, ldb = n).
// Level l reads a columns [a_col[l], a_col[l] + len[l]) and b rows
// [b_row[l], b_row[l] + len[l]).  C must hold the sum to add to (zeros for a
// plain product).  Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int l2r_stacked_gemm(const void* a, const void* b, void* c, int m,
                                int n, int lda, int ldb, int n_levels,
                                const int* a_col, const int* b_row,
                                const int* len, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || m < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  LevelTable lt;
  lt.n = n_levels;
  lt.chunk0[0] = 0;
  bool vec = (lda % 16 == 0) && (n % 4 == 0) && (ldb % 4 == 0) &&
             ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 4 == 0);
  for (int l = 0; l < n_levels; ++l) {
    if (len[l] < 1) return (int)cudaErrorInvalidValue;
    lt.a_col[l] = a_col[l];
    lt.b_row[l] = b_row[l];
    lt.len[l] = len[l];
    lt.chunk0[l + 1] = lt.chunk0[l] + (len[l] + kBK - 1) / kBK;
    vec = vec && (a_col[l] % 16 == 0) && (len[l] % 16 == 0);
  }
  cudaStream_t s = (cudaStream_t)stream;
  const auto* pa = (const int8_t*)a;
  const auto* pb = (const int8_t*)b;
  auto* pc = (int32_t*)c;
  // tile shape by problem shape: 16 x 128 for the FC layers at small batch
  // (no tensor work on empty rows), 128 x 64 where N <= 64 (conv1_x), else
  // 128 x 128
  if (m <= 16)
    return (int)launch<1, 2, 1>(vec, m, n, s, pa, pb, pc, lda, ldb, lt);
  if (n <= 64)
    return (int)launch<2, 4, 4>(vec, m, n, s, pa, pb, pc, lda, ldb, lt);
  return (int)launch<4, 4, 2>(vec, m, n, s, pa, pb, pc, lda, ldb, lt);
}
