// The MSDF level walk on Hopper (sm_90a): the kernel template behind kernels
// B2 (l2r_streaming_gemm.cu) and B3 (l2r_pairs_gemm.cu).  Kernel B1
// (l2r_stacked_gemm.cu) has its own cp.async pipeline and no longer walks
// levels here.
//
// One thread block owns one output tile and walks a table of contiguous
// contraction slabs ("levels"): level l contracts A columns
// [a_col[l], a_col[l] + len[l]) with B rows [b_row[l], b_row[l] + len[l]),
// in 64-deep chunks, with mma.sync m16n8k32 s8 x s8 -> s32.  The accumulator
// stays in registers for the whole walk.  The two modes:
//
//  * kStream (B2): the table is the level-stacked schedule over pre-shifted
//    plane stacks; at every level boundary the block adds its running sum
//    into snapshot plane l of C (L, M, N).  The number of levels to run is
//    read from device memory (`level_count`): levels at or above it skip
//    both the products and the writes.
//  * kPairs (B3): the table is one slab, the raw operands' K; every 32-deep
//    step runs one mma per plane pair (i, j) of the MSDF pair list on the
//    pre-shifted digit planes, which are the raw bytes masked in registers
//    (a pre-shifted plane is a bit-field of the operand: plane i < D-1 keeps
//    bits [b*i, b*(i+1)), the signed top plane keeps bits b*(D-1) and up, the
//    sign extension included).  A pair's product is the term already scaled by
//    2^(b*(i+j)), so no shift is needed.
//
// Against the TPU: the Pallas kernels walk a sequential grid axis with a VMEM
// accumulator.  Hopper blocks run in no order, so each block walks the whole
// table itself.  int32 addition wraps and is associative, so any tiling,
// chunk order or split gives the reference's bits; the tensor cores
// accumulate in wrapping s32 (no .satfinite) and the epilogue adds in
// unsigned arithmetic.  No TPU block padding: ragged M, N and K edges are
// masked in the loaders and zero filled in shared memory.
//
// Tiles: 128 x 128; 128 x 64 where N <= 64; 16 x 128 where M <= 16.  When the
// tiles alone leave the card idle (the FC layers at small batch) the walk is
// split over blocks (split-K), each split adding with int32 atomics.  A split
// block in kStream owes every plane from its first level to the last: at each
// level boundary inside its range it adds its running partial to that level's
// plane, and at the end of its range it adds its total to the plane of the
// level it stopped in and to every later plane (plane l is the sum over
// splits of each split's partial through level l).
//
// Simple first: global loads go through registers into a two-stage shared
// buffer (the next chunk's loads are in flight during this chunk's mma); no
// cp.async/TMA, no wgmma.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace l2r {

constexpr int kMaxLevels = 15;  // 2D-1 levels for D <= 8 (n_bits <= 8)
constexpr int kMaxPairs = 64;   // D^2 pairs for D <= 8
constexpr int kBK = 64;         // contraction depth per chunk (two k32 mma steps)
constexpr int kSA = kBK + 16;   // shared row stride in bytes: 16B aligned, and the
                                // 20-word stride keeps fragment loads bank-free
constexpr int kThreads = 256;   // 8 warps

enum Mode { kStream = 1, kPairs = 2 };  // the numbers name the kernels in
                                        // profiles (chip_smoke.py)

struct LevelTable {
  int n;                        // levels in the walk
  int a_col[kMaxLevels];        // first A column of the level's slab
  int b_row[kMaxLevels];        // first B row of the level's slab
  int len[kMaxLevels];          // slab depth
  int chunk0[kMaxLevels + 1];   // prefix sum of 64-deep chunks per level
};

// everything a launch takes by value besides the operands
struct Walk {
  LevelTable lt;
  const int* level_count;       // kStream: levels to run, in device memory
  int n_pairs;                  // kPairs: the MSDF pair list (i, j)
  uint8_t pi[kMaxPairs], pj[kMaxPairs];
  uint32_t mask[8];             // kPairs: plane byte mask, in all four bytes
};

// the table's chunk prefix sums; false if a level is out of range
inline bool finish_table(LevelTable& lt) {
  if (lt.n < 1 || lt.n > kMaxLevels) return false;
  lt.chunk0[0] = 0;
  for (int l = 0; l < lt.n; ++l) {
    if (lt.len[l] < 1) return false;
    lt.chunk0[l + 1] = lt.chunk0[l] + (lt.len[l] + kBK - 1) / kBK;
  }
  return true;
}

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
// shared memory; needs 16-aligned A columns and slab depths, N % 4 == 0 and
// aligned bases (the host checks).  Otherwise (conv1_1's K=3) synchronous
// byte loads.
template <int MT, int NT, int WARPS_M, bool VEC, int MODE>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
            int32_t* __restrict__ C, int M, int N, int lda, int ldb, Walk w,
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

  const LevelTable& lt = w.lt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // kStream: levels at or above the count are neither computed nor written
  const int n_lv = MODE == kStream ? max(0, min(lt.n, *w.level_count)) : lt.n;
  const int step_lo = blockIdx.z * steps_per_split;
  const int step_hi = min(lt.chunk0[n_lv], step_lo + steps_per_split);
  const bool atomic = gridDim.z > 1;
  const size_t plane = (size_t)M * N;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  // add the running sum into planes [p_lo, p_hi] of C
  auto flush = [&](int p_lo, int p_hi) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int row = m0 + wm * MT * 16 + i * 16 + g;
        const int col = n0 + wn * NT * 8 + j * 8 + t * 2;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rr = row + (q >> 1) * 8, cc = col + (q & 1);
          if (rr < M && cc < N)
            for (int p = p_lo; p <= p_hi; ++p)
              put(C + p * plane + (size_t)rr * N + cc, acc[i][j][q], atomic);
        }
      }
    }
  };

  // kStream: after chunk `step` of level `lv`, snapshot at a level boundary;
  // at the end of the block's range the sum is owed to every later plane too
  auto snapshot = [&](int step, int lv) {
    if (MODE != kStream) return;
    if (step + 1 == step_hi)
      flush(lv, n_lv - 1);
    else if (step + 1 == lt.chunk0[lv + 1])
      flush(lv, lv);
  };

  // the chunk `step` of the walk: level l (advanced in place), offset k0 into
  // the level's slab, valid depth rem left in it
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
      if (MODE == kPairs) {
        // one mma per plane pair on the masked (pre-shifted) digit planes
        for (int p = 0; p < w.n_pairs; ++p) {
          const uint32_t ma = w.mask[w.pi[p]], mb = w.mask[w.pj[p]];
          uint32_t ap[MT][4], bp[NT][2];
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int r = 0; r < 4; ++r) ap[i][r] = af[i][r] & ma;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) bp[j][r] = bf[j][r] & mb;
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], ap[i], bp[j]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
      }
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
      const int cur = lv;  // the level of `step`
      const bool more = step + 1 < step_hi;
      if (more) {  // next chunk's loads in flight during this chunk's mma
        chunk(step + 1, lv, kk0, krem);
        gload(lv, kk0, krem);
      }
      compute(stage, kBK);
      if (more) sstore(stage ^ 1);
      snapshot(step, cur);  // after the prefetch registers are stored
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
      snapshot(step, lv);
      __syncthreads();
    }
  }

  if (MODE != kStream) flush(0, 0);
}

template <int MT, int NT, int WARPS_M, int MODE>
cudaError_t launch(bool vec, int m, int n, cudaStream_t stream, const int8_t* a,
                   const int8_t* b, int32_t* c, int lda, int ldb, const Walk& w) {
  constexpr int BM = MT * 16 * WARPS_M, BN = NT * 8 * (8 / WARPS_M);
  // split the walk over blocks when the output tiles alone leave the card
  // idle: aim at two blocks per SM, four for the small-M tile whose blocks
  // mostly stream weights (the FC layers at small batch); keep >= 8 chunks
  // each (2 in kPairs, where a chunk carries every plane pair)
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int total = w.lt.chunk0[w.lt.n];
  const int want = ((BM == 16 ? 4 : 2) * sms + tiles - 1) / tiles;
  const int splits = std::max(1, std::min(want, total / (MODE == kPairs ? 2 : 8)));
  const int per = (total + splits - 1) / splits;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, (total + per - 1) / per);
  if (vec)
    walk_kernel<MT, NT, WARPS_M, true, MODE><<<grid, kThreads, 0, stream>>>(
        a, b, c, m, n, lda, ldb, w, per);
  else
    walk_kernel<MT, NT, WARPS_M, false, MODE><<<grid, kThreads, 0, stream>>>(
        a, b, c, m, n, lda, ldb, w, per);
  return cudaGetLastError();
}

// C += the walk over a (m, lda) and b (rows, ldb = n), the tile shape by
// problem shape: 16 x 128 for the FC layers at small batch (no tensor work on
// empty rows), 128 x 64 where N <= 64 (conv1_x), else 128 x 128
template <int MODE>
cudaError_t run(const void* a, const void* b, void* c, int m, int n, int lda,
                int ldb, const Walk& w, void* stream) {
  bool vec = (lda % 16 == 0) && (n % 4 == 0) && (ldb % 4 == 0) &&
             ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 4 == 0);
  for (int l = 0; l < w.lt.n; ++l)
    vec = vec && (w.lt.a_col[l] % 16 == 0) && (w.lt.len[l] % 16 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* pa = (const int8_t*)a;
  const auto* pb = (const int8_t*)b;
  auto* pc = (int32_t*)c;
  if (m <= 16) return launch<1, 2, 1, MODE>(vec, m, n, s, pa, pb, pc, lda, ldb, w);
  if (n <= 64) return launch<2, 4, 4, MODE>(vec, m, n, s, pa, pb, pc, lda, ldb, w);
  return launch<4, 4, 2, MODE>(vec, m, n, s, pa, pb, pc, lda, ldb, w);
}

}  // namespace l2r
