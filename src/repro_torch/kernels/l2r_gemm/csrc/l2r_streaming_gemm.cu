// Kernel B2: the per-level snapshot stream of the MSDF digit-plane GEMM for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/l2r_gemm/kernel.py:_l2r_streaming_kernel
// (reached through l2r_gemm_pallas_streaming_planes).  Over pre-shifted int8
// digit-plane stacks, A_stack (M, D*K) with ascending planes and the K-major
// B stack Bt (N, D*K) with descending planes (plane j at byte (D-1-j)*K of a
// row), it writes the (L, M, N) int32 stream
//
//     C[l] (+)= the sum of levels 0 .. l of the MSDF walk,
//
// level t holding the plane pairs (i, j) with i + j = 2D-2-t, so plane l is
// bit-identical to kernel B1 truncated at levels = l + 1; it adds into C when
// the caller passes a stream to add to (the progressive conv's taps).  The
// number of levels to run is an int32 read from device memory (the TPU
// kernel's scalar-prefetched `cnt_ref`), so an early-exit consumer can set it
// without a host sync: levels at or above it skip their products and their
// planes are left as they were.
//
// Bound on this card (H100 SXM data sheet: int8 1,979 TOP/s dense, HBM
// 3.35 TB/s): the stacks read once and the L planes of C read and written.
// At the VGG-16 head (M = 8) the 16.4 MB weight stack dominates (fc8:
// 0.005 ms); on the conv taps the int32 planes do.  What the design does:
//  * The walk runs chunk-major: a stage holds 32 bytes of the contraction of
//    every plane of A and of B (cp.async, 16-byte pieces, zero fill past the
//    ragged edges, a ring of 4 stages), and each of the D^2 plane pairs
//    becomes one mma into its level's accumulator in registers (2D-1 of
//    them).  A and B are read from global memory once per tile, B K-major
//    in place (the weight caches are built so; no per-call copy), both
//    through ldmatrix with rows padded 16 bytes.  No transposes.
//  * At the end the level prefixes are formed in registers and staged in
//    shared memory, all planes at once; each thread then takes 4-column
//    pieces of the tile and, for every level, starts all its loads of C
//    before its 16-byte stores (or only stores, when the caller passes no
//    stream to add to): whole rows of C, many loads in flight.
//  * Small M (the FC head at batch 8): tiles of 16 x 64, and the contraction
//    split over a thread-block cluster of up to 8 blocks along K.  After a
//    cluster barrier every block sums its share of the tile's pieces over
//    the cluster's staged planes (distributed shared memory) and writes
//    them, so each plane element is written once, with no atomics.  Large
//    M: 32 x 64 tiles, 113 registers at D = 4, two blocks an SM.
//  * Operands that are not 16-byte aligned (conv1_1's K = 3, ragged tests)
//    are staged with byte loads, two stages, into the same layout.
// Instantiated for D = 1-8 (every int8 config); the int16 stacks (n_bits
// 9-16, D up to 16) take the entry l2r_streaming_gemm16: one plane pair a
// product through the CUDA-core routine of l2r_int16.cuh, the running sum
// written after each level.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cooperative_groups.h>

#include <algorithm>

#include "l2r_int16.cuh"
#include "l2r_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace l2r;

constexpr int kBK = 32;     // contraction bytes of each plane in a stage
constexpr int kStages = 4;  // cp.async ring

// a shared row: D planes of kBK bytes and 16 of padding, an odd multiple of
// 16 bytes, so ldmatrix's 8 rows fall on 8 bank groups
template <int D>
__host__ __device__ constexpr int row_bytes() { return D * kBK + 16; }

// D planes; NT n8 tiles per warp; WARPS_M x (THREADS/32 / WARPS_M) warps of
// m16 x 8*NT: a BM x BN tile.  C is (L, M, N); splits > 1 runs the grid's z
// as one cluster that splits the contraction.
template <int D, int NT, int WARPS_M, int THREADS>
__global__ void __launch_bounds__(THREADS)
stream_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
              int32_t* __restrict__ C, int M, int N, int lda, int ldb, int K,
              int n_levels, const int* __restrict__ level_count,
              int steps_per_split, bool async, bool accumulate) {
  constexpr int LV = 2 * D - 1;
  constexpr int WARPS_N = THREADS / 32 / WARPS_M;
  constexpr int BM = 16 * WARPS_M;
  constexpr int BN = 8 * NT * WARPS_N;
  constexpr int ROW = row_bytes<D>();
  constexpr int SLOT = (BM + BN) * ROW;
  constexpr int SP = BN + 8;  // staged int32 row pitch: int2 stores of a half
                              // warp on 32 banks, 16-byte aligned rows
  static_assert(NT % 2 == 0, "ldmatrix.x4 fills two n8 tiles");
  extern __shared__ __align__(16) int8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int count = max(0, min(n_levels, *level_count));
  const int steps = (K + kBK - 1) / kBK;
  const int step_lo = blockIdx.z * steps_per_split;
  const int step_hi = count ? min(steps, step_lo + steps_per_split) : step_lo;

  int acc[LV][NT][4];
#pragma unroll
  for (int l = 0; l < LV; ++l)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[l][j][q] = 0;

  // stage bytes [step*kBK, +kBK) of every plane of the A and B rows; plane
  // p of a shared row at byte p*kBK (B: plane j = p, from (D-1-p)*K)
  auto load = [&](int slot, int step) {
    int8_t* s = smem + slot * SLOT;
    const int k0 = step * kBK;
    if (async) {  // 16-byte pieces; K, lda, ldb multiples of 16
      for (int v = tid; v < (BM + BN) * D * 2; v += THREADS) {
        const int r = v / (2 * D), p = (v >> 1) % D, h = v & 1;
        const bool is_a = r < BM;
        const int rr = is_a ? r : r - BM;
        const int kk = k0 + 16 * h;
        const bool ok = (is_a ? m0 + rr < M : n0 + rr < N) && kk < K;
        const int8_t* src =
            is_a ? A + (size_t)(m0 + rr) * lda + p * K + kk
                 : Bt + (size_t)(n0 + rr) * ldb + (D - 1 - p) * K + kk;
        cp_async16(s + r * ROW + p * kBK + 16 * h, ok ? src : A, ok);
      }
    } else {  // 4-byte words from byte loads: any K and alignment
      for (int v = tid; v < (BM + BN) * D * (kBK / 4); v += THREADS) {
        const int r = v / (D * (kBK / 4)), p = (v / (kBK / 4)) % D;
        const int c = (v % (kBK / 4)) * 4;
        const bool is_a = r < BM;
        const int rr = is_a ? r : r - BM;
        uint32_t w = 0;
        if (is_a ? m0 + rr < M : n0 + rr < N) {
          const int8_t* src =
              is_a ? A + (size_t)(m0 + rr) * lda + p * K
                   : Bt + (size_t)(n0 + rr) * ldb + (D - 1 - p) * K;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + c + e < K)
              w |= (uint32_t)(uint8_t)src[k0 + c + e] << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(s + r * ROW + p * kBK + c) = w;
      }
    }
  };

  // ldmatrix rows of this lane: A x4 = rows 0-7 / 8-15 at k 0-15 / 16-31;
  // B x4 = n 0-7 at k 0-15 / 16-31, then n 8-15
  const int a_row = wm * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int b_row = BM + wn * NT * 8 + (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;

  // every plane pair of the staged chunk, into its level's accumulator;
  // levels at or above `count` are skipped
  auto compute = [&](int slot) {
    const int8_t* s = smem + slot * SLOT;
    uint32_t af[D][4];
#pragma unroll
    for (int i = 0; i < D; ++i)
      ldmatrix_x4(af[i], s + a_row * ROW + i * kBK + a_col);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      uint32_t bf[NT][2];
#pragma unroll
      for (int jj = 0; jj < NT; jj += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, s + (b_row + jj * 8) * ROW + j * kBK + b_col);
        bf[jj][0] = r[0];
        bf[jj][1] = r[1];
        bf[jj + 1][0] = r[2];
        bf[jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const int lv = 2 * D - 2 - i - j;
        if (lv < count)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_s8(acc[lv][nt], af[i], bf[nt][0], bf[nt][1]);
      }
    }
  };

  if (async) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (step_lo + s < step_hi) load(s, step_lo + s);
      cp_async_commit();
    }
    for (int step = step_lo; step < step_hi; ++step) {
      const int it = step - step_lo;
      cp_async_wait<kStages - 2>();  // chunk `step` has landed
      __syncthreads();               // ... for every thread; the slot read
                                     // one step ago is free
      if (step + kStages - 1 < step_hi)
        load((it + kStages - 1) % kStages, step + kStages - 1);
      cp_async_commit();
      compute(it % kStages);
    }
    cp_async_wait<0>();
  } else {
    for (int step = step_lo; step < step_hi; ++step) {
      const int slot = (step - step_lo) & 1;  // read two steps ago: free
      load(slot, step);
      __syncthreads();
      compute(slot);
    }
  }
  __syncthreads();  // the ring is free: it now holds the level prefixes

  // the level prefixes, in wrapping int32, staged as planes [l][BM][SP]
  int32_t* stage = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int l = 0; l < LV; ++l) {
    if (l >= count) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (l > 0)
          acc[l][j][q] = (int)((unsigned)acc[l][j][q] + (unsigned)acc[l - 1][j][q]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(stage + (l * BM + wm * 16 + g + 8 * h) * SP +
                                 wn * NT * 8 + j * 8 + 2 * t) =
            make_int2(acc[l][j][2 * h], acc[l][j][2 * h + 1]);
  }

  // A block alone writes its tile.  A cluster (the contraction split along
  // K) sums its blocks' staged planes through distributed shared memory,
  // each block one share of the tile's 4-column pieces: every element of
  // every plane is written once, with no atomics.
  const bool split = gridDim.z > 1;
  cg::cluster_group cluster = cg::this_cluster();
  int ranks = 1, me = 0;
  if (split) {
    cluster.sync();
    ranks = (int)cluster.num_blocks();
    me = (int)cluster.block_rank();
  } else {
    __syncthreads();
  }
  const bool vec = N % 4 == 0 && ((uintptr_t)C & 15) == 0;
  const size_t plane = (size_t)M * N;
  const int pieces = BM * (BN / 4);
  for (int v = pieces * me / ranks + tid; v < pieces * (me + 1) / ranks;
       v += THREADS) {
    const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    // every level of the piece: the sums first, then C's values (all
    // loads in flight together), then the stores
    uint4 sum[LV];
#pragma unroll
    for (int l = 0; l < LV; ++l) {
      if (l >= count) continue;
      const int off = (l * BM + r) * SP + c;
      sum[l] = *reinterpret_cast<const uint4*>(stage + off);
#pragma unroll 1
      for (int src = 0; split && src < ranks; ++src) {
        if (src == me) continue;
        const uint4 x = *reinterpret_cast<const uint4*>(
            cluster.map_shared_rank(stage, src) + off);
        sum[l].x += x.x;
        sum[l].y += x.y;
        sum[l].z += x.z;
        sum[l].w += x.w;
      }
    }
    int32_t* dst = C + (size_t)row * N + col;
    if (vec) {
      uint4 o[LV];
#pragma unroll
      for (int l = 0; l < LV; ++l) {
        if (l >= count) continue;
        o[l] = accumulate ? *reinterpret_cast<const uint4*>(dst + l * plane)
                          : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int l = 0; l < LV; ++l) {
        if (l >= count) continue;
        *reinterpret_cast<uint4*>(dst + l * plane) =
            make_uint4(o[l].x + sum[l].x, o[l].y + sum[l].y,
                       o[l].z + sum[l].z, o[l].w + sum[l].w);
      }
    } else {
#pragma unroll
      for (int l = 0; l < LV; ++l) {
        if (l >= count) continue;
        const unsigned e[4] = {sum[l].x, sum[l].y, sum[l].z, sum[l].w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < N) {
            int32_t* p = dst + l * plane + q;
            *p = (int32_t)((accumulate ? (unsigned)*p : 0u) + e[q]);
          }
      }
    }
  }
  if (split) cluster.sync();  // keep this block's planes until all have read
}

template <int D, int NT, int WARPS_M, int THREADS>
cudaError_t launch(bool async, bool accumulate, int splits, int m, int n,
                   int lda, int ldb,
                   int k, int n_levels, const int* level_count,
                   cudaStream_t stream, const int8_t* a, const int8_t* bt,
                   int32_t* c) {
  constexpr int BM = 16 * WARPS_M, BN = 8 * NT * (THREADS / 32 / WARPS_M);
  constexpr int RING = kStages * (BM + BN) * row_bytes<D>();
  constexpr int PLANES = (2 * D - 1) * BM * (BN + 8) * 4;
  constexpr int SMEM = RING > PLANES ? RING : PLANES;
  auto* kern = &stream_kernel<D, NT, WARPS_M, THREADS>;
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int steps = (k + kBK - 1) / kBK;
  const int per = (steps + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((m + BM - 1) / BM, (n + BN - 1) / BN, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (splits > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = splits;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a, bt, c, m, n, lda, ldb,
                                       k, n_levels, level_count, per, async,
                                       accumulate);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t run(int tile, bool async, bool accumulate, int splits, int m,
                int n, int lda, int ldb, int k, int n_levels,
                const int* level_count, cudaStream_t s, const int8_t* a,
                const int8_t* bt, int32_t* c) {
  if (tile == 0)  // 16 x 64: small M
    return launch<D, 2, 1, 128>(async, accumulate, splits, m, n, lda, ldb, k,
                                n_levels, level_count, s, a, bt, c);
  return launch<D, 2, 2, 256>(async, accumulate, splits, m, n, lda, ldb, k,
                              n_levels, level_count, s, a, bt, c);
}

}  // namespace

// C (n_levels, m, n) int32 = (accumulate: C +) the per-level prefixes of the
// walk over a (m, lda) and bt (n, ldb), both int8 with d planes of k bytes a
// row (A ascending from byte 0, bt the K-major B stack, plane j at byte
// (d-1-j)*k).  level_count points to one int32 on the device: levels at or
// above it are skipped.  tile 0 is 16 x 64 (small m), tile 1 32 x 64;
// splits (1..8) blocks of a cluster share the contraction.  Returns a
// cudaError_t as int: 0 when the launch was accepted.
extern "C" int l2r_streaming_gemm(const void* a, const void* bt, void* c,
                                  int m, int n, int lda, int ldb, int d, int k,
                                  int n_levels, const void* level_count,
                                  int tile, int splits, int accumulate,
                                  void* stream) {
  if (m < 1 || n < 1 || k < 1 || lda < d * k || ldb < d * k ||
      n_levels < 1 || n_levels > 2 * d - 1 || level_count == nullptr ||
      (tile != 0 && tile != 1) || splits < 1 || splits > 8 ||
      splits > (k + kBK - 1) / kBK)
    return (int)cudaErrorInvalidValue;
  const bool async = k % 16 == 0 && lda % 16 == 0 && ldb % 16 == 0 &&
                     (uintptr_t)a % 16 == 0 && (uintptr_t)bt % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* pa = (const int8_t*)a;
  const auto* pb = (const int8_t*)bt;
  const auto* cnt = (const int*)level_count;
  auto* pc = (int32_t*)c;
  const bool acc = accumulate != 0;
  switch (d) {
    case 1: return (int)run<1>(tile, async, acc, splits, m, n, lda, ldb, k, n_levels, cnt, s, pa, pb, pc);
    case 2: return (int)run<2>(tile, async, acc, splits, m, n, lda, ldb, k, n_levels, cnt, s, pa, pb, pc);
    case 3: return (int)run<3>(tile, async, acc, splits, m, n, lda, ldb, k, n_levels, cnt, s, pa, pb, pc);
    case 4: return (int)run<4>(tile, async, acc, splits, m, n, lda, ldb, k, n_levels, cnt, s, pa, pb, pc);
    case 5: return (int)run<5>(tile, async, acc, splits, m, n, lda, ldb, k, n_levels, cnt, s, pa, pb, pc);
    case 6: return (int)run<6>(tile, async, acc, splits, m, n, lda, ldb, k, n_levels, cnt, s, pa, pb, pc);
    case 7: return (int)run<7>(tile, async, acc, splits, m, n, lda, ldb, k, n_levels, cnt, s, pa, pb, pc);
    case 8: return (int)run<8>(tile, async, acc, splits, m, n, lda, ldb, k, n_levels, cnt, s, pa, pb, pc);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The int16 route: C (n_levels, m, n) int32 = (accumulate: C +) the level
// prefixes of the walk over int16 stacks a (m, lda) and bt (n, ldb), laid out
// as above (elements), D <= 16, through l2r_int16.cuh on the CUDA cores;
// level_count as above.
// Returns a cudaError_t as int.
extern "C" int l2r_streaming_gemm16(const void* a, const void* bt, void* c,
                                    int m, int n, int lda, int ldb, int d,
                                    int k, int n_levels,
                                    const void* level_count, int accumulate,
                                    void* stream) {
  if (m < 1 || n < 1 || k < 1 || d < 1 || d > 16 || lda < d * k ||
      ldb < d * k || n_levels < 1 || n_levels > 2 * d - 1 ||
      level_count == nullptr)
    return (int)cudaErrorInvalidValue;
  l2r16::Walk w = {};
  for (int t = 0; t < n_levels; ++t) {  // level t: pairs with i + j = 2D-2-t
    const int sig = 2 * d - 2 - t;
    for (int i = std::min(sig, d - 1); i >= std::max(0, sig - d + 1); --i) {
      const int j = sig - i;
      w.p[w.n++] = {(uint8_t)i, (uint8_t)i, (uint8_t)j, (uint8_t)j, 0xFFFF,
                    0xFFFF, (uint8_t)t, 0};
    }
    w.p[w.n - 1].flush = 1;
  }
  const auto A = l2r16::operand(a, lda, 0, k, m, k);
  const auto B =
      l2r16::operand(bt, ldb, (long long)(d - 1) * k, -(long long)k, n, k);
  return (int)l2r16::run(A, B, c, m, n, w, (const int*)level_count, n_levels,
                         accumulate != 0, accumulate == 0,
                         (cudaStream_t)stream);
}
