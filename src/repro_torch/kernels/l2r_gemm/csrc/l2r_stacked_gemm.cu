// Kernel B1: the level-stacked MSDF digit-plane GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/l2r_gemm/kernel.py:_l2r_stacked_kernel
// (reached through l2r_gemm_pallas_stacked_planes).  Over pre-shifted int8
// digit-plane stacks, A_stack (M, D*K) with ascending planes and B_rev
// (D*K, N) with descending planes, it computes the MSDF level walk
//
//     C (M, N) int32 += sum over the levels [first_level, levels) of the
//                       plane pairs (i, j) of the level:  A_i @ B_j
//
// as a short list of plane-range products (the host's msdf_products):
//
//     C += sum over products p of  (sum_{i in [il, ih]} A_i) @ (sum_{j in [jl, jh]} B_j).
//
// A pre-shifted plane is a bit-field of its operand (plane i < D-1 keeps bits
// [b*i, b*(i+1)), the top plane the bits from b*(D-1) up with the sign
// extension), so a plane range is the bytewise OR of its planes and fits int8.
// A prefix of the walk (first_level 0, every vgg16_apply GEMM) collapses to at
// most D products and at full depth to one, a @ b: the tensor work of one
// int8 GEMM, not the D^2 = 16 of the level walk.  A table that starts above
// level 0 (the early-exit loop's one-level slabs) runs as its plane pairs,
// one product each.  int32 addition wraps and is associative, so every form,
// tiling, split and order gives the reference's bits; the tensor cores
// accumulate in wrapping s32 (mma.sync ... .s32.s8.s8.s32, no .satfinite) and
// the epilogue adds in unsigned arithmetic.
//
// Bound on this card (H100 SXM data sheet: int8 1,979 TOP/s dense, HBM
// 3.35 TB/s), at batch 8 and full depth: every VGG-16 GEMM is bound by bytes.
// The convs move the A stack (D*K bytes a row) and the int32 tap sum, which
// each tap reads and writes once (out=); fc6-fc8 stream the plane-stacked
// weights (fc6: 411 MB, 0.123 ms).  What the design does about it:
//  * Both operands are staged k-contiguous: A_stack as it is, B as the K-major
//    stack (N, D*K) that the weight cache holds (core/quant.py, k_major=True),
//    so a 16-byte piece of global memory is a 16-byte piece of a shared row.
//    Rows are padded by 16 bytes, so ldmatrix reads 8 rows on 8 distinct bank
//    groups; ldmatrix.x4 fills the m16n8k32 fragments.  No transposes.
//  * Global -> shared through cp.async (16 bytes a thread, zero fill past the
//    ragged M, N and K edges) into a ring of 3 stages (4 for the 16-row
//    weight-stream tile, 2 where the contraction is two chunks or fewer) in
//    dynamic shared memory, one __syncthreads a stage.  The tap sum starts
//    from C, so C's read overlaps the first copies.
//    A stage holds one PD-deep chunk of the contraction for every plane in
//    play (PD = 128/D bytes for D <= 4, else 32; a row of 128 or 256 bytes,
//    so the loaders' index arithmetic is shifts), so the planes of a
//    product sit side by side and are OR-ed in registers after ldmatrix.
//  * Tiles: 128 x 128 (8 warps of 64 x 32) for the deep taps; 128 x 64 where
//    N <= 64 (conv1_x: no tensor work on absent columns); 16 x 128 where
//    M <= 16 (the FC layers at small batch: no work on empty rows), with the
//    contraction split over blocks until every SM holds resident blocks
//    (split-K, int32 atomics, exact in any order), so that the weight
//    stream keeps enough bytes in flight.
//  * Operands that are not 16-byte aligned (conv1_1's K = 3, ragged tests)
//    are staged with plain loads, two stages, one barrier a stage; conv1_1's
//    four 3-deep planes then cost one k32 mma per tile and step.
// Not yet: wgmma, TMA, a persistent grid, and a raw-operand A that would
// drop the D-times-wider activation stacks.
//
// int16 stacks (n_bits 9-16) take the entry l2r_stacked_gemm16: the same
// products on the same tensor cores through the byte split, each int16
// product four int8 products (l2r_gemm16.cuh).
//
// The kernel adds into C, which the caller initialises.  The launch uses the
// caller's stream, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "l2r_gemm16.cuh"

namespace {

using l2r::cp_async16;
using l2r::cp_async_commit;
using l2r::cp_async_wait;
using l2r::ldmatrix_x4;

constexpr int kThreads = 256;      // 8 warps
constexpr int kMaxProducts = 64;   // D^2 plane pairs for D <= 8
constexpr int kPad = 16;           // bytes after each shared row

struct Plan {
  int d, k;                        // planes, contraction length of one plane
  int pd, pd_log;                  // bytes of each plane in one stage
  int rb, rb_log;                  // staged bytes of a row: 128 or 256
  int a_lo, a_hi, b_lo, b_hi;      // planes staged for A and for B
  int n;                           // products
  uint8_t il[kMaxProducts], ih[kMaxProducts];  // A plane range of product p
  uint8_t jl[kMaxProducts], jh[kMaxProducts];  // B plane range of product p
};

// MT x NT m16n8 tiles per warp, WARPS_M x (8 / WARPS_M) warps: a BM x BN
// tile per block.  ASYNC: cp.async ring of STAGES (16-aligned operands);
// otherwise plain loads into two stages.  A is (M, lda) row-major, Bt the
// K-major B stack (N, ldb); plane p of a row starts at byte p*K of A and at
// byte (D-1-p)*K of Bt.
template <int MT, int NT, int WARPS_M, int STAGES, bool ASYNC>
__global__ void __launch_bounds__(kThreads)
stacked_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
               int32_t* __restrict__ C, int M, int N, int lda, int ldb,
               Plan pl, int steps_per_split) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int BM = MT * 16 * WARPS_M;
  constexpr int BN = NT * 8 * WARPS_N;
  static_assert(NT % 2 == 0, "ldmatrix.x4 fills two n8 tiles");
  extern __shared__ __align__(16) int8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int pitch = pl.rb + kPad;
  const int slot_bytes = (BM + BN) * pitch;
  const int steps = (pl.k + pl.pd - 1) / pl.pd;
  const int step_lo = blockIdx.z * steps_per_split;
  const int step_hi = min(steps, step_lo + steps_per_split);

  // the sum starts from C where one block owns its elements (the conv's
  // tap sum: C's read overlaps the first copies) and from 0 where the
  // contraction is split and the blocks add atomically
  const bool atomic = gridDim.z > 1;
  const bool pairs = N % 2 == 0;  // int2 access to (col, col + 1)
  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * NT * 8 + j * 8 + t * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * MT * 16 + i * 16 + g + h * 8;
        int v0 = 0, v1 = 0;
        if (!atomic && row < M) {
          const int32_t* p = C + (size_t)row * N + col;
          if (pairs && col + 1 < N) {
            const int2 c = *reinterpret_cast<const int2*>(p);
            v0 = c.x;
            v1 = c.y;
          } else {
            if (col < N) v0 = p[0];
            if (col + 1 < N) v1 = p[1];
          }
        }
        acc[i][j][2 * h] = v0;
        acc[i][j][2 * h + 1] = v1;
      }
    }

  // stage the chunk `step` (bytes [step*pd, step*pd + pd) of every plane in
  // play) into slot `slot`: A rows then B rows, plane p at row byte p*pd.
  // A row is rb = 2^rb_log bytes; pieces of planes out of play are skipped.
  auto load = [&](int slot, int step) {
    int8_t* sa = smem + slot * slot_bytes;
    int8_t* sb = sa + BM * pitch;
    const int k0 = step * pl.pd;
    if (ASYNC) {  // 16-byte pieces
      const int row_log = pl.rb_log - 4, pd_log = pl.pd_log - 4;
      const int per_row = 1 << row_log;
      for (int v = tid; v < (BM + BN) * per_row; v += kThreads) {
        const bool is_a = v < BM * per_row;
        const int r = (is_a ? v : v - BM * per_row) >> row_log;
        const int piece = v & (per_row - 1);
        const int p = piece >> pd_log, c = (piece & ((1 << pd_log) - 1)) * 16;
        if (p < (is_a ? pl.a_lo : pl.b_lo) || p > (is_a ? pl.a_hi : pl.b_hi))
          continue;
        int8_t* dst = (is_a ? sa : sb) + r * pitch + p * pl.pd + c;
        const bool ok = (is_a ? m0 + r < M : n0 + r < N) && k0 + c < pl.k;
        const int8_t* src =
            is_a ? A + (size_t)(m0 + r) * lda + p * pl.k + k0 + c
                 : Bt + (size_t)(n0 + r) * ldb + (pl.d - 1 - p) * pl.k + k0 + c;
        cp_async16(dst, ok ? src : A, ok);
      }
    } else {  // 4-byte words assembled from byte loads: any K, any alignment
      const int row_log = pl.rb_log - 2, pd_log = pl.pd_log - 2;
      const int per_row = 1 << row_log;
      for (int v = tid; v < (BM + BN) * per_row; v += kThreads) {
        const bool is_a = v < BM * per_row;
        const int r = (is_a ? v : v - BM * per_row) >> row_log;
        const int word = v & (per_row - 1);
        const int p = word >> pd_log, c = (word & ((1 << pd_log) - 1)) * 4;
        if (p < (is_a ? pl.a_lo : pl.b_lo) || p > (is_a ? pl.a_hi : pl.b_hi))
          continue;
        uint32_t w = 0;
        if (is_a ? m0 + r < M : n0 + r < N) {
          const int8_t* src =
              is_a ? A + (size_t)(m0 + r) * lda + p * pl.k
                   : Bt + (size_t)(n0 + r) * ldb + (pl.d - 1 - p) * pl.k;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + c + e < pl.k)
              w |= (uint32_t)(uint8_t)src[k0 + c + e] << (8 * e);
        }
        *reinterpret_cast<uint32_t*>((is_a ? sa : sb) + r * pitch + p * pl.pd +
                                     c) = w;
      }
    }
  };

  // ldmatrix row of this lane: A x4 = rows 0-7 / 8-15 at k bytes 0-15 /
  // 16-31 (a0..a3); B x4 = n 0-7 at k 0-15 / 16-31, then n 8-15 (b0, b1 of
  // two n8 tiles)
  const int a_row = wm * MT * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int b_row = wn * NT * 8 + (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;

  auto compute = [&](int slot) {
    const int8_t* sa = smem + slot * slot_bytes;
    const int8_t* sb = sa + BM * pitch;
    for (int kk = 0; kk < pl.pd; kk += 32) {
      for (int p = 0; p < pl.n; ++p) {
        uint32_t bf[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) bf[j][0] = bf[j][1] = 0;
        for (int pj = pl.jl[p]; pj <= pl.jh[p]; ++pj) {
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t r[4];
            ldmatrix_x4(r, sb + (b_row + j * 8) * pitch + pj * pl.pd + kk + b_col);
            bf[j][0] |= r[0];
            bf[j][1] |= r[1];
            bf[j + 1][0] |= r[2];
            bf[j + 1][1] |= r[3];
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t af[4] = {0, 0, 0, 0};
          for (int pi = pl.il[p]; pi <= pl.ih[p]; ++pi) {
            uint32_t r[4];
            ldmatrix_x4(r, sa + (a_row + i * 16) * pitch + pi * pl.pd + kk + a_col);
#pragma unroll
            for (int q = 0; q < 4; ++q) af[q] |= r[q];
          }
#pragma unroll
          for (int j = 0; j < NT; ++j)
            l2r::mma_s8(acc[i][j], af, bf[j][0], bf[j][1]);
        }
      }
    }
  };

  if (ASYNC) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (step_lo + s < step_hi) load(s, step_lo + s);
      cp_async_commit();
    }
    for (int step = step_lo; step < step_hi; ++step) {
      const int it = step - step_lo;
      cp_async_wait<STAGES - 2>();  // chunk `step` has landed
      __syncthreads();              // ... for every thread; and the slot
                                    // read one step ago is free
      if (step + STAGES - 1 < step_hi)
        load((it + STAGES - 1) % STAGES, step + STAGES - 1);
      cp_async_commit();
      compute(it % STAGES);
    }
  } else {
    for (int step = step_lo; step < step_hi; ++step) {
      const int slot = (step - step_lo) & 1;  // read two steps ago: free
      load(slot, step);
      __syncthreads();
      compute(slot);
    }
  }

  // epilogue: C = acc (the block owns the elements) or C += acc atomically,
  // two neighbouring columns a thread and row
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * NT * 8 + j * 8 + t * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * MT * 16 + i * 16 + g + h * 8;
        if (row >= M) continue;
        int32_t* p = C + (size_t)row * N + col;
        const int v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (atomic) {
          if (col < N) atomicAdd((unsigned int*)p, (unsigned int)v0);
          if (col + 1 < N) atomicAdd((unsigned int*)p + 1, (unsigned int)v1);
        } else if (pairs && col + 1 < N) {
          *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
        } else {
          if (col < N) p[0] = v0;
          if (col + 1 < N) p[1] = v1;
        }
      }
    }
  }
}

template <int MT, int NT, int WARPS_M, int STAGES>
cudaError_t launch(bool async, int m, int n, cudaStream_t stream,
                   const int8_t* a, const int8_t* bt, int32_t* c, int lda,
                   int ldb, const Plan& pl) {
  constexpr int BM = MT * 16 * WARPS_M, BN = NT * 8 * (8 / WARPS_M);
  void (*kern)(const int8_t*, const int8_t*, int32_t*, int, int, int, int,
               Plan, int) =
      async ? &stacked_kernel<MT, NT, WARPS_M, STAGES, true>
            : &stacked_kernel<MT, NT, WARPS_M, STAGES, false>;
  const int smem = (async ? STAGES : 2) * (BM + BN) * (pl.rb + kPad);
  // the attribute and the occupancy, once per card, kernel and row width
  static int cached_dev = -1, sms = 0, cached_smem[2] = {0, 0},
             per_sm[2] = {0, 0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached_dev = dev;
    cached_smem[0] = cached_smem[1] = 0;
  }
  if (cached_smem[async] != smem) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[async], kern,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    cached_smem[async] = smem;
  }
  // split the contraction over blocks when the output tiles alone leave
  // SMs empty (the FC layers at small batch): as many splits as keep the
  // grid within one wave of resident blocks; at least 4 chunks a split
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int steps = (pl.k + pl.pd - 1) / pl.pd;
  const int want = std::max(per_sm[async], 1) * sms / tiles;
  const int splits = std::max(1, std::min(want, steps / 4));
  const int per = (steps + splits - 1) / splits;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, (steps + per - 1) / per);
  kern<<<grid, kThreads, smem, stream>>>(a, bt, c, m, n, lda, ldb, pl, per);
  return cudaGetLastError();
}

// the tile by problem shape; a ring of two stages where the contraction is
// two chunks or fewer (conv1_x, conv2_1: smaller blocks, more of them
// resident), else three (four for the weight-stream tile)
template <int MT, int NT, int WARPS_M, int STAGES>
cudaError_t launch_tile(bool async, int m, int n, cudaStream_t stream,
                        const int8_t* a, const int8_t* bt, int32_t* c, int lda,
                        int ldb, const Plan& pl) {
  if ((pl.k + pl.pd - 1) / pl.pd <= 2)
    return launch<MT, NT, WARPS_M, 2>(async, m, n, stream, a, bt, c, lda, ldb,
                                      pl);
  return launch<MT, NT, WARPS_M, STAGES>(async, m, n, stream, a, bt, c, lda,
                                         ldb, pl);
}

}  // namespace

// C (m, n) int32 += the plane-range products over a (m, lda) and bt (n, ldb),
// both int8 with D planes of k bytes a row (A ascending from byte 0, bt the
// K-major B stack, plane j at byte (D-1-j)*k).  Product p is A planes
// [il[p], ih[p]] against B planes [jl[p], jh[p]].  C must hold the sum to add
// to (zeros for a plain product).  Returns a cudaError_t as int: 0 when the
// launch was accepted.
extern "C" int l2r_stacked_gemm(const void* a, const void* bt, void* c, int m,
                                int n, int lda, int ldb, int d, int k,
                                int n_products, const int* il, const int* ih,
                                const int* jl, const int* jh, void* stream) {
  if (m < 1 || n < 1 || k < 1 || d < 1 || d > 8 || n_products < 1 ||
      n_products > kMaxProducts || lda < d * k || ldb < d * k)
    return (int)cudaErrorInvalidValue;
  Plan pl = {};
  pl.d = d;
  pl.k = k;
  pl.pd = (d <= 4 && 128 % d == 0) ? 128 / d : 32;
  pl.pd_log = pl.pd == 128 ? 7 : pl.pd == 64 ? 6 : 5;
  pl.rb = d * pl.pd <= 128 ? 128 : 256;
  pl.rb_log = pl.rb == 128 ? 7 : 8;
  pl.a_lo = pl.b_lo = d;
  pl.a_hi = pl.b_hi = -1;
  pl.n = n_products;
  for (int p = 0; p < n_products; ++p) {
    if (il[p] < 0 || il[p] > ih[p] || ih[p] >= d || jl[p] < 0 ||
        jl[p] > jh[p] || jh[p] >= d)
      return (int)cudaErrorInvalidValue;
    pl.il[p] = (uint8_t)il[p];
    pl.ih[p] = (uint8_t)ih[p];
    pl.jl[p] = (uint8_t)jl[p];
    pl.jh[p] = (uint8_t)jh[p];
    pl.a_lo = std::min(pl.a_lo, il[p]);
    pl.a_hi = std::max(pl.a_hi, ih[p]);
    pl.b_lo = std::min(pl.b_lo, jl[p]);
    pl.b_hi = std::max(pl.b_hi, jh[p]);
  }
  const bool async = k % 16 == 0 && lda % 16 == 0 && ldb % 16 == 0 &&
                     (uintptr_t)a % 16 == 0 && (uintptr_t)bt % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* pa = (const int8_t*)a;
  const auto* pb = (const int8_t*)bt;
  auto* pc = (int32_t*)c;
  if (m <= 16)
    return launch_tile<1, 2, 1, 4>(async, m, n, s, pa, pb, pc, lda, ldb, pl);
  if (n <= 64)
    return launch_tile<2, 4, 4, 3>(async, m, n, s, pa, pb, pc, lda, ldb, pl);
  return launch_tile<4, 4, 2, 3>(async, m, n, s, pa, pb, pc, lda, ldb, pl);
}

namespace {

// The int16 route (l2r_gemm16.cuh), one instantiation a tile
template <int MT, int NT, int WARPS_M, int STAGES, bool ASYNC>
__global__ void __launch_bounds__(gemm16::kThreads)
stacked16_kernel(const int16_t* __restrict__ A, const int16_t* __restrict__ Bt,
                 int32_t* __restrict__ C, int M, int N, int lda, int ldb,
                 const __grid_constant__ gemm16::Plan pl, int chunks_per_split,
                 int overwrite) {
  gemm16::body<false, MT, NT, WARPS_M, STAGES, ASYNC>(
      A, Bt, C, M, N, lda, ldb, pl, chunks_per_split, overwrite != 0);
}

template <int MT, int NT, int WARPS_M, int STAGES>
cudaError_t launch16(bool async, int m, int n, int lda, int ldb,
                     const gemm16::Plan& pl, cudaStream_t s, const int16_t* a,
                     const int16_t* bt, int32_t* c) {
  return gemm16::launch<false, MT * 16 * WARPS_M, NT * 8 * (8 / WARPS_M),
                        STAGES>(
      &stacked16_kernel<MT, NT, WARPS_M, STAGES, true>,
      &stacked16_kernel<MT, NT, WARPS_M, STAGES, false>, async, m, n, lda,
      ldb, pl, false, s, a, bt, c);
}

}  // namespace

// The int16 route: C (m, n) int32 += the plane-range products over int16
// stacks a (m, lda) and bt (n, ldb), laid out as above (elements, not bytes),
// D <= 16, on the tensor cores through the byte split (l2r_gemm16.cuh).
// Returns a cudaError_t as int.
extern "C" int l2r_stacked_gemm16(const void* a, const void* bt, void* c,
                                  int m, int n, int lda, int ldb, int d, int k,
                                  int n_products, const int* il, const int* ih,
                                  const int* jl, const int* jh, void* stream) {
  if (m < 1 || n < 1 || k < 1 || d < 1 || d > 16 || n_products < 1 ||
      n_products > gemm16::kMaxProducts || lda < d * k || ldb < d * k)
    return (int)cudaErrorInvalidValue;
  gemm16::Plan pl = {};
  pl.n = n_products;
  pl.d = d;
  pl.k = k;
  for (int p = 0; p < n_products; ++p) {
    if (il[p] < 0 || il[p] > ih[p] || ih[p] >= d || jl[p] < 0 ||
        jl[p] > jh[p] || jh[p] >= d)
      return (int)cudaErrorInvalidValue;
    pl.il[p] = (uint8_t)il[p];
    pl.ih[p] = (uint8_t)ih[p];
    pl.jl[p] = (uint8_t)jl[p];
    pl.jh[p] = (uint8_t)jh[p];
  }
  pl.g = gemm16::slots(pl);
  const bool async = k % 8 == 0 && lda % 8 == 0 && ldb % 8 == 0 &&
                     (uintptr_t)a % 16 == 0 && (uintptr_t)bt % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* pa = (const int16_t*)a;
  const auto* pb = (const int16_t*)bt;
  auto* pc = (int32_t*)c;
  if (m <= 16)  // 16 x 128
    return launch16<1, 2, 1, 3>(async, m, n, lda, ldb, pl, s, pa, pb, pc);
  if (n <= 64)  // 128 x 64
    return launch16<2, 4, 4, 4>(async, m, n, lda, ldb, pl, s, pa, pb, pc);
  return launch16<2, 4, 2, 4>(async, m, n, lda, ldb, pl, s, pa, pb, pc);
}
