// Kernel B3: the MSDF pair-loop digit-plane GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/l2r_gemm/kernel.py:_l2r_gemm_kernel
// (reached through l2r_gemm_pallas).  On raw int8 operands aq (M, K) and
// bq (K, N), both row-major, it computes the pair loop truncated at `levels`,
//
//     C (M, N) int32 = sum over the plane pairs (i, j) of msdf_pairs(D, levels)
//                      of  (A_i << b*i) @ (B_j << b*j)   (mod 2^32),
//
// as the few plane-range products of the host's msdf_products (a prefix of
// L levels is at most D products, one at full depth):
//
//     C = sum over products p of  (aq & ma[p]) @ (bq & mb[p]).
//
// A pre-shifted plane is a bit-field of its operand (plane i < D-1 keeps bits
// [b*i, b*(i+1)), the top plane the bits from b*(D-1) up with the sign
// extension), so a range of planes is the operand under one byte mask
// (plane_bits) and fits int8; int32 addition wraps and is associative, so
// the collapse, any tiling and any split give the pair loop's bits.  The
// tensor cores accumulate in wrapping s32 (no .satfinite).
//
// Bound on this card (H100 SXM data sheet: int8 1,979 TOP/s dense, HBM
// 3.35 TB/s): 2*M*N*K operations at full depth against M*K + K*N bytes read
// and M*N*4 written.  At the FC head's batch of 8 it streams the weights
// (fc6: 103 MB, 0.031 ms); the conv shapes are bound by their operands and
// int32 output.  What the design does about it:
//  * The weights stay as the cache holds them, row-major (K, N): no copy per
//    call.  Both operands go global -> shared through a cp.async ring (16
//    bytes a thread, zero fill past the ragged M, N and K edges) of 4 stages
//    for the 16-row weight-stream tile and 3 otherwise, one __syncthreads a
//    stage.
//  * The mma's B fragment wants 4 consecutive k of one column; row-major B
//    gives consecutive n.  The transpose happens on the way out of shared
//    memory: ldmatrix.trans on 16-bit pairs of columns, its 8 rows taken at
//    k = {0,1,4,5,8,9,12,13} (+2 for the second matrix), gives each lane two
//    k of two columns per register, and two byte permutes make the k-run of
//    column 2g and of 2g + 1: the even and the odd column of each 16 form
//    two n8 tiles, and a lane's four outputs of a row are 4 adjacent columns
//    (one 16-byte store).  The rows' 16-byte pieces are XOR-swizzled so the
//    8 rows of each matrix fall on 8 bank groups.  A: ldmatrix, rows padded
//    16 bytes.
//  * Tiles: 16 x 128 where M <= 16 (no tensor work on empty rows), 128 x 64
//    where N <= 64, else 128 x 128.  Where the tiles alone leave SMs empty
//    (the FC layers at small batch) the contraction is split over blocks
//    until a wave of resident blocks is full (split-K, int32 atomics into C,
//    which this entry zeroes first).
//  * Operands that are not 16-byte aligned (conv1_1's K = 3, ragged tests)
//    are staged with byte loads, two stages, into the same layout.
//
// int16 operands (n_bits 9-16) take the entry l2r_pairs_gemm16: the same
// products on the same tensor cores through the byte split, each int16
// product four int8 products (l2r_gemm16.cuh).
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <algorithm>

#include "l2r_gemm16.cuh"
#include "l2r_mma.cuh"

namespace {

using namespace l2r;

constexpr int kThreads = 256;        // 8 warps
constexpr int kBK = 64;              // k bytes per stage
constexpr int kApitch = kBK + 16;    // A row pitch: ldmatrix rows on 8 bank groups
constexpr int kMaxProducts = 8;      // a prefix is at most D <= 8 products

struct Plan {
  int n;                             // products
  uint32_t ma[kMaxProducts], mb[kMaxProducts];  // byte masks, in all 4 bytes
};

// the 16-byte piece c of B's shared row k sits at piece c ^ swz(k): the 8 rows
// an ldmatrix.trans reads (k = {0,1,4,5,8,9,12,13} + 0 or 2, mod 16) land on
// 8 distinct bank groups
template <int BN>
__device__ __forceinline__ int swz(int k) {
  return BN >= 128 ? ((k & 1) | ((k >> 1) & 6)) : ((k >> 2) & 3);
}

// MT m16 tiles x NP column pairs of n8 tiles (16 columns: the even ones, the
// odd ones) per warp, WARPS_M x (8 / WARPS_M) warps: a BM x BN tile.
template <int MT, int NP, int WARPS_M, int STAGES>
__global__ void __launch_bounds__(kThreads)
pairs_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
             int32_t* __restrict__ C, int M, int N, int K, Plan pl,
             int steps_per_split, bool async) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int BM = 16 * MT * WARPS_M;
  constexpr int BN = 16 * NP * WARPS_N;
  constexpr int A_BYTES = BM * kApitch;
  constexpr int SLOT = A_BYTES + kBK * BN;
  extern __shared__ __align__(16) int8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int steps = (K + kBK - 1) / kBK;
  const int step_lo = blockIdx.z * steps_per_split;
  const int step_hi = min(steps, step_lo + steps_per_split);
  const bool atomic = gridDim.z > 1;

  int acc[MT][2 * NP][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  // stage k bytes [step*kBK, +kBK) of the A rows and B rows into `slot`
  auto load = [&](int slot, int step) {
    int8_t* sa = smem + slot * SLOT;
    int8_t* sb = sa + A_BYTES;
    const int k0 = step * kBK;
    if (async) {  // 16-byte pieces; K and N are multiples of 16
      for (int v = tid; v < BM * (kBK / 16); v += kThreads) {
        const int r = v >> 2, c = (v & 3) * 16;
        const bool ok = m0 + r < M && k0 + c < K;
        cp_async16(sa + r * kApitch + c,
                   ok ? A + (size_t)(m0 + r) * K + k0 + c : A, ok);
      }
      for (int v = tid; v < kBK * (BN / 16); v += kThreads) {
        const int kr = v / (BN / 16), c = v % (BN / 16);
        const bool ok = k0 + kr < K && n0 + c * 16 < N;
        cp_async16(sb + kr * BN + ((c ^ swz<BN>(kr)) << 4),
                   ok ? B + (size_t)(k0 + kr) * N + n0 + c * 16 : B, ok);
      }
    } else {  // 4-byte words from byte loads: any K, N and alignment
      for (int v = tid; v < BM * (kBK / 4); v += kThreads) {
        const int r = v / (kBK / 4), c = (v % (kBK / 4)) * 4;
        uint32_t w = 0;
        if (m0 + r < M)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + c + e < K)
              w |= (uint32_t)(uint8_t)A[(size_t)(m0 + r) * K + k0 + c + e]
                   << (8 * e);
        *reinterpret_cast<uint32_t*>(sa + r * kApitch + c) = w;
      }
      for (int v = tid; v < kBK * (BN / 4); v += kThreads) {
        const int kr = v / (BN / 4), c = (v % (BN / 4)) * 4;
        uint32_t w = 0;
        if (k0 + kr < K)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n0 + c + e < N)
              w |= (uint32_t)(uint8_t)B[(size_t)(k0 + kr) * N + n0 + c + e]
                   << (8 * e);
        *reinterpret_cast<uint32_t*>(
            sb + kr * BN + (((c >> 4) ^ swz<BN>(kr)) << 4) + (c & 15)) = w;
      }
    }
  };

  // ldmatrix rows of this lane.  A (x4): rows 0-7 / 8-15 at k 0-15 / 16-31.
  // B (x4.trans): matrix q = lane >> 3 holds k rows 16*(q >> 1) + 2*(q & 1) +
  // {0,1,4,5,8,9,12,13}[lane & 7] of a 16-column piece.
  const int a_row = wm * MT * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int q = lane >> 3, r8 = lane & 7;
  const int b_k = 16 * (q >> 1) + 2 * (q & 1) + 4 * (r8 >> 1) + (r8 & 1);

  auto compute = [&](int slot, int kc) {
    const int8_t* sa = smem + slot * SLOT;
    const int8_t* sb = sa + A_BYTES;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      if (ks >= kc) break;
      uint32_t af[MT][4], bf[NP][4];  // bf: even b0, even b1, odd b0, odd b1
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], sa + (a_row + i * 16) * kApitch + ks + a_col);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int k = ks + b_k, piece = wn * NP + p;
        uint32_t x[4];
        ldmatrix_x4_trans(x, sb + k * BN + ((piece ^ swz<BN>(k)) << 4));
        bf[p][0] = __byte_perm(x[0], x[1], 0x6420);
        bf[p][1] = __byte_perm(x[2], x[3], 0x6420);
        bf[p][2] = __byte_perm(x[0], x[1], 0x7531);
        bf[p][3] = __byte_perm(x[2], x[3], 0x7531);
      }
#pragma unroll
      for (int pr = 0; pr < kMaxProducts; ++pr) {
        if (pr >= pl.n) break;
        const uint32_t ma = pl.ma[pr], mb = pl.mb[pr];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint32_t a[4] = {af[i][0] & ma, af[i][1] & ma, af[i][2] & ma,
                                 af[i][3] & ma};
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            mma_s8(acc[i][2 * p], a, bf[p][0] & mb, bf[p][1] & mb);
            mma_s8(acc[i][2 * p + 1], a, bf[p][2] & mb, bf[p][3] & mb);
          }
        }
      }
    }
  };

  if (async) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (step_lo + s < step_hi) load(s, step_lo + s);
      cp_async_commit();
    }
    for (int step = step_lo; step < step_hi; ++step) {
      const int it = step - step_lo;
      cp_async_wait<STAGES - 2>();  // chunk `step` has landed
      __syncthreads();              // ... for every thread; the slot read
                                    // one step ago is free
      if (step + STAGES - 1 < step_hi)
        load((it + STAGES - 1) % STAGES, step + STAGES - 1);
      cp_async_commit();
      compute(it % STAGES, kBK);
    }
  } else {
    for (int step = step_lo; step < step_hi; ++step) {
      const int slot = (step - step_lo) & 1;  // read two steps ago: free
      load(slot, step);
      __syncthreads();
      compute(slot, min(kBK, (K - step * kBK + 31) & ~31));
    }
  }

  // epilogue: a lane holds columns 4t .. 4t+3 of each 16 (even tile: 4t,
  // 4t+2; odd tile: 4t+1, 4t+3) for rows g and g + 8
  const bool vec = N % 4 == 0 && ((uintptr_t)C & 15) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * MT * 16 + i * 16 + g + 8 * h;
        const int col = n0 + (wn * NP + p) * 16 + 4 * t;
        if (row >= M || col >= N) continue;
        const int v[4] = {acc[i][2 * p][2 * h], acc[i][2 * p + 1][2 * h],
                          acc[i][2 * p][2 * h + 1],
                          acc[i][2 * p + 1][2 * h + 1]};
        int32_t* dst = C + (size_t)row * N + col;
        if (atomic) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < N) atomicAdd((unsigned int*)dst + e, (unsigned int)v[e]);
        } else if (vec) {
          *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < N) dst[e] = v[e];
        }
      }
}

template <int MT, int NP, int WARPS_M, int STAGES>
cudaError_t launch(bool async, int m, int n, int k, cudaStream_t stream,
                   const int8_t* a, const int8_t* b, int32_t* c,
                   const Plan& pl) {
  constexpr int BM = 16 * MT * WARPS_M, BN = 16 * NP * (8 / WARPS_M);
  constexpr int SLOT = BM * kApitch + kBK * BN;
  auto* kern = &pairs_kernel<MT, NP, WARPS_M, STAGES>;
  const int smem = (async ? STAGES : 2) * SLOT;
  // the attribute and the occupancy at the ring's size, once per process
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGES * SLOT);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, STAGES * SLOT);
    if (err != cudaSuccess) return err;
    per_sm = std::max(per_sm, 1);
  }
  int sms = 0;
  cudaError_t err = l2r::sm_count(&sms);
  if (err != cudaSuccess) return err;
  // split the contraction over blocks while the output tiles alone leave
  // SMs empty: up to one wave of resident blocks, at least 4 chunks a split
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int steps = (k + kBK - 1) / kBK;
  const int splits = std::max(1, std::min(per_sm * sms / tiles, steps / 4));
  const int per = (steps + splits - 1) / splits;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, (steps + per - 1) / per);
  if (grid.z > 1) {  // the splits add into C
    err = cudaMemsetAsync(c, 0, (size_t)m * n * sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, kThreads, smem, stream>>>(a, b, c, m, n, k, pl, per, async);
  return cudaGetLastError();
}

}  // namespace

// C (m, n) int32 = the sum over products p of (a & ma[p]) @ (b & mb[p]) over
// a (m, k) and b (k, n) raw int8, both row-major; ma, mb are byte masks
// (0..255).  C need not be initialised.  Returns a cudaError_t as int: 0
// when the launch was accepted.
extern "C" int l2r_pairs_gemm(const void* a, const void* b, void* c, int m,
                              int n, int k, int n_products, const int* ma,
                              const int* mb, void* stream) {
  if (m < 1 || n < 1 || k < 1 || n_products < 1 ||
      n_products > kMaxProducts)
    return (int)cudaErrorInvalidValue;
  Plan pl = {};
  pl.n = n_products;
  for (int p = 0; p < n_products; ++p) {
    if (ma[p] < 0 || ma[p] > 255 || mb[p] < 0 || mb[p] > 255)
      return (int)cudaErrorInvalidValue;
    pl.ma[p] = (uint32_t)ma[p] * 0x01010101u;
    pl.mb[p] = (uint32_t)mb[p] * 0x01010101u;
  }
  const bool async = k % 16 == 0 && n % 16 == 0 &&
                     (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* pa = (const int8_t*)a;
  const auto* pb = (const int8_t*)b;
  auto* pc = (int32_t*)c;
  if (m <= 16) return launch<1, 1, 1, 4>(async, m, n, k, s, pa, pb, pc, pl);
  if (n <= 64) return launch<4, 1, 2, 3>(async, m, n, k, s, pa, pb, pc, pl);
  return launch<4, 2, 2, 3>(async, m, n, k, s, pa, pb, pc, pl);
}

namespace {

// The int16 route (l2r_gemm16.cuh), one instantiation a tile
template <int MT, int NT, int WARPS_M, int STAGES, bool ASYNC>
__global__ void __launch_bounds__(gemm16::kThreads)
pairs16_kernel(const int16_t* __restrict__ A, const int16_t* __restrict__ B,
               int32_t* __restrict__ C, int M, int N, int lda, int ldb,
               const __grid_constant__ gemm16::Plan pl, int chunks_per_split,
               int overwrite) {
  gemm16::body<true, MT, NT, WARPS_M, STAGES, ASYNC>(
      A, B, C, M, N, lda, ldb, pl, chunks_per_split, overwrite != 0);
}

template <int MT, int NT, int WARPS_M, int STAGES>
cudaError_t launch16(bool async, int m, int n, int k, const gemm16::Plan& pl,
                     cudaStream_t s, const int16_t* a, const int16_t* b,
                     int32_t* c) {
  return gemm16::launch<true, MT * 16 * WARPS_M, NT * 8 * (8 / WARPS_M),
                        STAGES>(
      &pairs16_kernel<MT, NT, WARPS_M, STAGES, true>,
      &pairs16_kernel<MT, NT, WARPS_M, STAGES, false>, async, m, n, k, n, pl,
      true, s, a, b, c);
}

}  // namespace

// The int16 route (n_bits 9-16): C (m, n) int32 = sum over products p of
// (aq & ma[p]) @ (bq & mb[p]) on raw int16 aq (m, k) and bq (k, n), both
// row-major, 16-bit masks, on the tensor cores through the byte split
// (l2r_gemm16.cuh: B transposed by ldmatrix.trans).  C need not be
// initialised.  Returns a cudaError_t as int.
extern "C" int l2r_pairs_gemm16(const void* a, const void* b, void* c, int m,
                                int n, int k, int n_products, const int* ma,
                                const int* mb, void* stream) {
  if (m < 1 || n < 1 || k < 1 || n_products < 1 ||
      n_products > gemm16::kMaxMasked)
    return (int)cudaErrorInvalidValue;
  gemm16::Plan pl = {};
  pl.n = n_products;
  pl.d = 1;
  pl.k = k;
  pl.g = 1;
  for (int p = 0; p < n_products; ++p) {
    if (ma[p] < 0 || ma[p] > 0xFFFF || mb[p] < 0 || mb[p] > 0xFFFF)
      return (int)cudaErrorInvalidValue;
    pl.ma[p] = (uint32_t)ma[p] * 0x00010001u;
    pl.mb[p] = (uint32_t)mb[p] * 0x00010001u;
  }
  const bool async = k % 8 == 0 && n % 8 == 0 && (uintptr_t)a % 16 == 0 &&
                     (uintptr_t)b % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* pa = (const int16_t*)a;
  const auto* pb = (const int16_t*)b;
  auto* pc = (int32_t*)c;
  if (m <= 16)  // 16 x 128
    return launch16<1, 2, 1, 3>(async, m, n, k, pl, s, pa, pb, pc);
  if (n <= 64)  // 128 x 64
    return launch16<2, 4, 4, 4>(async, m, n, k, pl, s, pa, pb, pc);
  return launch16<2, 4, 2, 4>(async, m, n, k, pl, s, pa, pb, pc);
}
