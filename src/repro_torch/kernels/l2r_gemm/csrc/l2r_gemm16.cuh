// The int16 routes of kernels B1 and B3 (n_bits 9-16) on the int8 tensor
// cores: the body of l2r_stacked_gemm16 (l2r_stacked_gemm.cu) and of
// l2r_pairs_gemm16 (l2r_pairs_gemm.cu).
//
// Each product p of the walk (the host's msdf_products for B1, pairs_plan's
// masks for B3) is
//
//     C += (OR of A planes [il, ih] & ma) . (OR of B planes [jl, jh] & mb)
//
// over the contraction.  A pre-shifted int16 plane is a bit-field of its
// operand, so a plane range is the OR of its planes and fits int16; B3 runs
// on the raw operands (one plane) under plane_bits' 16-bit masks.  Every
// int16 product runs as its byte split (l2r_byte_split.cuh): four
// mma.sync.m16n8k32 a k32 step into three s32 accumulators.
//
// Bound on this card (H100 SXM data sheet: int8 1,979 TOP/s dense, HBM
// 3.35 TB/s): four int8 products an int16 product, the operands read once
// and C written once.  At batch 8 every VGG-16 GEMM is bound by bytes: the
// convs by the D-plane A stack and the int32 tap sum, fc6-fc8 by the weight
// stream (fc6 at D = 3: 616 MB, 0.184 ms).  What the design does about it:
//  * A step stages 32 contraction elements (64 bytes) of up to 4 planes of
//    each operand (as many slots as the walk's widest plane range), side by
//    side in a shared row padded by 16 bytes (ldmatrix reads 8 rows on 8
//    bank groups), through a cp.async ring (16 bytes a thread, zero fill
//    past the ragged M, N and K edges) of 3 stages for the 16-row tile (two
//    blocks an SM) and 4 otherwise, one __syncthreads a step.
//    A product's planes are OR-ed in registers after ldmatrix; a product
//    over more than 4 planes (D 8 and 16) takes several steps a chunk, its
//    fragments OR-ed across them.  The products run one after another, each
//    a pass over the block's share of the contraction: a prefix at full
//    depth is one product, so every plane is read once; a level slab is its
//    plane pairs, each reading its two planes.
//  * B1 reads B as the K-major stack the weight cache holds (non-transposed
//    ldmatrix); B3 reads its row-major (K, N) weights in place and
//    transposes on the way out of shared memory (ldmatrix.trans on b16: a
//    lane gets two consecutive k of one column, as the K-major load does).
//  * The fold: a byte accumulator moves by at most 2 * 128 * 255 an element
//    of contraction, so after 1,024 passes of 32 elements (32,768) the
//    three are folded into C (unsigned: (hh << 16) + (cr << 8) + ll) and
//    cleared.  The exactness never rests on how mma wraps; the sum wraps
//    mod 2^32 as the reference's int32 dot does, in any order.
//  * Tiles of 8 warps: 16 x 128 (warps of 16 x 16) where M <= 16, with the
//    contraction split over blocks until a wave of resident blocks is full
//    (split-K, int32 atomics); 128 x 64 where N <= 64 and 64 x 128
//    elsewhere (warps of 32 x 32: three accumulator sets of 32 registers).
//    Column tiles run fastest, so the blocks that read one A row band run
//    together and read it from L2.
//  * Operands that are not 16-byte aligned (conv1_1's K = 3, ragged tests)
//    are staged with element loads, two stages, into the same layout: only
//    the words that hold contraction elements, up to 8 a thread in one
//    round trip before their stores (conv1_1: one for all six planes).
//  * The fold reads the C it adds to in one batch before it writes.
// Not yet: wgmma, TMA, a persistent grid, and a raw-operand A for B1.

#pragma once

#include <algorithm>

#include "l2r_byte_split.cuh"

namespace gemm16 {

constexpr int kThreads = 256;      // 8 warps
constexpr int kBK = 32;            // contraction elements of a plane a step
constexpr int kRowPlane = 2 * kBK; // bytes of a plane in a staged row
constexpr int kPad = 16;           // bytes after each shared row
constexpr int kMaxProducts = 256;  // D^2 plane pairs for D <= 16
constexpr int kMaxMasked = 16;     // B3: a prefix is at most D <= 16 products
constexpr int kFoldPasses = 1024;  // passes of kBK between folds: 32,768

struct Plan {
  int n;       // products
  int d, k;    // planes (1 for raw operands), elements of a plane
  int g;       // plane slots a step: 1-4
  uint8_t il[kMaxProducts], ih[kMaxProducts];  // A plane range of product p
  uint8_t jl[kMaxProducts], jh[kMaxProducts];  // B plane range of product p
  uint32_t ma[kMaxMasked], mb[kMaxMasked];     // raw operands: masks in both
                                               // halves of a word
};

// Plane slots a step: the walk's widest plane range, at most 4
inline int slots(const Plan& pl) {
  int w = 0;
  for (int p = 0; p < pl.n; ++p)
    w = std::max({w, pl.ih[p] - pl.il[p], pl.jh[p] - pl.jl[p]});
  return std::min(w + 1, 4);
}

// Shared bytes of one stage: A's BM rows, then B (BN K-major rows, or kBK
// k rows of the row-major operand)
template <bool ROW_B, int BM, int BN>
__host__ __device__ constexpr int stage_bytes(int g) {
  return BM * (kRowPlane * g + kPad) +
         (ROW_B ? kBK * (BN * 2 + kPad) : BN * (kRowPlane * g + kPad));
}

// The walk's position: product p, chunk c of the contraction, plane group q
struct Step {
  int p, c, q;
};

// Stage ROWS rows of one plane's kBK elements (src: row 0 at the chunk's
// first element, rows `ld` apart; rows >= n_rows and elements >= n_k read
// as 0) at dst (rows `pitch` bytes apart) in 16-byte cp.async pieces
template <int ROWS>
__device__ __forceinline__ void stage_plane(int8_t* dst, int pitch,
                                            const int16_t* src, long long ld,
                                            int n_rows, int n_k,
                                            const int16_t* any) {
  for (int v = threadIdx.x; v < ROWS * 4; v += kThreads) {
    const int r = v >> 2, c = (v & 3) * 8;
    const bool ok = r < n_rows && c < n_k;
    l2r::cp_async16(dst + r * pitch + c * 2,
                    ok ? (const void*)(src + r * ld + c) : (const void*)any,
                    ok);
  }
}

// The body of a B1 (ROW_B false) or B3 (ROW_B true) int16 launch over one
// BM x BN tile of C and its share of the contraction.  A is (M, lda) with
// plane i at element i * k of a row; B is the K-major stack (N, ldb) with
// plane j at element (d - 1 - j) * k, or (ROW_B) the row-major (k, N) raw
// operand.  C += the products; with `overwrite` (B3 unsplit) the first fold
// stores instead; a split launch (gridDim.z > 1) adds atomically.
template <bool ROW_B, int MT, int NT, int WARPS_M, int STAGES, bool ASYNC>
__device__ __forceinline__ void body(const int16_t* __restrict__ A,
                                     const int16_t* __restrict__ B,
                                     int32_t* __restrict__ C, int M, int N,
                                     int lda, int ldb, const Plan& pl,
                                     int chunks_per_split, bool overwrite) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int BM = MT * 16 * WARPS_M;
  constexpr int BN = NT * 8 * WARPS_N;
  constexpr int BPITCH = BN * 2 + kPad;  // ROW_B: a k row of B
  extern __shared__ __align__(16) int8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = blockIdx.x / n_tiles * BM, n0 = blockIdx.x % n_tiles * BN;
  const int G = pl.g;
  const int pitch = kRowPlane * G + kPad;
  const int slot_bytes = stage_bytes<ROW_B, BM, BN>(G);
  const int chunks = (pl.k + kBK - 1) / kBK;
  const int c_lo = blockIdx.z * chunks_per_split;
  const int c_hi = min(chunks, c_lo + chunks_per_split);
  const bool atomic = gridDim.z > 1;

  // plane groups of product p: ceil(widest range / G)
  auto groups = [&](int p) {
    return (max(pl.ih[p] - pl.il[p], pl.jh[p] - pl.jl[p]) + G) / G;
  };
  auto advance = [&](Step& s) {
    if (++s.q < groups(s.p)) return true;
    s.q = 0;
    if (++s.c < c_hi) return true;
    s.c = c_lo;
    return ++s.p < pl.n;
  };

  // stage step s into `slot`: plane slot e of a row holds plane lo + e of
  // the step's group; slots past the product's range are left as they are
  // (compute reads only the range)
  auto load = [&](int slot, const Step& s) {
    int8_t* sa = smem + slot * slot_bytes;
    int8_t* sb = sa + BM * pitch;
    const int k0 = s.c * kBK, n_k = pl.k - k0;
    const int a_lo = pl.il[s.p] + s.q * G, b_lo = pl.jl[s.p] + s.q * G;
    // planes of this step (none past the shorter range of a product)
    const int a_n = max(0, min(G, pl.ih[s.p] - a_lo + 1));
    const int b_n = max(0, min(G, pl.jh[s.p] - b_lo + 1));
    if (ASYNC) {
      for (int e = 0; e < a_n; ++e)
        stage_plane<BM>(sa + e * kRowPlane, pitch,
                        A + (size_t)m0 * lda + (a_lo + e) * pl.k + k0, lda,
                        M - m0, n_k, A);
      if (!ROW_B)
        for (int e = 0; e < b_n; ++e)
          stage_plane<BN>(
              sb + e * kRowPlane, pitch,
              B + (size_t)n0 * ldb + (pl.d - 1 - b_lo - e) * pl.k + k0, ldb,
              N - n0, n_k, A);
      else  // kBK k rows of BN columns; N a multiple of 8
        for (int v = tid; v < kBK * (BN / 8); v += kThreads) {
          const int kr = v / (BN / 8), c = (v % (BN / 8)) * 8;
          const bool ok = kr < n_k && n0 + c < N;
          l2r::cp_async16(sb + kr * BPITCH + c * 2,
                          ok ? (const void*)(B + (size_t)(k0 + kr) * ldb +
                                             n0 + c)
                             : (const void*)B,
                          ok);
        }
      return;
    }
    // Plain loads (any alignment).  Item x is one word (two elements) that
    // holds contraction elements, of a row of a plane: A's planes, then the
    // K-major B's.  A thread loads up to 8 items before it stores them, so
    // a narrow contraction (conv1_1's K = 3: 2 words a row) takes one round
    // trip for every plane of both operands.  B's words past the
    // contraction are zeroed (A's are left as they are: their products
    // with B's zeros add nothing).
    const int wk = (min(n_k, kBK) + 1) / 2;  // words a row holding elements
    const int a_items = a_n * BM * wk;
    const int items = a_items + (ROW_B ? 0 : b_n * BN * wk);
    for (int base = tid; base < items; base += 8 * kThreads) {
      uint32_t w[8];
      int off[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int x = base + u * kThreads;
        w[u] = 0;
        off[u] = -1;
        if (x >= items) continue;
        const bool is_a = x < a_items;
        const int y = is_a ? x : x - a_items, rows = is_a ? BM : BN;
        const int e = y / (rows * wk), rem = y % (rows * wk);
        const int r = rem / wk, c = rem % wk * 2;
        off[u] = (is_a ? 0 : BM * pitch) + r * pitch + e * kRowPlane + c * 2;
        const int row = (is_a ? m0 : n0) + r;
        if (row >= (is_a ? M : N)) continue;
        const int16_t* src =
            is_a ? A + (size_t)row * lda + (a_lo + e) * pl.k + k0 + c
                 : B + (size_t)row * ldb + (pl.d - 1 - b_lo - e) * pl.k + k0 +
                       c;
        w[u] = (uint16_t)src[0];
        if (c + 1 < n_k) w[u] |= (uint32_t)(uint16_t)src[1] << 16;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (off[u] >= 0) *reinterpret_cast<uint32_t*>(sa + off[u]) = w[u];
    }
    if (!ROW_B) {
      const int zw = kBK / 2 - wk;  // B's words past the contraction
      for (int v = tid; v < b_n * BN * zw; v += kThreads) {
        const int e = v / (BN * zw), rem = v % (BN * zw);
        *reinterpret_cast<uint32_t*>(sb + rem / zw * pitch + e * kRowPlane +
                                     (wk + rem % zw) * 4) = 0;
      }
      return;
    }
    constexpr int NW = kBK * (BN / 2) / kThreads;  // B3: words a thread
    uint32_t w[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int v = tid + i * kThreads;
      const int kr = v / (BN / 2), c = (v % (BN / 2)) * 2;
      w[i] = 0;
      if (kr < n_k)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (n0 + c + h < N)
            w[i] |= (uint32_t)(uint16_t)B[(size_t)(k0 + kr) * ldb + n0 + c + h]
                    << (16 * h);
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint32_t*>(sb + v / (BN / 2) * BPITCH +
                                   (v % (BN / 2)) * 4) = w[i];
    }
  };

  // ldmatrix rows of this lane.  A (two x4 a 16-row tile, bytes 0-31 and
  // 32-63 of a plane): rows 0-7 / 8-15 at elements 0-7 / 8-15.  B K-major
  // (x4 an 8-column tile): column lane & 7, elements 8 (lane >> 3) on.
  // B row-major (x4.trans): k row `lane`, the tile's 8 columns.
  const int a_row = wm * MT * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int b_row = wn * NT * 8 + (lane & 7);
  const int b_col = (lane >> 3) * 16;

  int hh[MT][NT][4], cr[MT][NT][4], ll[MT][NT][4];
  uint32_t af[MT][8], bf[NT][4];  // a product's fragments, planes OR-ed
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hh[i][j][e] = cr[i][j][e] = ll[i][j][e] = 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) af[i][e] = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) bf[j][e] = 0;

  // C += the byte accumulators (stored at the first fold with `overwrite`),
  // two neighbouring columns a thread and row, the C it adds to read in one
  // batch first; then clear them
  bool first = true;
  auto fold = [&]() {
    const bool pairs = N % 2 == 0;
    const bool add = !atomic && !(overwrite && first);
    uint32_t old[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * NT * 8 + j * 8 + t * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * MT * 16 + i * 16 + g + h * 8;
          const uint32_t* p =
              reinterpret_cast<const uint32_t*>(C + (size_t)row * N + col);
          uint32_t v0 = 0, v1 = 0;
          if (add && row < M) {
            if (pairs && col + 1 < N) {
              const uint2 c = *reinterpret_cast<const uint2*>(p);
              v0 = c.x;
              v1 = c.y;
            } else {
              if (col < N) v0 = p[0];
              if (col + 1 < N) v1 = p[1];
            }
          }
          old[i][j][2 * h] = v0;
          old[i][j][2 * h + 1] = v1;
        }
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * NT * 8 + j * 8 + t * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * MT * 16 + i * 16 + g + h * 8;
          uint32_t v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 2 * h + e;
            v[e] = old[i][j][x] +
                   l2r::combine(hh[i][j][x], cr[i][j][x], ll[i][j][x]);
            hh[i][j][x] = cr[i][j][x] = ll[i][j][x] = 0;
          }
          if (row >= M) continue;
          uint32_t* p = reinterpret_cast<uint32_t*>(C + (size_t)row * N + col);
          if (atomic) {
            if (col < N) atomicAdd(p, v[0]);
            if (col + 1 < N) atomicAdd(p + 1, v[1]);
          } else if (pairs && col + 1 < N) {
            *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
          } else {
            if (col < N) p[0] = v[0];
            if (col + 1 < N) p[1] = v[1];
          }
        }
      }
    first = false;
  };

  // step s from `slot`: OR its planes into the fragments; at the product's
  // last plane group, its byte-split products; a fold every kFoldPasses
  int passes = 0;
  auto compute = [&](int slot, const Step& s) {
    const int8_t* sa = smem + slot * slot_bytes;
    const int8_t* sb = sa + BM * pitch;
    const int a_n = min(G, pl.ih[s.p] - pl.il[s.p] - s.q * G + 1);
    const int b_n = min(G, pl.jh[s.p] - pl.jl[s.p] - s.q * G + 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < a_n)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int8_t* p = sa + (a_row + i * 16) * pitch + e * kRowPlane + a_col;
          uint32_t r[4];
          l2r::ldmatrix_x4(r, p);
#pragma unroll
          for (int q = 0; q < 4; ++q) af[i][q] |= r[q];
          l2r::ldmatrix_x4(r, p + 32);
#pragma unroll
          for (int q = 0; q < 4; ++q) af[i][4 + q] |= r[q];
        }
      if (!ROW_B && e < b_n)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t r[4];
          l2r::ldmatrix_x4(r, sb + (b_row + j * 8) * pitch + e * kRowPlane +
                                  b_col);
#pragma unroll
          for (int q = 0; q < 4; ++q) bf[j][q] |= r[q];
        }
    }
    if (ROW_B)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        l2r::ldmatrix_x4_trans(bf[j],
                               sb + lane * BPITCH + (wn * NT * 8 + j * 8) * 2);
    if (s.q + 1 < groups(s.p)) return;
    const uint32_t ma = ROW_B ? pl.ma[s.p] : ~0u;
    const uint32_t mb = ROW_B ? pl.mb[s.p] : ~0u;
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      l2r::split_b(bf[j], mb, bh[j], bl[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) bf[j][e] = 0;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t ah[4], al[4];
      l2r::split_a(af[i], ma, ah, al);
#pragma unroll
      for (int e = 0; e < 8; ++e) af[i][e] = 0;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        l2r::mma_bytes(hh[i][j], cr[i][j], ll[i][j], ah, al, bh[j], bl[j]);
    }
    if (++passes == kFoldPasses) {
      fold();
      passes = 0;
    }
  };

  Step st = {0, c_lo, 0};
  if (ASYNC) {
    Step ld = st;
    bool more = true;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (more) {
        load(s, ld);
        more = advance(ld);
      }
      l2r::cp_async_commit();
    }
    for (int it = 0;; ++it) {
      l2r::cp_async_wait<STAGES - 2>();  // step `it` has landed
      __syncthreads();  // ... for every thread; the slot read one step ago
                        // is free
      if (more) {
        load((it + STAGES - 1) % STAGES, ld);
        more = advance(ld);
      }
      l2r::cp_async_commit();
      compute(it % STAGES, st);
      if (!advance(st)) break;
    }
  } else {
    for (int it = 0;; ++it) {
      const int slot = it & 1;  // read two steps ago: free
      load(slot, st);
      __syncthreads();
      compute(slot, st);
      if (!advance(st)) break;
    }
  }
  if (passes) fold();
}

// The attribute and the occupancy of kernel `kern` at the ring's size for g
// plane slots, once per process
template <bool ROW_B, int BM, int BN, int STAGES>
cudaError_t occupancy(const void* kern, bool async, int g, int* per_sm) {
  static int cached[2][5] = {};
  const int stages = async ? STAGES : 2;
  if (!cached[async][1] && !cached[async][2] && !cached[async][3] &&
      !cached[async][4]) {  // room for the widest stage
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        stages * stage_bytes<ROW_B, BM, BN>(4));
    if (err != cudaSuccess) return err;
  }
  if (!cached[async][g]) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached[async][g], kern, kThreads,
        stages * stage_bytes<ROW_B, BM, BN>(g));
    if (err != cudaSuccess) return err;
    cached[async][g] = std::max(cached[async][g], 1);
  }
  *per_sm = cached[async][g];
  return cudaSuccess;
}

using Kernel = void (*)(const int16_t*, const int16_t*, int32_t*, int, int,
                        int, int, Plan, int, int);

// One launch: the tile's kernel (cp.async ring or plain loads), the
// contraction split over blocks while the output tiles alone leave SMs
// empty (up to one wave of resident blocks, at least 4 chunks a split).
// `overwrite` (B3): C is zeroed first where the splits add into it.
template <bool ROW_B, int BM, int BN, int STAGES>
cudaError_t launch(Kernel async_kern, Kernel sync_kern, bool async, int m,
                   int n, int lda, int ldb, const Plan& pl, bool overwrite,
                   cudaStream_t stream, const int16_t* a, const int16_t* b,
                   int32_t* c) {
  const Kernel kern = async ? async_kern : sync_kern;
  int per_sm = 0, sms = 0;
  cudaError_t err = occupancy<ROW_B, BM, BN, STAGES>((const void*)kern, async,
                                                     pl.g, &per_sm);
  if (err != cudaSuccess) return err;
  err = l2r::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int chunks = (pl.k + kBK - 1) / kBK;
  const int want = (int)std::min<long long>(per_sm * sms / tiles, chunks);
  const int splits = std::max(1, std::min(want, chunks / 4));
  const int per = (chunks + splits - 1) / splits;
  const int smem = (async ? STAGES : 2) * stage_bytes<ROW_B, BM, BN>(pl.g);
  const dim3 grid((unsigned)tiles, 1, (chunks + per - 1) / per);
  if (grid.z > 1 && overwrite) {  // the splits add into C
    err = cudaMemsetAsync(c, 0, (size_t)m * n * sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, kThreads, smem, stream>>>(a, b, c, m, n, lda, ldb, pl, per,
                                         overwrite ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace gemm16
