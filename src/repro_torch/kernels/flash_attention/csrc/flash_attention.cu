// Kernel B5: float flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:_kernel
// (reached through flash_attention_pallas).  q (B, Sq, H, dh), k and v
// (B, Skv, Kv, dh), all f32 or all bf16, kv head = q head // (H / Kv):
//
//   out = softmax(mask(q k^T * scale)) v          (B, Sq, H, dh) in v's dtype
//
// with the causal, window and key-length masks, as an online softmax over KV
// tiles (flash_softmax.cuh holds that half, shared with kernel B4, which
// differs only in how it fills a score tile).
//
// Bound on this card (H100 SXM: bf16 989 TFLOP/s, TF32 495 TFLOP/s on the
// tensor cores, HBM 3.35 TB/s): 2*dh operations per visible (query, key) pair
// for QK^T and again for PV, q, k, v and out moved once; operations bound it
// at SmolLM-135M's widths.  In f32 each product is three TF32 products (see
// below), so its least time is at 165 effective TFLOP/s; bf16's QK^T runs on
// the CUDA cores (below), at most 67 TFLOP/s.  Design:
//  * One block owns 64 q rows of one (batch, head): 4 warps of 16 rows (the
//    flash-attention-2 split); scores and p stay in registers in the mma C
//    layout, and a row's max and sum are quad shuffles.  No padding of Sq or
//    Skv in device memory: ragged rows and keys are masked, dh is zero-padded
//    to the head tile (16/32/64/128) in shared memory only, and the q/k/v
//    layouts are read in place (no head transpose).
//  * q, k and v stay in their own dtype in shared memory.  K and V tiles of
//    64 keys come through cp.async (16 bytes a thread, zero fill past Skv and
//    dh) into the other of two buffers while this tile computes; rows are
//    padded by 16 bytes so that ldmatrix reads 8 rows on 8 bank groups.  A
//    head width whose rows are not whole 16-byte pieces (or an unaligned
//    tensor) is staged element by element instead.
//  * bf16: QK^T as f32 FMAs in d order: the two lanes that hold the same 16
//    keys of neighbouring row pairs in the warp layout (lane and lane ^ 4)
//    each sum 4 rows x 8 keys over d = 0, 1, ... and swap half, reading q
//    and k as bf16 (16 bytes, 8 values a read) and widening in registers,
//    so each k value is read and widened once for 4 rows.  A bf16 x bf16
//    product is exact in f32, so this is the plain version's f32 dot term
//    for term and its scores are the plain version's bit for bit.  That
//    matters here: p is rounded to bf16 before PV, and a score that differs
//    in its last bit moves some p by a whole bf16 step.  QK^T on
//    mma.sync.m16n8k16.bf16 (the tensor cores sum the products in another
//    order and rounding) came out 2.3e-4 beyond the one-ulp term against
//    the plain version on an H100 (limit 1e-4; PERF.md), so it is
//    not used.  PV is B4's: p rounded to bf16 is the A fragment of
//    mma.sync.m16n8k16 straight from the score registers (the same bits as
//    the plain version's p), V through ldmatrix.x4.trans.
//  * f32: one TF32 product would break the 3e-5 limit (scores of order 1
//    wrong near 1e-3), so both products run the 3xTF32 split on
//    mma.sync.m16n8k8.tf32: x = big + small with big = x and small = x - big
//    each rounded to TF32 as cvt.rna.tf32 rounds (done on the bit pattern
//    in integer operations, which run faster than the conversion), and
//    a.b ~ small_a.big_b + big_a.small_b + big_a.big_b in f32 (about 2^-22
//    relative a product); q's fragments are split once.  p stays f32, as
//    the reference leaves it.  For PV the score registers are the A fragment
//    once each 8-key chunk is read with its keys in the order 0,2,4,6,1,3,5,7
//    (the same order for V's rows, so the sum is unchanged); V's B fragments
//    are read from shared memory, conflict-free at a row pitch of dh + 4.
//  * KV tiles wholly outside the causal or window band are skipped (exact).
//  * dh > 128 (recurrentgemma-2b's 256) takes flash_wide_kernel, the wide
//    layout of flash_softmax.cuh: one block of 8 warps owns 64 q rows and
//    up to 256 output columns (a column grid dimension only above dh 256),
//    the two warps of a row group each compute half of a KV tile's keys
//    over the whole dh and its p, and exchange p, so each score and its exp
//    are computed once and K and V are read once a block; q stays in shared
//    memory for the band.  bf16: QK^T as f32 FMAs in d order as above (q staged as f32, a
//    thread's 4 rows x 4 keys), so the scores keep the plain version's
//    bits; PV bf16 mma.sync.  f32: both products as the 3xTF32 split on
//    mma.sync, as flash_kernel's f32 route; 32-key tiles, so that q, K and V
//    fit in shared memory at dh 256.
// Not yet: wgmma, TMA, a persistent grid, and the exps on fewer cores.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include "flash_softmax.cuh"

namespace {

template <typename T, int DH>
struct Smem {
  static constexpr int kRow = DH * (int)sizeof(T) + fa::kPad;  // bytes a row
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + fa::kBQ * kRow;       // two K buffers
  static constexpr int kV = kK + 2 * fa::kBKV * kRow;  // two V buffers
  static constexpr int kBytes = kV + 2 * fa::kBKV * kRow;
};

// 64 rows of a slab in T (row r at base + r * stride) into shared rows of
// Smem::kRow bytes, zero past n_rows and dh: 16-byte cp.async pieces when
// `vec` (dh * sizeof(T) a multiple of 16, the tensors 16-byte aligned), else
// element by element (plain stores, seen after the caller's barrier).
template <typename T, int DH>
__device__ __forceinline__ void stage(int8_t* dst, const T* base,
                                      size_t stride, int n_rows, int dh,
                                      bool vec) {
  constexpr int kRow = Smem<T, DH>::kRow;
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T), CP = DH / E;  // pieces a row
    for (int e = threadIdx.x; e < 64 * CP; e += fa::kThreads) {
      const int r = e / CP, c = (e % CP) * E;
      const bool ok = r < n_rows && c < dh;
      fa::cp_async16(dst + r * kRow + c * (int)sizeof(T),
                     ok ? base + r * stride + c : base, ok);
    }
  } else {
    for (int e = threadIdx.x; e < 64 * DH; e += fa::kThreads) {
      const int r = e / DH, c = e % DH;
      T x = fa::from_float<T>(0.f);
      if (r < n_rows && c < dh) x = base[r * stride + c];
      *reinterpret_cast<T*>(dst + r * kRow + c * (int)sizeof(T)) = x;
    }
  }
}

// Resident blocks an SM the registers are sized for: bf16 at dh <= 64 four
// (at most 128 registers a thread, as B4), f32 at dh <= 64 two (its shared
// memory allows no more); dh = 128 in f32 one (the 3xTF32 fragments).
template <typename T, int DH>
constexpr int min_blocks() {
  return sizeof(T) == 2 ? (DH <= 64 ? 4 : 2) : (DH <= 64 ? 2 : 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(fa::kThreads, min_blocks<T, DH>())
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, fa::Shape s,
                 int vec) {
  using L = Smem<T, DH>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int NT = fa::kBKV / 8;               // n8 score tiles a warp
  constexpr int KC = DH / 8;                     // f32: k8 steps of QK^T
  constexpr int DT = DH / 8;                     // n8 output tiles a warp
  extern __shared__ __align__(16) int8_t smem[];
  const fa::Block blk = fa::block_of(s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // row kv of this (batch, kv head) at kvb + kv * kv_stride, in k and v
  const size_t kv_stride = (size_t)s.kv_heads * s.dh;
  const size_t kvb = ((size_t)blk.b * s.skv * s.kv_heads + blk.kvh) * s.dh;
  auto load_kv = [&](int tile, int buf) {
    const size_t off = kvb + (size_t)tile * fa::kBKV * kv_stride;
    const int rows = s.skv - tile * fa::kBKV;
    stage<T, DH>(smem + L::kK + buf * fa::kBKV * L::kRow, k + off, kv_stride,
                 rows, s.dh, vec);
    stage<T, DH>(smem + L::kV + buf * fa::kBKV * L::kRow, v + off, kv_stride,
                 rows, s.dh, vec);
  };

  int t0, t1;
  fa::kv_tiles(s, blk.q0, t0, t1);
  stage<T, DH>(smem + L::kQ,
               q + (((size_t)blk.b * s.sq + blk.q0) * s.heads + blk.h) * s.dh,
               (size_t)s.heads * s.dh, s.sq - blk.q0, s.dh, vec);
  if (t0 < t1) load_kv(t0, 0);  // with the q tile
  fa::cp_async_commit();

  fa::WarpRows<DT> wr;  // rows g and g + 8 of the warp's 16, and the carry
  wr.init(blk, warp);
  uint32_t qf[KC][4], qf_small[KC][4];  // f32: the warp's q, split
  for (int tile = t0; tile < t1; ++tile) {
    const int buf = (tile - t0) & 1;
    if (tile + 1 < t1) load_kv(tile + 1, buf ^ 1);  // in flight meanwhile
    fa::cp_async_commit();
    fa::cp_async_wait<1>();  // everything but the copies just started
    __syncthreads();
    if constexpr (!kBf16) {  // bf16 reads q from shared memory
      if (tile == t0) {
        const int8_t* qs = smem + L::kQ;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
          fa::ldsm_x4(qf[kc],
                      qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               L::kRow + kc * 32 + (lane >> 4) * 16);
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            fa::split_tf32(__uint_as_float(qf[kc][e]), qf[kc][e],
                       qf_small[kc][e]);
      }
    }
    const int kv0 = tile * fa::kBKV;
    const int8_t* ks = smem + L::kK + buf * fa::kBKV * L::kRow;
    const int8_t* vs = smem + L::kV + buf * fa::kBKV * L::kRow;

    // ---- s = q k^T * scale, f32
    float p[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
    if constexpr (kBf16) {
      // FMAs in d order.  This lane and its partner (lane ^ 4: g ^ 1, same
      // t) own rows {g, g + 8} and {g ^ 1, g ^ 1 + 8} of the same 16 keys;
      // each sums all four rows for the keys 8j + 2t + (g & 1) (the pair's
      // k reads then fall on 8 distinct bank groups) and the two swap halves
      const int gb = g & 1;
      const int8_t* q0 = smem + L::kQ + (warp * 16 + g - gb) * L::kRow;
      float c[4][NT];  // rows g - gb + {0, 1, 8, 9}, my key of tile j
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < NT; ++j) c[r][j] = 0.f;
      for (int d0 = 0; d0 < DH; d0 += 8) {
        float qv[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          fa::widen8(*reinterpret_cast<const uint4*>(
                     q0 + ((r & 1) + 8 * (r >> 1)) * L::kRow + 2 * d0),
                 qv[r]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float kv[8];
          fa::widen8(*reinterpret_cast<const uint4*>(
                     ks + (j * 8 + 2 * t + gb) * L::kRow + 2 * d0),
                 kv);
#pragma unroll
          for (int dd = 0; dd < 8; ++dd)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              c[r][j] = fmaf(qv[r][dd], kv[dd], c[r][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float mine = gb ? c[2 * h + 1][j] : c[2 * h][j];
          const float got = __shfl_xor_sync(
              0xffffffffu, gb ? c[2 * h][j] : c[2 * h + 1][j], 4);
          p[j][2 * h] = gb ? got : mine;  // key 8j + 2t
          p[j][2 * h + 1] = gb ? mine : got;
        }
    } else {
      // 3xTF32 on the tensor cores: K's B fragments through ldmatrix
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t kf[NT][2];
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          fa::ldsm_x4(r, ks + (j * 8 + (lane & 7) + (lane >> 4) * 8) * L::kRow +
                             kc * 32 + ((lane >> 3) & 1) * 16);
          kf[j][0] = r[0];
          kf[j][1] = r[1];
          kf[j + 1][0] = r[2];
          kf[j + 1][1] = r[3];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
          fa::mma_3xtf32(p[j], qf[kc], qf_small[kc],
                         __uint_as_float(kf[j][0]),
                         __uint_as_float(kf[j][1]));
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] *= s.scale;

    wr.softmax(s, kv0, p);

    // ---- acc += p @ v
    if constexpr (kBf16) {
      wr.pv_bf16(p, vs, L::kRow);
    } else {
      wr.pv_tf32x3(p, reinterpret_cast<const float*>(vs), L::kRow / 4);
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  fa::cp_async_wait<0>();

  wr.store(s, blk, out);  // out = acc / max(l, 1e-30)
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const fa::Shape& s, int vec, cudaStream_t stream) {
  constexpr int bytes = Smem<T, DH>::kBytes;
  static int set_on = -1;  // the card the attribute was set for
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != set_on) {
    err = cudaFuncSetAttribute(flash_kernel<T, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    set_on = dev;
  }
  const long long blocks =
      (long long)s.batch * s.heads * ((s.sq + fa::kBQ - 1) / fa::kBQ);
  flash_kernel<T, DH><<<(unsigned)blocks, fa::kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, s, vec);
  return cudaGetLastError();
}

// ------------------------------------------------ dh > 128: the wide layout
// (flash_softmax.cuh).  q is staged as f32 (bf16 q widened once, exact), so
// the bf16 route's d-order FMAs widen no q; the KV tile is 64 keys for bf16
// and 32 for f32 (fa::wide_kv).
template <typename T>
__host__ __device__ constexpr int wide_kv() {
  return fa::wide_kv(4, (int)sizeof(T), (int)sizeof(T));
}

// One (batch * q head, 64-row q tile) and output columns [256 y, 256 y +
// 256).  Each step (KV tile, d chunk) has the next step's copies in flight;
// at a tile's last chunk the pair runs the softmax over its score halves,
// then PV.
template <typename T>
__global__ void __launch_bounds__(fa::kWThreads, 1)
    flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      fa::Shape s, int vec) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int KV = wide_kv<T>();
  constexpr int NT = KV / 8;   // n8 score tiles of a KV tile
  constexpr int NTW = NT / 2;  // ... of this warp's half
  extern __shared__ __align__(16) int8_t smem[];
  const fa::WideLayout L(4, (int)sizeof(T), (int)sizeof(T), KV, s.dh);
  const fa::Block blk = fa::block_of(s);
  const fa::WideWarp w(s, KV);
  const int lane = threadIdx.x & 31;
  float* xs = reinterpret_cast<float*>(smem + L.x) + w.rg * 16 * L.xp;

  const size_t kv_stride = (size_t)s.kv_heads * s.dh;
  const size_t kvb = ((size_t)blk.b * s.skv * s.kv_heads + blk.kvh) * s.dh;
  const size_t q_stride = (size_t)s.heads * s.dh;
  const T* qb = q + (((size_t)blk.b * s.sq + blk.q0) * s.heads + blk.h) * s.dh;
  auto stage_q = [&](int8_t* dst, int d0) {
    if constexpr (kBf16)
      fa::stage_widen(dst, L.qp, qb, q_stride, fa::kBQ, s.sq - blk.q0, d0,
                      L.dw, s.dh, vec);
    else
      fa::stage_slab<T>(dst, L.qp, qb, q_stride, fa::kBQ, s.sq - blk.q0, d0,
                        L.dw, s.dh, vec);
  };
  int t0, t1;
  fa::kv_tiles<KV>(s, blk.q0, t0, t1);
  const int steps = (t1 - t0) * L.nch;
  auto issue = [&](int step) {  // into the slots read two steps ago
    const int tile = t0 + step / L.nch, ch = step % L.nch;
    const size_t off = kvb + (size_t)tile * KV * kv_stride;
    const int rows = s.skv - tile * KV;
    if (L.nch > 1) stage_q(smem + L.q + (step & 1) * fa::kBQ * L.qp, ch * L.dw);
    fa::stage_slab<T>(smem + L.k + (step & 1) * KV * L.kp, L.kp, k + off,
                      kv_stride, KV, rows, ch * L.dw, L.dw, s.dh, vec);
    if (ch == 0)
      fa::stage_slab<T>(smem + L.v + ((tile - t0) & 1) * KV * L.vp, L.vp,
                        v + off, kv_stride, KV, rows, blockIdx.y * fa::kWCols,
                        L.vw, s.dh, vec);
  };
  if (steps) {
    if (L.nch == 1) stage_q(smem + L.q, 0);  // resident for the whole band
    issue(0);
  }
  fa::cp_async_commit();

  fa::WarpRows<16> wr;  // rows g and g + 8 of the row group, 128 columns
  wr.init(blk, w.rg);
  float c[4][4];     // bf16: rows rq + 4i, keys kq + 8j of this warp's half
  float sc[NTW][4];  // this warp's half of the scores in the C layout
  const int rq = lane & 3, kq = lane >> 2;
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) issue(step + 1);
    fa::cp_async_commit();
    fa::cp_async_wait<1>();  // everything but the copies just started
    __syncthreads();
    const int tile = t0 + step / L.nch, ch = step % L.nch;
    const int8_t* qs =
        smem + L.q + (L.nch > 1 ? (step & 1) * fa::kBQ * L.qp : 0);
    const int8_t* ks = smem + L.k + (step & 1) * KV * L.kp;
    const int dn = min(L.dw, s.dh - ch * L.dw);  // d columns of this chunk
    if constexpr (kBf16) {
      // ---- QK^T as f32 FMAs in d order (the plain version's sum, bit for
      // bit): a thread sums 4 rows x 4 keys, reading q as f32 (two 16-byte
      // loads a row) and k as bf16 (one a key, widened in registers); rows
      // rq + 4i and keys kq + 8j fall on distinct bank groups
      if (ch == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
      }
      const int8_t* q0 = qs + (w.rg * 16 + rq) * L.qp;
      const int8_t* k0 = ks + (w.kb + kq) * L.kp;
#pragma unroll 2
      for (int d0 = 0; d0 < dn; d0 += 8) {
        float qv[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4* r =
              reinterpret_cast<const float4*>(q0 + 4 * i * L.qp + d0 * 4);
          const float4 a = r[0], b = r[1];
          qv[i][0] = a.x, qv[i][1] = a.y, qv[i][2] = a.z, qv[i][3] = a.w;
          qv[i][4] = b.x, qv[i][5] = b.y, qv[i][6] = b.z, qv[i][7] = b.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float kv[8];
          fa::widen8(
              *reinterpret_cast<const uint4*>(k0 + 8 * j * L.kp + d0 * 2), kv);
#pragma unroll
          for (int dd = 0; dd < 8; ++dd)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              c[i][j] = fmaf(qv[i][dd], kv[dd], c[i][j]);
        }
      }
      if (ch == L.nch - 1) {  // into the C layout through the warp's slab
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            xs[(rq + 4 * i) * L.xp + w.kb + kq + 8 * j] = c[i][j] * s.scale;
        __syncwarp();
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 f = *reinterpret_cast<const float2*>(
                xs + (g + 8 * h) * L.xp + w.kb + j * 8 + 2 * t);
            sc[j][2 * h] = f.x;
            sc[j][2 * h + 1] = f.y;
          }
      }
    } else {
      // ---- QK^T as 3xTF32 on mma.sync, q's A fragment split once a k8
      // step for the warp's NTW key tiles
      if (ch == 0) {
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      }
      for (int kc = 0; kc < (dn + 7) / 8; ++kc) {
        uint32_t ab[4], as[4];
        fa::ldsm_x4(ab, qs + (w.rg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 L.qp + kc * 32 + (lane >> 4) * 16);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          fa::split_tf32(__uint_as_float(ab[e]), ab[e], as[e]);
#pragma unroll
        for (int j = 0; j < NTW; j += 2) {
          uint32_t r[4];
          fa::ldsm_x4(r, ks + (w.kb + j * 8 + (lane & 7) + (lane >> 4) * 8) *
                                  L.kp + kc * 32 + ((lane >> 3) & 1) * 16);
          fa::mma_3xtf32(sc[j], ab, as, __uint_as_float(r[0]),
                         __uint_as_float(r[1]));
          fa::mma_3xtf32(sc[j + 1], ab, as, __uint_as_float(r[2]),
                         __uint_as_float(r[3]));
        }
      }
      if (ch == L.nch - 1) {
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] *= s.scale;
      }
    }
    if (ch == L.nch - 1) {
      float p[NT][4];  // the pair's whole tile
      wr.softmax_pair(s, tile * KV, w.kb, w.half, w.rg, xs, L.xp, sc, p);
      if (w.ncols > 0) {
        const int8_t* vs = smem + L.v + ((tile - t0) & 1) * KV * L.vp +
                           w.half * 128 * (int)sizeof(T);
        if constexpr (kBf16)
          wr.pv_bf16(p, vs, L.vp, w.ncols);
        else
          wr.pv_tf32x3(p, reinterpret_cast<const float*>(vs), L.vp / 4,
                       w.ncols);
      }
    }
    __syncthreads();  // these slots and the exchange are refilled next
  }
  fa::cp_async_wait<0>();

  if (w.ncols > 0) wr.store(s, blk, out, w.c0);
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        void* out, const fa::Shape& s, int vec,
                        cudaStream_t stream) {
  constexpr int KV = wide_kv<T>();
  const fa::WideLayout L(4, (int)sizeof(T), (int)sizeof(T), KV, s.dh);
  static int set_on = -1;  // the card the attribute was set for
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != set_on) {
    err = cudaFuncSetAttribute(
        flash_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fa::wide_max_bytes(4, (int)sizeof(T), (int)sizeof(T), KV));
    if (err != cudaSuccess) return err;
    set_on = dev;
  }
  const long long blocks =
      (long long)s.batch * s.heads * ((s.sq + fa::kBQ - 1) / fa::kBQ);
  const dim3 grid((unsigned)blocks, (s.dh + fa::kWCols - 1) / fa::kWCols);
  flash_wide_kernel<T><<<grid, fa::kWThreads, L.bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, s, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     const fa::Shape& s, cudaStream_t stream) {
  const bool vec = (s.dh * sizeof(T)) % 16 == 0 &&
                   ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  switch (fa::head_tile(s.dh)) {
    case 16: return launch<T, 16>(q, k, v, out, s, vec, stream);
    case 32: return launch<T, 32>(q, k, v, out, s, vec, stream);
    case 64: return launch<T, 64>(q, k, v, out, s, vec, stream);
    case 128: return launch<T, 128>(q, k, v, out, s, vec, stream);
    default: return launch_wide<T>(q, k, v, out, s, vec, stream);
  }
}

}  // namespace

// out (B, Sq, H, dh) = flash attention of q, k, v (layouts above), f32
// (is_bf16 = 0) or bf16 (1), any dh (above 128 the wide layout);
// has_window = 0 means no window.  Returns a
// cudaError_t as int: 0 when the launch was accepted.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int batch, int sq, int skv,
                               int heads, int kv_heads, int dh, int causal,
                               int has_window, int window, float scale,
                               int is_bf16, void* stream) {
  if (batch < 1 || sq < 1 || skv < 1 || kv_heads < 1 || heads % kv_heads ||
      dh < 1)
    return (int)cudaErrorInvalidValue;
  const fa::Shape s = {batch,  sq, skv, heads, kv_heads, dh, causal ? 1 : 0,
                       has_window ? 1 : 0, window, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, s, st)
                       : dispatch<float>(q, k, v, out, s, st));
}
