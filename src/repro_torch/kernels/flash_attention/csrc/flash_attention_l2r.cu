// Kernel B4: flash attention whose QK^T tile is the MSDF level walk, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:_l2r_kernel
// (reached through flash_attention_l2r_pallas).  q and k arrive quantized per
// vector (one f32 scale per query row and per key slot) as raw int8, qq
// (B, Sq, H, W) and kq (B, Skv, Kv, W), W the head width dh zero-padded to the
// kernel's head tile.  Each score is the level walk over their pre-shifted
// digit planes,
//
//   s_int = sum over the plane pairs (i, j) of the first `levels` MSDF levels
//           of  q_i . k_j                                          (int32)
//   s     = s_int * q_scale * k_scale * scale        (f32, in that order)
//
// and the online softmax, PV and the output follow the reference
// (flash_softmax.cuh's header: masked scores -1e30, p zeroed where masked,
// l the f32 sum of p, PV on p rounded to v's dtype, out = acc / max(l, 1e-30)).
//
// The walk as few tensor-core products.  A pre-shifted plane is a bit-field of
// its int8 operand (plane i < D-1 keeps bits [b*i, b*(i+1)); the top plane the
// bits from b*(D-1) up, the sign extension included), so a range of planes is
// the operand under a byte mask and the walk is a short list of products
// (q & mask_a[p]) . (k & mask_b[p]) (the host's msdf_products and plane_bits).
// The first L levels collapse to at most D products, one at full depth (no
// mask at all); a table that does not start at level 0 runs as its plane
// pairs, one product each.  The masks are applied to the fragments in
// registers: no plane stack is built or stored.  int32 sums wrap identically
// in any order, so the score tile is the reference's bit for bit.
//
// Bound on this card (H100 SXM: int8 1,979 TOP/s, bf16 989 TFLOP/s, TF32
// 495 TFLOP/s, HBM 3.35 TB/s): 2*dh int8 operations per visible (query, key)
// pair for QK^T and 2*dh for PV; an f32 PV to the 3e-5 limit takes at least
// three TF32 products (kernel B5's split, 165 TFLOP/s effective) and
// dominates the f32 bound, both are small in bf16, where the exps and the
// softmax bookkeeping on the CUDA cores come to the fore.  Design:
//  * One block owns 64 q rows of one (batch, head): 4 warps of 16 rows, the
//    flash-attention-2 split, so each warp's row max and row sum are a quad
//    shuffle and no score leaves the registers.
//  * QK^T on mma.sync.m16n8k32.s8.s8.s32 (wrapping s32, no .satfinite): the
//    warp's q fragments stay in registers for the whole band; each KV tile
//    of 64 keys is read from shared memory with ldmatrix.x4.
//  * K, V and the key scales of the next tile come through cp.async (16 bytes
//    a thread, zero fill past Skv) into the other of two buffers while this
//    tile computes.  Shared rows are padded by 16 bytes: ldmatrix reads 8
//    rows on 8 distinct bank groups.
//  * PV in bf16: p rounded to bf16 is the A fragment of mma.sync.m16n8k16
//    straight from the score registers; V's B fragments come from
//    ldmatrix.x4.trans; f32 accumulation (flash_softmax.cuh, shared with
//    B5).  PV in f32: one TF32 product would break the 3e-5 limit; each warp
//    parks its p in shared memory and runs f32 FMAs over the 64 keys (B5's
//    3xTF32 PV could take their place).
//  * KV tiles wholly outside the causal or window band are skipped (exact).
//  * int16 q and k (n_bits 9-16) at any dh, and int8 q and k wider than
//    128, take the entry flash_attention_l2r_wide: the wide layout of
//    flash_softmax.cuh (8 warps own 64 q rows and up to 256 output columns,
//    the two warps of a row group each walk half of a KV tile's keys over
//    the whole dh, dequantize them and take their p, and exchange p, so
//    each score is computed once), QK^T on mma.sync.m16n8k32 as here, an
//    int16 product as its byte split (s8.s8, s8.u8 + u8.s8 and u8.u8
//    products combined mod 2^32, l2r_gemm/csrc/l2r_byte_split.cuh), f32 PV
//    as B5's 3xTF32 split, 32-key tiles for int16 with f32 v (shared
//    memory).  Every launch of B4 runs QK^T on the tensor
//    cores.
// Not yet: wgmma, TMA, a persistent grid, and the exps on fewer cores.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include "../../l2r_gemm/csrc/l2r_byte_split.cuh"
#include "flash_softmax.cuh"

namespace {

constexpr int kMaxProducts = 64;       // D^2 plane pairs for D <= 8
constexpr int kPPitch = fa::kBKV + 4;  // floats a row of parked p (f32 PV)

struct Products {
  int n;
  uint32_t ma[kMaxProducts], mb[kMaxProducts];  // byte masks, in all 4 bytes
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T, int DH>
struct Smem {
  static constexpr int kQP = DH + fa::kPad;                   // int8 row pitch
  static constexpr int kVP = DH * (int)sizeof(T) + fa::kPad;  // V row pitch
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + fa::kBQ * kQP;          // two K buffers
  static constexpr int kV = kK + 2 * fa::kBKV * kQP;     // two V buffers
  static constexpr int kS = kV + 2 * fa::kBKV * kVP;     // two key-scale rows
  static constexpr int kP = kS + 2 * fa::kBKV * 4;       // f32 PV: parked p
  static constexpr int kBytes =
      kP + (sizeof(T) == 4 ? fa::kWarps * 16 * kPPitch * 4 : 0);
};

// bf16 at dh <= 64 is compiled for four resident blocks an SM (at most 128
// registers a thread, with a small spill): more warps hide the latency of the
// softmax chain; f32 (FMA PV) and dh = 128 keep their registers
template <typename T, int DH>
__global__ void __launch_bounds__(fa::kThreads,
                                  sizeof(T) == 2 && DH <= 64 ? 4 : 1)
    flash_l2r_kernel(const int8_t* __restrict__ qq,
                     const float* __restrict__ qsc,
                     const int8_t* __restrict__ kq,
                     const float* __restrict__ ksc, const T* __restrict__ v,
                     T* __restrict__ out, fa::Shape s, Products pr) {
  using L = Smem<T, DH>;
  constexpr int NT = fa::kBKV / 8;  // n8 score tiles per warp
  constexpr int KC = DH / 32;       // k32 steps of QK^T
  constexpr int DT = DH / 8;        // n8 output tiles per warp
  extern __shared__ __align__(16) int8_t smem[];
  const fa::Block blk = fa::block_of(s);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // issue the copies of KV tile `tile` into buffer `buf`
  auto load_kv = [&](int tile, int buf) {
    const int kv0 = tile * fa::kBKV;
    int8_t* ks = smem + L::kK + buf * fa::kBKV * L::kQP;
    int8_t* vs = smem + L::kV + buf * fa::kBKV * L::kVP;
    float* ss = reinterpret_cast<float*>(smem + L::kS) + buf * fa::kBKV;
    constexpr int KP = DH / 16, VP = DH * (int)sizeof(T) / 16;
    for (int e = tid; e < fa::kBKV * KP; e += fa::kThreads) {
      const int r = e / KP, c = (e % KP) * 16, kv = kv0 + r;
      const bool ok = kv < s.skv;
      fa::cp_async16(ks + r * L::kQP + c,
                     ok ? kq + (((size_t)blk.b * s.skv + kv) * s.kv_heads +
                                blk.kvh) * DH + c
                        : kq,
                     ok);
    }
    for (int e = tid; e < fa::kBKV * VP; e += fa::kThreads) {
      const int r = e / VP, c = (e % VP) * 16, kv = kv0 + r;
      const bool ok = kv < s.skv;
      fa::cp_async16(vs + r * L::kVP + c,
                     ok ? reinterpret_cast<const int8_t*>(v) +
                              ((((size_t)blk.b * s.skv + kv) * s.kv_heads +
                                blk.kvh) * DH) * sizeof(T) + c
                        : reinterpret_cast<const int8_t*>(v),
                     ok);
    }
    for (int r = tid; r < fa::kBKV; r += fa::kThreads) {
      const int kv = kv0 + r;
      const bool ok = kv < s.skv;
      fa::cp_async4(
          ss + r,
          ok ? ksc + ((size_t)blk.b * s.skv + kv) * s.kv_heads + blk.kvh : ksc,
          ok);
    }
  };

  int t0, t1;
  fa::kv_tiles(s, blk.q0, t0, t1);
  {  // the q tile, with the first KV tile
    int8_t* qs = smem + L::kQ;
    constexpr int QP = DH / 16;
    for (int e = tid; e < fa::kBQ * QP; e += fa::kThreads) {
      const int r = e / QP, c = (e % QP) * 16, q = blk.q0 + r;
      const bool ok = q < s.sq;
      fa::cp_async16(
          qs + r * L::kQP + c,
          ok ? qq + (((size_t)blk.b * s.sq + q) * s.heads + blk.h) * DH + c
             : qq,
          ok);
    }
    if (t0 < t1) load_kv(t0, 0);
    fa::cp_async_commit();
  }

  fa::WarpRows<DT> wr;  // rows g and g + 8 of the warp's 16, and the carry
  wr.init(blk, warp);
  float q_scale[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    q_scale[h] = wr.row[h] < s.sq
                     ? qsc[((size_t)blk.b * s.sq + wr.row[h]) * s.heads + blk.h]
                     : 0.f;

  uint32_t qf[KC][4];
  bool have_q = false;
  for (int tile = t0; tile < t1; ++tile) {
    const int buf = (tile - t0) & 1;
    if (tile + 1 < t1) load_kv(tile + 1, buf ^ 1);  // in flight meanwhile
    fa::cp_async_commit();
    fa::cp_async_wait<1>();  // everything but the copies just started
    __syncthreads();
    if (!have_q) {  // the warp's q fragments, once
      const int8_t* qs = smem + L::kQ;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        fa::ldsm_x4(qf[kc],
                    qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             L::kQP + kc * 32 + (lane >> 4) * 16);
      have_q = true;
    }
    const int kv0 = tile * fa::kBKV;
    const int8_t* ks = smem + L::kK + buf * fa::kBKV * L::kQP;
    const int8_t* vs = smem + L::kV + buf * fa::kBKV * L::kVP;
    const float* ss = reinterpret_cast<const float*>(smem + L::kS) +
                      buf * fa::kBKV;

    // ---- s_int = the walk's products, on the int8 tensor cores
    int si[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) si[j][q] = 0;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t kf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        fa::ldsm_x4(r, ks + (j * 8 + (lane & 7) + (lane >> 4) * 8) * L::kQP +
                           kc * 32 + ((lane >> 3) & 1) * 16);
        kf[j][0] = r[0];
        kf[j][1] = r[1];
        kf[j + 1][0] = r[2];
        kf[j + 1][1] = r[3];
      }
      for (int p = 0; p < pr.n; ++p) {
        const uint32_t ma = pr.ma[p], mb = pr.mb[p];
        const uint32_t a[4] = {qf[kc][0] & ma, qf[kc][1] & ma, qf[kc][2] & ma,
                               qf[kc][3] & ma};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t b[2] = {kf[j][0] & mb, kf[j][1] & mb};
          mma_s8(si[j], a, b);
        }
      }
    }

    // ---- scores (f32, the reference's order), masks, online softmax
    float p[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          p[j][2 * h + e] = (float)si[j][2 * h + e] * q_scale[h] *
                            ss[j * 8 + 2 * t + e] * s.scale;
    wr.softmax(s, kv0, p);

    // ---- acc += p @ v
    if constexpr (sizeof(T) == 2) {
      wr.pv_bf16(p, vs, L::kVP);
    } else {
      // f32: park p (this warp's 16 rows), then FMAs over the 64 keys
      float* ps = reinterpret_cast<float*>(smem + L::kP) + warp * 16 * kPPitch;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(ps + (g + 8 * h) * kPPitch + j * 8 + 2 * t) =
              make_float2(p[j][2 * h], p[j][2 * h + 1]);
      __syncwarp();
      const float* vf = reinterpret_cast<const float*>(vs);
      for (int c = 0; c < fa::kBKV; ++c) {
        const float p0 = ps[g * kPPitch + c], p1 = ps[(g + 8) * kPPitch + c];
        const float* vr = vf + c * (L::kVP / 4);
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const float2 vv = *reinterpret_cast<const float2*>(vr + j * 8 + 2 * t);
          wr.acc[j][0] = fmaf(p0, vv.x, wr.acc[j][0]);
          wr.acc[j][1] = fmaf(p0, vv.y, wr.acc[j][1]);
          wr.acc[j][2] = fmaf(p1, vv.x, wr.acc[j][2]);
          wr.acc[j][3] = fmaf(p1, vv.y, wr.acc[j][3]);
        }
      }
      __syncwarp();  // p read before the next tile parks its own
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  fa::cp_async_wait<0>();

  wr.store(s, blk, out);  // out = acc / max(l, 1e-30)
}

template <typename T, int DH>
cudaError_t launch(const void* qq, const void* qsc, const void* kq,
                   const void* ksc, const void* v, void* out,
                   const fa::Shape& s, const Products& pr,
                   cudaStream_t stream) {
  const int bytes = Smem<T, DH>::kBytes;
  static int set_on = -1;  // the card the attribute was set for
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != set_on) {
    err = cudaFuncSetAttribute(flash_l2r_kernel<T, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    set_on = dev;
  }
  const long long blocks =
      (long long)s.batch * s.heads * ((s.sq + fa::kBQ - 1) / fa::kBQ);
  flash_l2r_kernel<T, DH><<<(unsigned)blocks, fa::kThreads, bytes, stream>>>(
      (const int8_t*)qq, (const float*)qsc, (const int8_t*)kq,
      (const float*)ksc, (const T*)v, (T*)out, s, pr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int width, const void* qq, const void* qsc,
                     const void* kq, const void* ksc, const void* v, void* out,
                     const fa::Shape& s, const Products& pr,
                     cudaStream_t stream) {
  switch (width) {
    case 32: return launch<T, 32>(qq, qsc, kq, ksc, v, out, s, pr, stream);
    case 64: return launch<T, 64>(qq, qsc, kq, ksc, v, out, s, pr, stream);
    case 128: return launch<T, 128>(qq, qsc, kq, ksc, v, out, s, pr, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ the wide route
// int16 q, k at any dh and int8 q, k above dh 128, in the wide layout of
// flash_softmax.cuh.  QK^T on the int8 tensor cores: a pair's warp runs its
// half of the keys over the whole dh in k32 steps of mma.sync.m16n8k32, the
// walk's masks applied to the fragments in registers.  An int16 operand
// runs as its byte split (l2r_gemm/csrc/l2r_byte_split.cuh): s8.s8, s8.u8 +
// u8.s8 and u8.u8 products combined mod 2^32, the reference's wrapping int32
// dot; no byte accumulator can overflow below dh 32,896, so the exactness
// does not rest on how mma wraps.
constexpr int kWideProducts = 16;  // a prefix of the walk: at most D <= 16

struct WideProducts {
  int n;
  uint32_t ma[kWideProducts], mb[kWideProducts];  // masks in every lane
};

// The score accumulators of a warp's NTW key tiles: int8 q, k one int32
// sum; int16 the three byte-pair sums
template <typename Q, int NTW>
struct ScoreAcc {
  int hh[NTW][4], cr[sizeof(Q) == 2 ? NTW : 1][4],
      ll[sizeof(Q) == 2 ? NTW : 1][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hh[j][e] = 0;
        if constexpr (sizeof(Q) == 2) cr[j][e] = ll[j][e] = 0;
      }
  }

  // the walk's products over k32 step kc of this chunk: qs the 64 staged q
  // rows (pitch qp), ks the KV tile's rows from this warp's first key (kp)
  __device__ __forceinline__ void step(const int8_t* qs, int qp,
                                       const int8_t* ks, int kp, int kc,
                                       const WideProducts& pr) {
    const int lane = threadIdx.x & 31;
    const int8_t* qa = qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * qp +
                       kc * 32 * (int)sizeof(Q) + (lane >> 4) * 16;
    if constexpr (sizeof(Q) == 1) {
      uint32_t a[4], kf[NTW][2];
      fa::ldsm_x4(a, qa);
#pragma unroll
      for (int j = 0; j < NTW; j += 2) {
        uint32_t r[4];
        fa::ldsm_x4(r, ks + (j * 8 + (lane & 7) + (lane >> 4) * 8) * kp +
                           kc * 32 + ((lane >> 3) & 1) * 16);
        kf[j][0] = r[0];
        kf[j][1] = r[1];
        kf[j + 1][0] = r[2];
        kf[j + 1][1] = r[3];
      }
      for (int p = 0; p < pr.n; ++p) {
        const uint32_t ma = pr.ma[p], mb = pr.mb[p];
        const uint32_t am[4] = {a[0] & ma, a[1] & ma, a[2] & ma, a[3] & ma};
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const uint32_t b[2] = {kf[j][0] & mb, kf[j][1] & mb};
          mma_s8(hh[j], am, b);
        }
      }
    } else {
      // q: elements {2t, 2t + 1} of each 8 of row g (a[0][0], a[0][2],
      // a[1][0], a[1][2]) and of row g + 8 (a[.][1], a[.][3]); k: of key g
      // (kf[j][0..3])
      uint32_t a[2][4], kf[NTW][4];
      fa::ldsm_x4(a[0], qa);
      fa::ldsm_x4(a[1], qa + 32);
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        fa::ldsm_x4(kf[j], ks + (j * 8 + (lane & 7)) * kp + kc * 64 +
                               (lane >> 3) * 16);
      const uint32_t x[8] = {a[0][0], a[0][1], a[0][2], a[0][3],
                             a[1][0], a[1][1], a[1][2], a[1][3]};
      for (int p = 0; p < pr.n; ++p) {
        uint32_t ah[4], al[4];
        l2r::split_a(x, pr.ma[p], ah, al);
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          uint32_t bh[2], bl[2];
          l2r::split_b(kf[j], pr.mb[p], bh, bl);
          l2r::mma_bytes(hh[j], cr[j], ll[j], ah, al, bh, bl);
        }
      }
    }
  }

  // s_int of score (j, e), wrapping as the reference's int32 dot
  __device__ __forceinline__ int score(int j, int e) const {
    if constexpr (sizeof(Q) == 1) {
      return hh[j][e];
    } else {
      return (int)l2r::combine(hh[j][e], cr[j][e], ll[j][e]);
    }
  }
};

// The KV tile: 64 keys, 32 for int16 q, k with f32 v (fa::wide_kv)
template <typename T, typename Q>
__host__ __device__ constexpr int wide_kv() {
  return fa::wide_kv((int)sizeof(Q), (int)sizeof(Q), (int)sizeof(T));
}

// One (batch * q head, 64-row q tile) and output columns [256 y, 256 y +
// 256).  Q is the raw operand type (int8_t or int16_t).  Each step (KV tile,
// d chunk) has the next step's copies in flight (K, and at a tile's first
// chunk its V columns and key scales); at a tile's last chunk each warp
// dequantizes its half, s = s_int * q_scale * k_scale * scale (f32, the
// reference's order), the pair runs the softmax over the halves, then PV.
template <typename T, typename Q>
__global__ void __launch_bounds__(fa::kWThreads, 1)
    flash_l2r_wide_kernel(const Q* __restrict__ qq,
                          const float* __restrict__ qsc,
                          const Q* __restrict__ kq,
                          const float* __restrict__ ksc,
                          const T* __restrict__ v, T* __restrict__ out,
                          fa::Shape s, WideProducts pr, int vec_qk,
                          int vec_v) {
  constexpr int KV = wide_kv<T, Q>();
  constexpr int NT = KV / 8;   // n8 score tiles of a KV tile
  constexpr int NTW = NT / 2;  // ... of this warp's half
  extern __shared__ __align__(16) int8_t smem[];
  const fa::WideLayout L((int)sizeof(Q), (int)sizeof(Q), (int)sizeof(T), KV,
                         s.dh);
  const fa::Block blk = fa::block_of(s);
  const fa::WideWarp w(s, KV);
  const int lane = threadIdx.x & 31, t = lane & 3;
  float* xs = reinterpret_cast<float*>(smem + L.x) + w.rg * 16 * L.xp;

  const size_t kv_stride = (size_t)s.kv_heads * s.dh;
  const size_t kvb = ((size_t)blk.b * s.skv * s.kv_heads + blk.kvh) * s.dh;
  const size_t q_stride = (size_t)s.heads * s.dh;
  const Q* qb = qq + (((size_t)blk.b * s.sq + blk.q0) * s.heads + blk.h) *
                         s.dh;
  int t0, t1;
  fa::kv_tiles<KV>(s, blk.q0, t0, t1);
  const int steps = (t1 - t0) * L.nch;
  auto issue = [&](int step) {  // into the slots read two steps ago
    const int tile = t0 + step / L.nch, ch = step % L.nch;
    const int kv0 = tile * KV, rows = s.skv - kv0;
    const size_t off = kvb + (size_t)kv0 * kv_stride;
    if (L.nch > 1)
      fa::stage_slab<Q>(smem + L.q + (step & 1) * fa::kBQ * L.qp, L.qp, qb,
                        q_stride, fa::kBQ, s.sq - blk.q0, ch * L.dw, L.dw,
                        s.dh, vec_qk);
    fa::stage_slab<Q>(smem + L.k + (step & 1) * KV * L.kp, L.kp, kq + off,
                      kv_stride, KV, rows, ch * L.dw, L.dw, s.dh, vec_qk);
    if (ch == 0) {
      const int buf = (tile - t0) & 1;
      fa::stage_slab<T>(smem + L.v + buf * KV * L.vp, L.vp, v + off,
                        kv_stride, KV, rows, blockIdx.y * fa::kWCols, L.vw,
                        s.dh, vec_v);
      for (int r = threadIdx.x; r < KV; r += fa::kWThreads) {
        const bool ok = r < rows;
        fa::cp_async4(
            smem + L.sc + (buf * KV + r) * 4,
            ok ? ksc + ((size_t)blk.b * s.skv + kv0 + r) * s.kv_heads +
                     blk.kvh
               : ksc,
            ok);
      }
    }
  };
  if (steps) {
    if (L.nch == 1)  // q resident for the whole band
      fa::stage_slab<Q>(smem + L.q, L.qp, qb, q_stride, fa::kBQ,
                        s.sq - blk.q0, 0, L.dw, s.dh, vec_qk);
    issue(0);
  }
  fa::cp_async_commit();

  fa::WarpRows<16> wr;  // rows g and g + 8 of the row group, 128 columns
  wr.init(blk, w.rg);
  float q_scale[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    q_scale[h] = wr.row[h] < s.sq
                     ? qsc[((size_t)blk.b * s.sq + wr.row[h]) * s.heads + blk.h]
                     : 0.f;

  ScoreAcc<Q, NTW> sa;
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) issue(step + 1);
    fa::cp_async_commit();
    fa::cp_async_wait<1>();  // everything but the copies just started
    __syncthreads();
    const int tile = t0 + step / L.nch, ch = step % L.nch;
    const int buf = (tile - t0) & 1;
    if (ch == 0) sa.zero();

    // ---- s_int += the walk's products over this chunk, on the tensor cores
    const int8_t* qs = smem + L.q +
                       (L.nch > 1 ? (step & 1) * fa::kBQ * L.qp : 0) +
                       w.rg * 16 * L.qp;
    const int8_t* ks = smem + L.k + (step & 1) * KV * L.kp + w.kb * L.kp;
    const int dn = min(L.dw, s.dh - ch * L.dw);  // d columns of this chunk
    for (int kc = 0; kc < (dn + 31) / 32; ++kc)
      sa.step(qs, L.qp, ks, L.kp, kc, pr);

    if (ch == L.nch - 1) {
      // ---- scores (f32, the reference's order), the pair's softmax
      const float* ss =
          reinterpret_cast<const float*>(smem + L.sc) + buf * KV + w.kb;
      float sc[NTW][4];
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sc[j][2 * h + e] = (float)sa.score(j, 2 * h + e) * q_scale[h] *
                               ss[j * 8 + 2 * t + e] * s.scale;
      float p[NT][4];  // the pair's whole tile
      wr.softmax_pair(s, tile * KV, w.kb, w.half, w.rg, xs, L.xp, sc, p);
      if (w.ncols > 0) {
        const int8_t* vs =
            smem + L.v + buf * KV * L.vp + w.half * 128 * (int)sizeof(T);
        if constexpr (sizeof(T) == 2)
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

template <typename T, typename Q>
cudaError_t launch_wide(const void* qq, const void* qsc, const void* kq,
                        const void* ksc, const void* v, void* out,
                        const fa::Shape& s, const WideProducts& pr,
                        int vec_qk, int vec_v, cudaStream_t stream) {
  constexpr int KV = wide_kv<T, Q>();
  const fa::WideLayout L((int)sizeof(Q), (int)sizeof(Q), (int)sizeof(T), KV,
                         s.dh);
  static int set_on = -1;  // the card the attribute was set for
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != set_on) {
    err = cudaFuncSetAttribute(
        flash_l2r_wide_kernel<T, Q>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        fa::wide_max_bytes((int)sizeof(Q), (int)sizeof(Q), (int)sizeof(T),
                           KV));
    if (err != cudaSuccess) return err;
    set_on = dev;
  }
  const long long blocks =
      (long long)s.batch * s.heads * ((s.sq + fa::kBQ - 1) / fa::kBQ);
  const dim3 grid((unsigned)blocks, (s.dh + fa::kWCols - 1) / fa::kWCols);
  flash_l2r_wide_kernel<T, Q><<<grid, fa::kWThreads, L.bytes, stream>>>(
      (const Q*)qq, (const float*)qsc, (const Q*)kq, (const float*)ksc,
      (const T*)v, (T*)out, s, pr, vec_qk, vec_v);
  return cudaGetLastError();
}

}  // namespace

// out (B, Sq, H, dh) in v's dtype (f32: is_bf16 = 0, bf16: 1) = flash
// attention over the level-walk scores of the per-vector-quantized int8 qq
// (B, Sq, H, width) and kq (B, Skv, Kv, width), with scales q_scale (B, Sq, H)
// and k_scale (B, Skv, Kv), f32, and v (B, Skv, Kv, width); width is dh
// zero-padded to 32, 64 or 128.  The walk is the products p of
// (qq & mask_a[p]) . (kq & mask_b[p]) (byte masks); has_window = 0 means no
// window.  Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int flash_attention_l2r(
    const void* qq, const void* q_scale, const void* kq, const void* k_scale,
    const void* v, void* out, int batch, int sq, int skv, int heads,
    int kv_heads, int dh, int width, int causal, int has_window, int window,
    float scale, int n_products, const int* mask_a, const int* mask_b,
    int is_bf16, void* stream) {
  if (batch < 1 || sq < 1 || skv < 1 || kv_heads < 1 || heads % kv_heads ||
      dh < 1 || dh > width || n_products < 0 || n_products > kMaxProducts)
    return (int)cudaErrorInvalidValue;
  Products pr = {};
  pr.n = n_products;
  for (int p = 0; p < n_products; ++p) {
    if (mask_a[p] < 0 || mask_a[p] > 255 || mask_b[p] < 0 || mask_b[p] > 255)
      return (int)cudaErrorInvalidValue;
    pr.ma[p] = (uint32_t)mask_a[p] * 0x01010101u;
    pr.mb[p] = (uint32_t)mask_b[p] * 0x01010101u;
  }
  const fa::Shape s = {batch,  sq, skv, heads, kv_heads, dh, causal ? 1 : 0,
                       has_window ? 1 : 0, window, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(width, qq, q_scale, kq,
                                                 k_scale, v, out, s, pr, st)
                       : dispatch<float>(width, qq, q_scale, kq, k_scale, v,
                                         out, s, pr, st));
}

// The wide route: as flash_attention_l2r on unpadded qq (B, Sq, H, dh) and kq
// (B, Skv, Kv, dh) of elem_bytes 1 (int8, dh > 128) or 2 (int16, any dh),
// v (B, Skv, Kv, dh), with masks of the raw operand's bits (at most 16
// products).  Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int flash_attention_l2r_wide(
    const void* qq, const void* q_scale, const void* kq, const void* k_scale,
    const void* v, void* out, int batch, int sq, int skv, int heads,
    int kv_heads, int dh, int causal, int has_window, int window, float scale,
    int n_products, const int* mask_a, const int* mask_b, int is_bf16,
    int elem_bytes, void* stream) {
  if (batch < 1 || sq < 1 || skv < 1 || kv_heads < 1 || heads % kv_heads ||
      dh < 1 || n_products < 0 || n_products > kWideProducts ||
      (elem_bytes != 1 && elem_bytes != 2))
    return (int)cudaErrorInvalidValue;
  WideProducts pr = {};
  pr.n = n_products;
  const int top = elem_bytes == 1 ? 0xFF : 0xFFFF;
  const uint32_t rep = elem_bytes == 1 ? 0x01010101u : 0x00010001u;
  for (int p = 0; p < n_products; ++p) {
    if (mask_a[p] < 0 || mask_a[p] > top || mask_b[p] < 0 || mask_b[p] > top)
      return (int)cudaErrorInvalidValue;
    pr.ma[p] = (uint32_t)mask_a[p] * rep;
    pr.mb[p] = (uint32_t)mask_b[p] * rep;
  }
  const fa::Shape s = {batch,  sq, skv, heads, kv_heads, dh, causal ? 1 : 0,
                       has_window ? 1 : 0, window, scale};
  const int vsize = is_bf16 ? 2 : 4;
  const int vec_qk = (dh * elem_bytes) % 16 == 0 &&
                     ((uintptr_t)qq | (uintptr_t)kq) % 16 == 0;
  const int vec_v = (dh * vsize) % 16 == 0 && (uintptr_t)v % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 1)
    return (int)(is_bf16 ? launch_wide<__nv_bfloat16, int8_t>(
                               qq, q_scale, kq, k_scale, v, out, s, pr,
                               vec_qk, vec_v, st)
                         : launch_wide<float, int8_t>(qq, q_scale, kq, k_scale,
                                                      v, out, s, pr, vec_qk,
                                                      vec_v, st));
  return (int)(is_bf16 ? launch_wide<__nv_bfloat16, int16_t>(
                             qq, q_scale, kq, k_scale, v, out, s, pr, vec_qk,
                             vec_v, st)
                       : launch_wide<float, int16_t>(qq, q_scale, kq, k_scale,
                                                     v, out, s, pr, vec_qk,
                                                     vec_v, st));
}
