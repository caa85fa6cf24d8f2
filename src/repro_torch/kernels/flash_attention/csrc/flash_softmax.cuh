// The online-softmax half of kernels B5 (flash_attention.cu) and B4
// (flash_attention_l2r.cu): tiling, masks, the tensor-core and copy
// primitives, the warp-layout (m, l, acc) carry, the bf16 PV and the
// epilogue.  The two kernels differ only in how they fill a score tile (and
// in their f32 PV).
//
// One thread block owns one (batch * q head, 64-row q tile) and walks the KV
// tiles of 64 keys in order, so the f32 carry stays in registers for the whole
// row band (the TPU kernel carried it in VMEM scratch across a sequential grid
// axis).  4 warps of 16 q rows, the flash-attention-2 split: a score tile is
// a warp's 16 rows x 64 keys in the mma.sync C layout, so thread (g, t) =
// (lane / 4, lane % 4) holds rows g and g + 8 and, of each n8 tile j, keys
// 8j + 2t and 8j + 2t + 1; a row's max and sum are two quad shuffles and no
// score leaves the registers.
//
// The arithmetic is the reference's (repro/kernels/flash_attention/kernel.py):
// masked scores are -1e30; p = exp(s - m_new) is zeroed where masked; l sums
// the f32 p; PV takes p rounded to v's dtype (bf16 in, bf16 p), accumulated in
// f32; out = acc / max(l, 1e-30) in v's dtype.  A row that sees no key keeps
// l = 0 and acc = 0 and comes out 0.  KV tiles that lie wholly outside the
// causal or window band are skipped: such a tile changes neither m, l nor
// acc, so the skip is exact whatever the tile sizes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fa {

constexpr int kBQ = 64;    // q rows per block
constexpr int kBKV = 64;   // keys per KV tile
constexpr int kWarps = 4;  // 16 q rows each
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 16;   // bytes after each shared row: ldmatrix reads 8
                           // rows on 8 distinct bank groups
constexpr float kNeg = -1e30f;

struct Shape {
  int batch, sq, skv, heads, kv_heads, dh;
  int causal;      // 0 or 1
  int has_window;  // 0 or 1; then keys with kv <= q - window are masked
  int window;
  float scale;
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool visible(const Shape& s, int q, int kv) {
  bool ok = kv < s.skv;
  if (s.causal) ok = ok && kv <= q;
  if (s.has_window) ok = ok && kv > q - s.window;
  return ok;
}

// KV tiles [begin, end) that intersect the band of q rows [q0, q0 + kBQ)
__device__ __forceinline__ void kv_tiles(const Shape& s, int q0, int& begin,
                                         int& end) {
  end = (s.skv + kBKV - 1) / kBKV;
  if (s.causal) end = min(end, (q0 + kBQ - 1) / kBKV + 1);
  begin = 0;
  if (s.has_window) {
    const int lo = q0 - s.window + 1;  // lowest key the first row sees
    if (lo > 0) begin = lo / kBKV;
  }
}

// Block (bh, q tile) from the flat block index: grid.x = batch*heads*q_tiles.
struct Block {
  int b, h, kvh, q0;
};
__device__ __forceinline__ Block block_of(const Shape& s) {
  const int q_tiles = (s.sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / q_tiles;
  Block blk;
  blk.b = bh / s.heads;
  blk.h = bh % s.heads;
  blk.kvh = blk.h / (s.heads / s.kv_heads);  // GQA: kv head = q head // g
  blk.q0 = (blockIdx.x % q_tiles) * kBQ;
  return blk;
}

// ---------------------------------------------------------------- primitives
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}

// global -> shared, asynchronously; zeros where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ------------------------------------------------ the warp-layout carry
// The f32 carry of one warp's 16 q rows: rows row[0] = band row g and
// row[1] = g + 8, and of each of the DT n8 output tiles the columns 2t and
// 2t + 1 of both rows (acc[jj][2h + e]: row h, column 8jj + 2t + e).
template <int DT>
struct WarpRows {
  int row[2];
  float m[2], l[2], acc[DT][4];

  __device__ __forceinline__ void init(const Block& blk) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = blk.q0 + warp * 16 + (lane >> 2) + 8 * h;
      m[h] = kNeg;
      l[h] = 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < DT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
  }

  // One KV tile of the online softmax.  p holds this thread's scores of the
  // tile's keys kv0 + 8j + 2t + e at p[j][2h + e] (row h), before masking;
  // leaves p = exp(s - m_new), 0 where masked, and rescales acc.
  template <int NT>
  __device__ __forceinline__ void softmax(const Shape& s, int kv0,
                                          float (&p)[NT][4]) {
    const int t = threadIdx.x & 3;
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!visible(s, row[h], kv0 + j * 8 + 2 * t + e))
            p[j][2 * h + e] = kNeg;
          mx = fmaxf(mx, p[j][2 * h + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = visible(s, row[h], kv0 + j * 8 + 2 * t + e)
                               ? expf(p[j][2 * h + e] - m_new)
                               : 0.f;
          p[j][2 * h + e] = pe;
          rs += pe;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      alpha[h] = expf(m[h] - m_new);
      l[h] = l[h] * alpha[h] + rs;
      m[h] = m_new;
    }
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) {
      acc[jj][0] *= alpha[0];
      acc[jj][1] *= alpha[0];
      acc[jj][2] *= alpha[1];
      acc[jj][3] *= alpha[1];
    }
  }

  // acc += p.astype(bf16) @ v on mma.sync m16n8k16: the C layout of two n8
  // score tiles is the A fragment of 16 keys, so p goes from the score
  // registers to the tensor cores; V's B fragments come from ldmatrix.trans
  // of vs, a (kBKV, 8 * DT) bf16 tile with rows of vp bytes.
  template <int NT>
  __device__ __forceinline__ void pv_bf16(const float (&p)[NT][4],
                                          const int8_t* vs, int vp) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      const uint32_t a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                             pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                             pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                             pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
      for (int jj = 0; jj < DT; jj += 2) {
        uint32_t r[4];
        ldsm_x4_trans(r, vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  vp + (jj * 8 + (lane >> 4) * 8) * 2);
        mma_bf16(acc[jj], a, r[0], r[1]);
        mma_bf16(acc[jj + 1], a, r[2], r[3]);
      }
    }
  }

  // out[b, q, h, :] = acc / max(l, 1e-30) in T, rows < sq and columns < dh
  template <typename T>
  __device__ __forceinline__ void store(const Shape& s, const Block& blk,
                                        T* __restrict__ out) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= s.sq) continue;
      const float den = fmaxf(l[h], 1e-30f);
      T* o = out + (((size_t)blk.b * s.sq + row[h]) * s.heads + blk.h) * s.dh;
#pragma unroll
      for (int jj = 0; jj < DT; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = jj * 8 + 2 * t + e;
          if (c < s.dh) o[c] = from_float<T>(acc[jj][2 * h + e] / den);
        }
    }
  }
};

// The smallest instantiated head width >= dh (16, 32, 64, 128), 0 if none:
// a wider head takes the wide kernels below.
inline int head_tile(int dh) {
  for (int t = 16; t <= 128; t *= 2)
    if (dh <= t) return t;
  return 0;
}

// ------------------------------------------------ the wide kernels
// A head wider than the widest tile (dh > 128: recurrentgemma-2b's 256), and
// B4 on int16 q and k at any dh, split the output's head dim over blocks of
// kDC columns (grid.y = ceil(dh / kDC)).  Each block walks QK^T over the whole
// dh in chunks staged through shared memory, so every column block recomputes
// the scores, and runs PV and the store for its kDC columns only: a warp's
// carry stays at 16 rows x kDC (64 f32 registers a thread).
constexpr int kDC = 128;

// 64 rows of columns [c0, c0 + W) of a slab in T (row r at base + r * stride)
// into shared rows of `pitch` bytes, zero past n_rows and dh: 16-byte cp.async
// pieces when `vec` (dh * sizeof(T) a multiple of 16, the tensors 16-byte
// aligned), else element by element (plain stores, seen after the caller's
// barrier).
template <typename T, int W>
__device__ __forceinline__ void stage_cols(int8_t* dst, int pitch,
                                           const T* base, size_t stride,
                                           int n_rows, int c0, int dh,
                                           bool vec) {
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T), CP = W / E;  // pieces a row
    for (int e = threadIdx.x; e < 64 * CP; e += kThreads) {
      const int r = e / CP, c = (e % CP) * E;
      const bool ok = r < n_rows && c0 + c < dh;
      cp_async16(dst + r * pitch + c * (int)sizeof(T),
                 ok ? base + r * stride + c0 + c : base, ok);
    }
  } else {
    for (int e = threadIdx.x; e < 64 * W; e += kThreads) {
      const int r = e / W, c = e % W;
      T x = from_float<T>(0.f);
      if (r < n_rows && c0 + c < dh) x = base[r * stride + c0 + c];
      *reinterpret_cast<T*>(dst + r * pitch + c * (int)sizeof(T)) = x;
    }
  }
}

// The wide kernels' f32 PV: the warp parks its p (16 rows of kBKV + 4 floats
// at ps), then each lane sums its columns over the 64 keys in f32 FMAs (vs: a
// (kBKV, 8 * DT) f32 tile with rows of vp bytes).
template <int NT, int DT>
__device__ __forceinline__ void pv_f32(WarpRows<DT>& wr,
                                       const float (&p)[NT][4], float* ps,
                                       const int8_t* vs, int vp) {
  constexpr int PP = kBKV + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(ps + (g + 8 * h) * PP + j * 8 + 2 * t) =
          make_float2(p[j][2 * h], p[j][2 * h + 1]);
  __syncwarp();
  const float* vf = reinterpret_cast<const float*>(vs);
  for (int c = 0; c < kBKV; ++c) {
    const float p0 = ps[g * PP + c], p1 = ps[(g + 8) * PP + c];
    const float* vr = vf + c * (vp / 4);
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

// out[b, q, h, c0 + c] = acc / max(l, 1e-30) in T, rows < sq and columns
// c0 + c < dh: the store of a wide kernel's column block
template <typename T, int DT>
__device__ __forceinline__ void store_cols(const WarpRows<DT>& wr,
                                           const Shape& s, const Block& blk,
                                           T* __restrict__ out, int c0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (wr.row[h] >= s.sq) continue;
    const float den = fmaxf(wr.l[h], 1e-30f);
    T* o = out + (((size_t)blk.b * s.sq + wr.row[h]) * s.heads + blk.h) * s.dh;
#pragma unroll
    for (int jj = 0; jj < DT; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + jj * 8 + 2 * t + e;
        if (c < s.dh) o[c] = from_float<T>(wr.acc[jj][2 * h + e] / den);
      }
  }
}

}  // namespace fa
