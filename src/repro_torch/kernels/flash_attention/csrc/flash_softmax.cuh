// The online-softmax half of kernels B5 (flash_attention.cu) and B4
// (flash_attention_l2r.cu): tiling, masks, the (m, l, acc) carry, PV and the
// epilogue.  The two kernels differ only in how they fill a score tile.
//
// One thread block owns one (batch * q head, 64-row q tile) and walks the KV
// tiles of 64 keys in order, so the f32 carry stays in registers for the whole
// row band (the TPU kernel carried it in VMEM scratch across a sequential grid
// axis).  256 threads as 16 x 16: thread (ty, tx) holds score rows ty*4 + i and
// columns tx + 16*j (i, j < 4) of each tile, and output columns tx + 16*jj of
// the same rows; a row's 16 threads are 16 neighbouring lanes of one warp, so
// row max and row sum are 4 xor-shuffles.
//
// The arithmetic is the reference's (repro/kernels/flash_attention/kernel.py):
// masked scores are -1e30; p = exp(s - m_new) is zeroed where masked; l sums
// the f32 p; PV takes p rounded to v's dtype (bf16 in, bf16 p), accumulated in
// f32; out = acc / max(l, 1e-30) in v's dtype.  KV tiles that lie wholly
// outside the causal or window band are skipped: such a tile changes neither m,
// l nor acc, so the skip is exact whatever the tile sizes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fa {

constexpr int kBQ = 64;       // q rows per block
constexpr int kBKV = 64;      // keys per KV tile
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

struct Shape {
  int batch, sq, skv, heads, kv_heads, dh;
  int causal;      // 0 or 1
  int has_window;  // 0 or 1; then keys with kv <= q - window are masked
  int window;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

// V tile (kBKV, DH) -> f32 shared memory, zeros past skv and dh.
template <typename T, int DH>
__device__ __forceinline__ void load_v(const Shape& s, const Block& blk,
                                       const T* __restrict__ v, int kv0,
                                       float* vs) {
  for (int e = threadIdx.x; e < kBKV * DH; e += kThreads) {
    const int r = e / DH, c = e % DH, kv = kv0 + r;
    float x = 0.f;
    if (kv < s.skv && c < s.dh)
      x = to_float(v[(((size_t)blk.b * s.skv + kv) * s.kv_heads + blk.kvh) *
                         s.dh + c]);
    vs[r * DH + c] = x;
  }
}

// The f32 carry of one thread: rows ty*4 + i, output columns tx + 16*jj.
template <int DH>
struct Carry {
  float m[4], l[4], acc[4][DH / 16];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = kNeg;
      l[i] = 0.f;
#pragma unroll
      for (int jj = 0; jj < DH / 16; ++jj) acc[i][jj] = 0.f;
    }
  }
};

// One KV tile of the online softmax.  `sc` holds this thread's score cells
// (before masking).  Writes p (rounded to T) to ps (kBQ x (kBKV+1)), then
// reads ps and vs: the caller syncs before (vs loaded) and after (ps, vs
// reused by the next tile).
template <typename T, int DH>
__device__ __forceinline__ void online_step(const Shape& s, int q0, int kv0,
                                            float (&sc)[4][4], Carry<DH>& cy,
                                            float* ps, const float* vs) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float alpha[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    bool mk[4];
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mk[j] = visible(s, q, kv0 + tx + 16 * j);
      if (!mk[j]) sc[i][j] = kNeg;
      mx = fmaxf(mx, sc[i][j]);
    }
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(cy.m[i], mx);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = mk[j] ? expf(sc[i][j] - m_new) : 0.f;
      rs += p;
      ps[(ty * 4 + i) * (kBKV + 1) + tx + 16 * j] =
          to_float(from_float<T>(p));  // p.astype(v.dtype)
    }
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    alpha[i] = expf(cy.m[i] - m_new);
    cy.l[i] = cy.l[i] * alpha[i] + rs;
    cy.m[i] = m_new;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float pv[DH / 16];
#pragma unroll
    for (int jj = 0; jj < DH / 16; ++jj) pv[jj] = 0.f;
    const float* prow = ps + (ty * 4 + i) * (kBKV + 1);
    for (int c = 0; c < kBKV; ++c) {
      const float p = prow[c];
#pragma unroll
      for (int jj = 0; jj < DH / 16; ++jj)
        pv[jj] = fmaf(p, vs[c * DH + tx + 16 * jj], pv[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < DH / 16; ++jj)
      cy.acc[i][jj] = cy.acc[i][jj] * alpha[i] + pv[jj];
  }
  __syncthreads();
}

// out[b, q, h, :] = acc / max(l, 1e-30) in T, rows < sq and columns < dh.
template <typename T, int DH>
__device__ __forceinline__ void store_out(const Shape& s, const Block& blk,
                                          const Carry<DH>& cy,
                                          T* __restrict__ out) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = blk.q0 + ty * 4 + i;
    if (q >= s.sq) continue;
    const float den = fmaxf(cy.l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DH / 16; ++jj) {
      const int c = tx + 16 * jj;
      if (c < s.dh)
        out[(((size_t)blk.b * s.sq + q) * s.heads + blk.h) * s.dh + c] =
            from_float<T>(cy.acc[i][jj] / den);
    }
  }
}

// The smallest instantiated head width >= dh (16, 32, 64, 128), 0 if none.
inline int head_tile(int dh) {
  for (int t = 16; t <= 128; t *= 2)
    if (dh <= t) return t;
  return 0;
}

}  // namespace fa
