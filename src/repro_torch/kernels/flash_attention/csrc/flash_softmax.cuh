// The online-softmax half of kernels B5 (flash_attention.cu) and B4
// (flash_attention_l2r.cu): tiling, masks, the tensor-core and copy
// primitives, the warp-layout (m, l, acc) carry, the bf16 and 3xTF32 PV, the
// epilogue, and the wide layout both kernels take above dh 128 (B4 also on
// int16 q, k).  The two kernels differ only in how they fill a score tile.
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

// KV tiles of KV keys [begin, end) that intersect the band of q rows
// [q0, q0 + kBQ)
template <int KV = kBKV>
__device__ __forceinline__ void kv_tiles(const Shape& s, int q0, int& begin,
                                         int& end) {
  end = (s.skv + KV - 1) / KV;
  if (s.causal) end = min(end, (q0 + kBQ - 1) / KV + 1);
  begin = 0;
  if (s.has_window) {
    const int lo = q0 - s.window + 1;  // lowest key the first row sees
    if (lo > 0) begin = lo / KV;
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

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cvt.rna.tf32.f32 on the bit pattern (round to nearest, ties away from
// zero: the sign is its own bit, so adding half a TF32 ulp rounds the
// magnitude), two integer operations instead of the conversion pipe
__device__ __forceinline__ uint32_t rna_tf32(uint32_t u) {
  return (u + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32; x - big is exact in f32 (Sterbenz)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = rna_tf32(__float_as_uint(x));
  small = rna_tf32(__float_as_uint(x - __uint_as_float(big)));
}

// c += a.b on the 3xTF32 split of a (A fragment) and b (B fragment):
// small_a.big_b + big_a.small_b + big_a.big_b in f32, about 2^-22 relative
// a product
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0,
                                           float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(c, as, bb0, bb1);  // the small terms first
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
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

// The barrier of a wide row group's two warps alone (ids 1-4; 0 is
// __syncthreads'): it orders their exchange slab's writes before its reads.
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(rg + 1) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 bf16 (16 bytes, element i in the low half of word i / 2 when i is even)
// as f32
__device__ __forceinline__ void widen8(uint4 w, float (&f)[8]) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(x[i] << 16);
    f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}

// ------------------------------------------------ the warp-layout carry
// The f32 carry of one warp's 16 q rows: rows row[0] = band row g and
// row[1] = g + 8, and of each of the DT n8 output tiles the columns 2t and
// 2t + 1 of both rows (acc[jj][2h + e]: row h, column 8jj + 2t + e).
template <int DT>
struct WarpRows {
  int row[2];
  float m[2], l[2], acc[DT][4];

  // rg: the warp's row group, rows 16 rg .. 16 rg + 15 of the block's band
  __device__ __forceinline__ void init(const Block& blk, int rg) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = blk.q0 + rg * 16 + (lane >> 2) + 8 * h;
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

  // One KV tile of the online softmax in a pair of the wide layout (below),
  // of which this warp holds half: sc[j][2h + e] is the score of key kb +
  // 8j + 2t + e of the tile at kv0 (of KV keys), row h, before masking.  The
  // two halves' row maxima meet in the spare columns of the row group's
  // exchange slab xs (rows of xp >= KV + 4 floats), each warp turns its
  // half into p = exp(s - m_new), 0 where masked, and parks it with its row
  // sums, and both read the whole tile back into p in the C layout.  The
  // pair ends with the same m, l (the halves' sums added low half first)
  // and p bits, and acc rescaled.
  template <int NTW, int NT>
  __device__ __forceinline__ void softmax_pair(const Shape& s, int kv0,
                                               int kb, int half, int rg,
                                               float* xs, int xp,
                                               float (&sc)[NTW][4],
                                               float (&p)[NT][4]) {
    constexpr int KV = 8 * NT;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float mx[2], m_new[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = kNeg;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!visible(s, row[h], kv0 + kb + j * 8 + 2 * t + e))
            sc[j][2 * h + e] = kNeg;
          mx[h] = fmaxf(mx[h], sc[j][2 * h + e]);
        }
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (t == 0) xs[(g + 8 * h) * xp + KV + half] = mx[h];
    }
    pair_sync(rg);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* x = xs + (g + 8 * h) * xp + KV;
      m_new[h] = fmaxf(m[h], fmaxf(x[0], x[1]));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        float pe[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pe[e] = visible(s, row[h], kv0 + kb + j * 8 + 2 * t + e)
                      ? expf(sc[j][2 * h + e] - m_new[h])
                      : 0.f;
          rs += pe[e];
        }
        *reinterpret_cast<float2*>(xs + (g + 8 * h) * xp + kb + j * 8 +
                                   2 * t) = make_float2(pe[0], pe[1]);
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      if (t == 0) xs[(g + 8 * h) * xp + KV + 2 + half] = rs;
    }
    pair_sync(rg);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 f = *reinterpret_cast<const float2*>(
            xs + (g + 8 * h) * xp + j * 8 + 2 * t);
        p[j][2 * h] = f.x;
        p[j][2 * h + 1] = f.y;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* x = xs + (g + 8 * h) * xp + KV + 2;
      alpha[h] = expf(m[h] - m_new[h]);
      l[h] = l[h] * alpha[h] + (x[0] + x[1]);
      m[h] = m_new[h];
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
  // of vs, a (16 * NT / 2, 8 * DT) bf16 tile with rows of vp bytes.  Output
  // tiles from column ncols on are skipped (columns past dh).
  template <int NT>
  __device__ __forceinline__ void pv_bf16(const float (&p)[NT][4],
                                          const int8_t* vs, int vp,
                                          int ncols = 8 * DT) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      const uint32_t a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                             pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                             pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                             pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
      for (int jj = 0; jj < DT; jj += 2) {
        if (jj * 8 >= ncols) continue;
        uint32_t r[4];
        ldsm_x4_trans(r, vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  vp + (jj * 8 + (lane >> 4) * 8) * 2);
        mma_bf16(acc[jj], a, r[0], r[1]);
        mma_bf16(acc[jj + 1], a, r[2], r[3]);
      }
    }
  }

  // acc += p @ v in f32 as the 3xTF32 split on mma.sync.m16n8k8.tf32 (one
  // TF32 product would break the 3e-5 limit).  The score registers are the A
  // fragment once each 8-key chunk is read with its keys in the order
  // 0,2,4,6,1,3,5,7 (the same order for V's rows, so the sum is unchanged);
  // V's B fragments are read from vf, a (8 * NT, 8 * DT) f32 tile with rows
  // of vpf floats (conflict-free when vpf % 32 is 4).  Output tiles from
  // column ncols on are skipped.
  template <int NT>
  __device__ __forceinline__ void pv_tf32x3(const float (&p)[NT][4],
                                            const float* vf, int vpf,
                                            int ncols = 8 * DT) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ab[4], as[4];
      const float a[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[e], as[e]);
      const float* v0 = vf + (j * 8 + 2 * t) * vpf + g;
#pragma unroll
      for (int jj = 0; jj < DT; ++jj)
        if (jj * 8 < ncols)
          mma_3xtf32(acc[jj], ab, as, v0[jj * 8], v0[vpf + jj * 8]);
    }
  }

  // out[b, q, h, c0 + c] = acc / max(l, 1e-30) in T, rows < sq and columns
  // c0 + c < dh (c0: the first output column this warp holds)
  template <typename T>
  __device__ __forceinline__ void store(const Shape& s, const Block& blk,
                                        T* __restrict__ out,
                                        int c0 = 0) const {
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
          const int c = c0 + jj * 8 + 2 * t + e;
          if (c < s.dh) o[c] = from_float<T>(acc[jj][2 * h + e] / den);
        }
    }
  }
};

// The smallest instantiated head width >= dh (16, 32, 64, 128), 0 if none:
// a wider head takes the wide layout below.
inline int head_tile(int dh) {
  for (int t = 16; t <= 128; t *= 2)
    if (dh <= t) return t;
  return 0;
}

// ------------------------------------------------ the wide layout
// Heads wider than 128 (kernels B5 and B4; recurrentgemma-2b's 256) and B4
// on int16 q and k at any dh.  One block owns 64 q rows of one (batch, head)
// and kWCols = 256 output columns: one block up to dh 256, above it grid.y =
// ceil(dh / 256) column blocks.  8 warps: warp w holds the rows of row group
// rg = w % 4 (16 rg .. 16 rg + 15) and output columns 128 * (w / 4) .. + 127
// of the block's, so its carry stays at 16 x 128 (64 f32 registers a
// thread); a half of 129-255 columns leaves the last warps' tiles ragged
// (masked), and a warp with no column computes only its half of the scores
// and of p.
//  * Each score is computed once.  The two warps of a row group (a pair, w
//    and w ^ 4) split a KV tile's keys in halves: each computes its half of
//    the pair's 16-row score tile over the whole dh, and the pair runs the
//    online softmax over the halves (WarpRows::softmax_pair): the row
//    maxima meet in the row group's slab of an exchange area, each warp
//    turns its half into p and parks it there with its row sums, and after
//    a barrier of the pair alone (bar.sync 1 + rg, 64) both read the whole
//    tile of p back in the mma C layout.  Both then hold the same m, l and
//    p bits, and each runs PV for its own columns.  A score's exp is taken
//    once, by the warp that computed it.
//  * q stays in shared memory for the whole band up to dh 256 (kWRes),
//    staged once; above it QK^T walks d chunks of kWChunk columns of q and
//    K, a chunk of both in flight while the last computes, the scores'
//    accumulators carried from chunk to chunk.
//  * K (the tile's rows over the whole dh, or a chunk), V (the block's
//    columns) and B4's key scales come through two-slot cp.async rings: the
//    next tile's copies run while this one computes, and each is read once
//    per block.
//  * The KV tile is 64 keys where the layout fits the 227 KB a block may
//    have at dh 256, else 32 (f32 v with 4-byte q, k: B5 f32; or with int16
//    q, k: B4): wide_kv.
constexpr int kWWarps = 8;
constexpr int kWThreads = kWWarps * 32;
constexpr int kWCols = 256;      // output columns a block
constexpr int kWRes = 256;       // q resident (one d chunk) up to this dh
constexpr int kWChunk = 128;     // d columns a chunk above it
constexpr int kSmemMax = 232448; // bytes of shared memory a block may take

// The shared memory of one wide launch: q (64 rows: resident, or two chunk
// slots), K and V (two slots of KV rows each), B4's key scales (two slots of
// KV floats) and the exchange area (4 row groups x 16 rows x xp floats).
// qb, kb, vb: bytes an element of q as staged, of k and of v.
struct WideLayout {
  int nch;  // d chunks of QK^T: 1 (q resident) or ceil(dh / kWChunk)
  int dw;   // d columns a staged q / K row holds (whole 32s)
  int vw;   // V columns a staged row holds (whole 32s, <= kWCols)
  int xp;   // floats an exchange row: KV + 8 (float2 accesses on distinct
            // banks within each half warp; columns KV .. KV + 3 hold the
            // halves' row maxima and sums)
  int qp, kp, vp;         // row pitches, bytes
  int q, k, v, sc, x;     // offsets, bytes
  int bytes;
  __host__ __device__ constexpr WideLayout(int qb, int kb, int vb, int kv,
                                           int dh)
      : nch(dh <= kWRes ? 1 : (dh + kWChunk - 1) / kWChunk),
        dw(dh <= kWRes ? (dh + 31) / 32 * 32 : kWChunk),
        vw(dh <= kWCols ? (dh + 31) / 32 * 32 : kWCols),
        xp(kv + 8),
        qp(dw * qb + kPad),
        kp(dw * kb + kPad),
        vp(vw * vb + kPad),
        q(0),
        k(q + (nch == 1 ? 1 : 2) * kBQ * qp),
        v(k + 2 * kv * kp),
        sc(v + 2 * kv * vp),
        x(sc + 2 * kv * 4),
        bytes(x + 4 * 16 * xp * 4) {}
};

// The most a launch takes: at dh 256 (resident) or chunked
__host__ __device__ constexpr int wide_max_bytes(int qb, int kb, int vb,
                                                 int kv) {
  return WideLayout(qb, kb, vb, kv, kWRes).bytes >
                 WideLayout(qb, kb, vb, kv, kWRes + 1).bytes
             ? WideLayout(qb, kb, vb, kv, kWRes).bytes
             : WideLayout(qb, kb, vb, kv, kWRes + 1).bytes;
}

// The KV tile of a wide kernel: 64 keys when the layout fits, else 32
__host__ __device__ constexpr int wide_kv(int qb, int kb, int vb) {
  return wide_max_bytes(qb, kb, vb, 64) <= kSmemMax ? 64 : 32;
}

// rows [0, n) and columns [c0, c0 + w) of a slab of T (row r at base + r *
// stride) into shared rows of `pitch` bytes: rows < n_rows and columns < dh
// copied, the rest zero.  16-byte cp.async pieces when `vec` (dh * sizeof(T)
// a multiple of 16, the tensor 16-byte aligned), else element by element
// (plain stores, seen after the caller's barrier).
template <typename T>
__device__ __forceinline__ void stage_slab(int8_t* dst, int pitch,
                                           const T* base, size_t stride,
                                           int n, int n_rows, int c0, int w,
                                           int dh, bool vec) {
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T);
    const int cp = w / E;  // pieces a row
    for (int e = threadIdx.x; e < n * cp; e += kWThreads) {
      const int r = e / cp, c = (e % cp) * E;
      const bool ok = r < n_rows && c0 + c < dh;
      cp_async16(dst + r * pitch + c * (int)sizeof(T),
                 ok ? base + r * stride + c0 + c : base, ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * w; e += kWThreads) {
      const int r = e / w, c = e % w;
      T x{};
      if (r < n_rows && c0 + c < dh) x = base[r * stride + c0 + c];
      *reinterpret_cast<T*>(dst + r * pitch + c * (int)sizeof(T)) = x;
    }
  }
}

// stage_slab of bf16 rows widened to f32 in shared memory, with plain loads
// (exact: every bf16 is an f32)
__device__ __forceinline__ void stage_widen(int8_t* dst, int pitch,
                                            const __nv_bfloat16* base,
                                            size_t stride, int n, int n_rows,
                                            int c0, int w, int dh, bool vec) {
  if (vec) {
    const int cp = w / 8;
    for (int e = threadIdx.x; e < n * cp; e += kWThreads) {
      const int r = e / cp, c = (e % cp) * 8;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r < n_rows && c0 + c < dh)
        x = *reinterpret_cast<const uint4*>(base + r * stride + c0 + c);
      float f[8];
      widen8(x, f);
      float4* d = reinterpret_cast<float4*>(dst + r * pitch + c * 4);
      d[0] = make_float4(f[0], f[1], f[2], f[3]);
      d[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  } else {
    for (int e = threadIdx.x; e < n * w; e += kWThreads) {
      const int r = e / w, c = e % w;
      float x = 0.f;
      if (r < n_rows && c0 + c < dh)
        x = __bfloat162float(base[r * stride + c0 + c]);
      *reinterpret_cast<float*>(dst + r * pitch + c * 4) = x;
    }
  }
}

// A wide warp's place: its row group and column half, the first output
// column it holds and how many of its 128 lie below dh, and its keys' offset
// in a KV tile of KV keys
struct WideWarp {
  int rg, half, c0, ncols, kb;
  __device__ __forceinline__ WideWarp(const Shape& s, int kv) {
    const int warp = threadIdx.x >> 5;
    rg = warp & 3;
    half = warp >> 2;
    c0 = blockIdx.y * kWCols + half * 128;
    ncols = min(128, s.dh - c0);
    kb = half * (kv / 2);
  }
};

}  // namespace fa
