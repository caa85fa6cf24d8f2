// The byte split: an int16 product on the int8 tensor cores.  Shared by the
// int16 entries of kernels B1 and B3 (l2r_gemm16.cuh) and by the wide route
// of kernel B4 (flash_attention/csrc/flash_attention_l2r.cu).
//
// An int16 operand, masked first (the top plane's sign extension included,
// as the raw bits hold it), is split as x = 256 xh + xl (xh = x >> 8 as s8,
// xl = x & 0xff as u8), and
//
//   x . y = 2^16 xh.yh + 2^8 (xh.yl + xl.yh) + xl.yl
//
// over mma.sync.m16n8k32 s8.s8, s8.u8 + u8.s8 (one accumulator) and u8.u8
// products, combined in unsigned 32-bit arithmetic: the reference's wrapping
// int32 dot mod 2^32 in any order.  Per contraction element a byte-pair sum
// moves by at most 2 * 128 * 255 (the cross sum; xl.yl by 255^2, xh.yh by
// 128^2), so no accumulator leaves int32 below 32,896 elements of contraction:
// a caller folds its accumulators into the result at least that often, and the
// exactness does not rest on how mma wraps.
//
// Fragments.  ldmatrix.x4 of int16 rows gives lane (g, t) = (l >> 2, l & 3)
// elements {2t, 2t + 1} of each 8 of a row: for a 16 x 32 A tile (two x4, at
// bytes 0 and 32 of the rows) x[0..3] hold rows g / g + 8 at elements 2t and
// 8 + 2t, x[4..7] the same 16 further on; for an 8-column B tile (one x4 of
// the K-major rows, or ldmatrix.trans of row-major (K, N) rows) x[q] holds
// column g at elements 8q + 2t.  Byte permutes put the high or the low bytes
// of two such registers in one: the mma's k position 4t + e holds element
// {2t, 2t + 1, 8 + 2t, 9 + 2t}[e] (plus 16 for the fragment's second half),
// the same order for A and B, so the sum is the same.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "l2r_mma.cuh"

namespace l2r {

__device__ __forceinline__ void mma_hl(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_lh(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_ll(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The high (s8) or low (u8) bytes of two words of int16 pairs, x's first
template <bool HI>
__device__ __forceinline__ uint32_t bytes_of(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, HI ? 0x7531 : 0x6420);
}

// A 16 x 32 int16 A fragment (x as above) under `mask` (a 16-bit mask in
// both halves) -> its high and low byte fragments
__device__ __forceinline__ void split_a(const uint32_t (&x)[8], uint32_t mask,
                                        uint32_t (&h)[4], uint32_t (&l)[4]) {
  uint32_t m[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) m[e] = x[e] & mask;
#pragma unroll
  for (int r = 0; r < 4; ++r) {  // rows g, g + 8; elements 0-15, 16-31
    const int e = (r >> 1) * 4 + (r & 1);
    h[r] = bytes_of<true>(m[e], m[e + 2]);
    l[r] = bytes_of<false>(m[e], m[e + 2]);
  }
}

// An 8-column int16 B fragment under `mask` -> its high and low bytes
__device__ __forceinline__ void split_b(const uint32_t (&x)[4], uint32_t mask,
                                        uint32_t (&h)[2], uint32_t (&l)[2]) {
  const uint32_t m[4] = {x[0] & mask, x[1] & mask, x[2] & mask, x[3] & mask};
  h[0] = bytes_of<true>(m[0], m[1]);
  h[1] = bytes_of<true>(m[2], m[3]);
  l[0] = bytes_of<false>(m[0], m[1]);
  l[1] = bytes_of<false>(m[2], m[3]);
}

// The four byte-pair products of a k32 step into the three accumulators
__device__ __forceinline__ void mma_bytes(int (&hh)[4], int (&cr)[4],
                                          int (&ll)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  mma_s8(hh, ah, bh[0], bh[1]);
  mma_hl(cr, ah, bl);
  mma_lh(cr, al, bh);
  mma_ll(ll, al, bl);
}

// The int32 dot the three accumulators hold, wrapping as the reference's
__device__ __forceinline__ uint32_t combine(int hh, int cr, int ll) {
  return ((uint32_t)hh << 16) + ((uint32_t)cr << 8) + (uint32_t)ll;
}

}  // namespace l2r
