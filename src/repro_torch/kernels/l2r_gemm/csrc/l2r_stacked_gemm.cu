// Kernel B1: the level-stacked MSDF digit-plane GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/l2r_gemm/kernel.py:_l2r_stacked_kernel
// (reached through l2r_gemm_pallas_stacked_planes).  It computes
//
//     C (M, N) int32 = sum over the MSDF levels s of  A_stack[:, i_lo*K : (i_hi+1)*K]
//                                                  @ B_rev[(d-1-s+i_lo)*K : ..., :]
//
// over pre-shifted int8 digit-plane stacks: A_stack (M, D*K) with ascending
// planes, B_rev (D*K, N) with descending planes.  A level's plane pairs are one
// contiguous column slab of A_stack against one contiguous row slab of B_rev, so
// each level is a plain contraction of depth n_pairs(s)*K.  `levels` truncation
// is a shorter level table.
//
// Design, against the TPU original:
//  * The TPU walks the (level, k-block) schedule as a sequential grid axis with
//    scalar-prefetched index vectors and a VMEM accumulator.  Here one thread
//    block owns one output tile (128 x 128, 128 x 64 where N <= 64, 16 x 128
//    where M <= 16) and loops over the level table (passed by value) and,
//    inside each level, over 64-deep chunks of its slab.  The accumulator stays
//    in registers for the whole walk.
//  * int32 addition wraps and is associative, so any tiling or chunk order gives
//    the reference's bits.  The tensor cores accumulate s8 x s8 products in
//    wrapping s32 (mma.sync ... .s32.s8.s8.s32 without .satfinite); the epilogue
//    adds in unsigned arithmetic, never signed C++ overflow.
//  * No TPU block padding: ragged M, N and K edges are masked here and zero
//    filled in shared memory (zeros are exact), so conv1_1 (K=3) reads 3-deep
//    slabs instead of 128-padded ones.
//  * Bound on this card (H100 SXM data sheet: int8 1,979 TOP/s dense, HBM
//    3.35 TB/s), at batch 8: the deep conv taps (cin >= 256) are operation
//    bound; the shallow taps are bound by their int32 output, which the tap
//    sum reads and writes once per tap; fc6-fc8 by reading the plane-stacked
//    weights.  For the first, each warp runs 16 m16n8k32 mma.sync per 32-deep
//    step; for the second, N <= 64 gets a 128 x 64 tile so no tensor work
//    lands on absent columns; for the third, a 16-row tile wastes no tensor
//    work on empty rows and the level walk is split across blocks (split-K
//    with int32 atomics, exact because the sum wraps identically in any
//    order) so that every SM streams weights.
//  * Simple first: global loads go through registers into a two-stage shared
//    buffer (the next chunk's loads are in flight during this chunk's mma);
//    no cp.async/TMA, no wgmma.  Those are the next step for this kernel.
//  * The kernel body is the level-walk template of l2r_walk.cuh (mode
//    kStacked), shared with kernels B2 and B3.
//
// The kernel adds into C, which the caller initialises.  The launch uses the
// caller's stream, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.

#include "l2r_walk.cuh"

// C (m, n) int32 += the level walk over a (m, lda) and b (rows, ldb = n).
// Level l reads a columns [a_col[l], a_col[l] + len[l]) and b rows
// [b_row[l], b_row[l] + len[l]).  C must hold the sum to add to (zeros for a
// plain product).  Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int l2r_stacked_gemm(const void* a, const void* b, void* c, int m,
                                int n, int lda, int ldb, int n_levels,
                                const int* a_col, const int* b_row,
                                const int* len, void* stream) {
  if (n_levels < 1 || n_levels > l2r::kMaxLevels || m < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  l2r::Walk w = {};
  w.lt.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    w.lt.a_col[l] = a_col[l];
    w.lt.b_row[l] = b_row[l];
    w.lt.len[l] = len[l];
  }
  if (!l2r::finish_table(w.lt)) return (int)cudaErrorInvalidValue;
  return (int)l2r::run<l2r::kStacked>(a, b, c, m, n, lda, ldb, w, stream);
}
