// Kernel B2: the per-level snapshot stream of the MSDF digit-plane GEMM for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/l2r_gemm/kernel.py:_l2r_streaming_kernel
// (reached through l2r_gemm_pallas_streaming_planes).  It walks the same
// level-stacked schedule as kernel B1 over pre-shifted int8 plane stacks,
// A_stack (M, D*K) ascending and B_rev (D*K, N) descending, and writes
//
//     C[l] (M, N) int32 = the sum of levels 0 .. l of the walk,
//
// an (L, M, N) stream whose plane l is bit-identical to B1 truncated at
// levels = l + 1.  The number of levels to run is an int32 read from device
// memory (the TPU kernel's scalar-prefetched `cnt_ref`), so an early-exit
// consumer can set it without a host sync: levels at or above it skip both
// the products and the writes, and their planes are left as they were.
//
// Design, against the TPU original:
//  * The TPU kernel writes the running VMEM accumulator to the current
//    level's output block at every grid step, and the last write before the
//    walk moves on is that level's snapshot.  Here the block keeps the
//    accumulator in registers and adds it into plane l once, at the level's
//    last chunk (mode kStream of the level-walk template in l2r_walk.cuh).
//  * Split-K at small M (the FC head at batch 8): a split block owes every
//    plane from its first level to the last.  It adds its running partial at
//    each level boundary inside its range, and at the end of its range adds
//    its total to the plane of the level it stopped in and to every later
//    plane, with int32 atomics (order-free, wrapping like the reference).
//  * The stream is accumulated into C, so the caller zeroes it, or passes the
//    stream of earlier taps (the progressive conv's tap sum in one buffer).
//  * Bound on this card (H100 SXM data sheet: int8 1,979 TOP/s dense, HBM
//    3.35 TB/s): the same operations as B1, 2*M*N*K*D^2, against the stacks
//    read once plus the L output planes written (read and written when
//    accumulating).  At the VGG-16 head (M = 8) the weight stack dominates;
//    on conv taps the L planes of int32 output make it byte bound.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include "l2r_walk.cuh"

// C (n_levels, m, n) int32 += the per-level prefixes of the walk over
// a (m, lda) and b (rows, ldb = n), levels as in l2r_stacked_gemm.
// level_count points to one int32 on the device: levels at or above it are
// skipped.  Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int l2r_streaming_gemm(const void* a, const void* b, void* c, int m,
                                  int n, int lda, int ldb, int n_levels,
                                  const int* a_col, const int* b_row,
                                  const int* len, const void* level_count,
                                  void* stream) {
  if (n_levels < 1 || n_levels > l2r::kMaxLevels || m < 1 || n < 1 ||
      level_count == nullptr)
    return (int)cudaErrorInvalidValue;
  l2r::Walk w = {};
  w.lt.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    w.lt.a_col[l] = a_col[l];
    w.lt.b_row[l] = b_row[l];
    w.lt.len[l] = len[l];
  }
  if (!l2r::finish_table(w.lt)) return (int)cudaErrorInvalidValue;
  w.level_count = (const int*)level_count;
  return (int)l2r::run<l2r::kStream>(a, b, c, m, n, lda, ldb, w, stream);
}
