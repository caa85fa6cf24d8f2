// Kernel B5: float flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:_kernel
// (reached through flash_attention_pallas).  q (B, Sq, H, dh), k and v
// (B, Skv, Kv, dh), all f32 or all bf16, kv head = q head // (H / Kv):
//
//   out = softmax(mask(q k^T * scale)) v          (B, Sq, H, dh) in v's dtype
//
// with the causal, window and key-length masks, as an online softmax over KV
// tiles (flash_softmax.cuh holds that half, shared with kernel B4).
//
// Design, against the TPU original:
//  * The TPU grid (batch*head, q block, kv block) walks the KV axis
//    sequentially with (acc, m, l) in VMEM scratch; here one block owns one
//    (batch*head, 64-row q tile) and loops over the KV tiles itself, with the
//    carry in registers.  No padding of Sq or Skv: ragged rows and keys are
//    masked, and the q/k/v layouts are read in place (no head transpose).
//  * QK^T and PV are computed in the block's own body, in f32 FMAs from shared
//    memory (bf16 operands are widened on load; a bf16 x bf16 product is exact
//    in f32, as the reference's f32 dot of upcast bf16 values is).  p is
//    rounded to v's dtype before PV, as the reference does.
//  * Bound on this card: 4 * B * H * dh FLOPs per visible (query, key) pair
//    against the f32 peak outside the tensor cores for f32 (the same
//    arithmetic), the bf16 tensor peak for bf16; q, k, v and out are read
//    and written once.  This first version uses no tensor cores, so bf16 runs
//    at the f32 FMA rate.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include "flash_softmax.cuh"

namespace {

template <int DH>
constexpr int smem_bytes() {
  return (fa::kBQ * (DH + 1) + fa::kBKV * (DH + 1) + fa::kBKV * DH +
          fa::kBQ * (fa::kBKV + 1)) *
         (int)sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(fa::kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, fa::Shape s) {
  extern __shared__ float smem[];
  float* qs = smem;                      // kBQ x (DH + 1)
  float* ks = qs + fa::kBQ * (DH + 1);   // kBKV x (DH + 1)
  float* vs = ks + fa::kBKV * (DH + 1);  // kBKV x DH
  float* ps = vs + fa::kBKV * DH;        // kBQ x (kBKV + 1)
  const fa::Block blk = fa::block_of(s);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  for (int e = threadIdx.x; e < fa::kBQ * DH; e += fa::kThreads) {
    const int r = e / DH, c = e % DH, qp = blk.q0 + r;
    float x = 0.f;
    if (qp < s.sq && c < s.dh)
      x = fa::to_float(
          q[(((size_t)blk.b * s.sq + qp) * s.heads + blk.h) * s.dh + c]);
    qs[r * (DH + 1) + c] = x;
  }
  fa::Carry<DH> cy;
  cy.init();
  int t0, t1;
  fa::kv_tiles(s, blk.q0, t0, t1);
  for (int t = t0; t < t1; ++t) {
    const int kv0 = t * fa::kBKV;
    for (int e = threadIdx.x; e < fa::kBKV * DH; e += fa::kThreads) {
      const int r = e / DH, c = e % DH, kv = kv0 + r;
      float x = 0.f;
      if (kv < s.skv && c < s.dh)
        x = fa::to_float(
            k[(((size_t)blk.b * s.skv + kv) * s.kv_heads + blk.kvh) * s.dh +
              c]);
      ks[r * (DH + 1) + c] = x;
    }
    fa::load_v<T, DH>(s, blk, v, kv0, vs);
    __syncthreads();
    float sc[4][4] = {};
    for (int d = 0; d < DH; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] *= s.scale;
    fa::online_step<T, DH>(s, blk.q0, kv0, sc, cy, ps, vs);
  }
  fa::store_out<T, DH>(s, blk, cy, out);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const fa::Shape& s, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)s.batch * s.heads * ((s.sq + fa::kBQ - 1) / fa::kBQ);
  flash_kernel<T, DH><<<(unsigned)blocks, fa::kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     const fa::Shape& s, cudaStream_t stream) {
  switch (fa::head_tile(s.dh)) {
    case 16: return launch<T, 16>(q, k, v, out, s, stream);
    case 32: return launch<T, 32>(q, k, v, out, s, stream);
    case 64: return launch<T, 64>(q, k, v, out, s, stream);
    case 128: return launch<T, 128>(q, k, v, out, s, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out (B, Sq, H, dh) = flash attention of q, k, v (layouts above), f32
// (is_bf16 = 0) or bf16 (1); has_window = 0 means no window.  Returns a
// cudaError_t as int: 0 when the launch was accepted.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int batch, int sq, int skv,
                               int heads, int kv_heads, int dh, int causal,
                               int has_window, int window, float scale,
                               int is_bf16, void* stream) {
  if (batch < 1 || sq < 1 || skv < 1 || kv_heads < 1 || heads % kv_heads ||
      dh < 1 || !fa::head_tile(dh))
    return (int)cudaErrorInvalidValue;
  const fa::Shape s = {batch,  sq, skv, heads, kv_heads, dh, causal ? 1 : 0,
                       has_window ? 1 : 0, window, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, s, st)
                       : dispatch<float>(q, k, v, out, s, st));
}
