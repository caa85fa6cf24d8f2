// Kernel B4: flash attention whose QK^T tile is the MSDF level walk, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:_l2r_kernel
// (reached through flash_attention_l2r_pallas).  It is kernel B5 with one
// change, the score tile: q and k arrive quantized per vector (one f32 scale
// per query row and per key slot) as pre-shifted int8 digit-plane stacks,
// q_stack (B, Sq, H, D*dh) with ascending planes and k_stack (B, Skv, Kv, D*dh)
// with descending planes.  Each score is
//
//   s_int = sum over the MSDF levels l of  q_stack[a_l : a_l + len_l]
//                                        . k_stack[b_l : b_l + len_l]   (int32)
//   s     = s_int * q_scale * k_scale * scale       (f32, in that order)
//
// where the level table (a_l, b_l, len_l in planes; the host's
// msdf_level_slices, truncated by `levels`) comes by value.  The softmax,
// PV and the output stay float (flash_softmax.cuh, shared with B5).
//
// Design, against the TPU original:
//  * Each level is one int8 contraction over a contiguous slice pair, as in
//    the TPU kernel's static walk; here each thread accumulates its 4 x 4
//    score cells with __dp4a (four int8 products per instruction, int32
//    wrapping sums, so any order gives the reference's bits).
//  * The stacks are staged in shared memory with each plane padded to the
//    head tile (a multiple of 16 bytes, zero filled), so every slice starts
//    on a 4-byte word for any dh, and the odd row pitch in words keeps the
//    key rows of a half-warp on distinct banks.
//  * Bound on this card: the int8 QK^T of the full-depth function (2 * dh
//    operations per pair at the int8 tensor peak) plus the float PV; the
//    walk itself runs D^2 = 16 int8 products per full-depth product, on the
//    CUDA cores, so this first version is far from that bound.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include "flash_softmax.cuh"

namespace {

constexpr int kMaxLevels = 16;  // 2D - 1 for D <= 8 (int8 planes)

struct Levels {
  int n;
  int a_plane[kMaxLevels], b_plane[kMaxLevels], planes[kMaxLevels];
};

// row pitch of a staged stack in 32-bit words: D planes of DH bytes, odd
template <int DH>
__host__ __device__ inline int pitch_words(int d) {
  return d * DH / 4 + 1;
}

template <int DH>
int smem_bytes(int d) {
  return (fa::kBQ + fa::kBKV) * pitch_words<DH>(d) * 4 +
         (fa::kBKV + fa::kBKV * DH + fa::kBQ * (fa::kBKV + 1)) *
             (int)sizeof(float);
}

// rows [pos0, pos0 + rows) of one head's plane stack -> shared memory bytes,
// plane p of a row at byte p*DH; zeros past `len` rows and past dh
template <int DH>
__device__ __forceinline__ void load_stack(const int8_t* __restrict__ st,
                                           size_t row_stride, int pos0,
                                           int rows, int len, int d, int dh,
                                           int8_t* sm, int pitch_bytes) {
  const int width = d * DH;
  for (int e = threadIdx.x; e < rows * width; e += fa::kThreads) {
    const int r = e / width, rem = e % width, p = rem / DH, c = rem % DH;
    int8_t x = 0;
    if (pos0 + r < len && c < dh)
      x = st[(size_t)(pos0 + r) * row_stride + p * dh + c];
    sm[r * pitch_bytes + p * DH + c] = x;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(fa::kThreads)
    flash_l2r_kernel(const int8_t* __restrict__ qst,
                     const float* __restrict__ qsc,
                     const int8_t* __restrict__ kst,
                     const float* __restrict__ ksc, const T* __restrict__ v,
                     T* __restrict__ out, fa::Shape s, Levels lt, int d) {
  extern __shared__ float smem[];
  const int pw = pitch_words<DH>(d);
  int* qw = reinterpret_cast<int*>(smem);  // kBQ x pw
  int* kw = qw + fa::kBQ * pw;             // kBKV x pw
  float* kscale = reinterpret_cast<float*>(kw + fa::kBKV * pw);  // kBKV
  float* vs = kscale + fa::kBKV;           // kBKV x DH
  float* ps = vs + fa::kBKV * DH;          // kBQ x (kBKV + 1)
  const fa::Block blk = fa::block_of(s);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t width = (size_t)d * s.dh;

  // q rows of this (batch, head): stride heads * D*dh between positions
  load_stack<DH>(qst + ((size_t)blk.b * s.sq * s.heads + blk.h) * width,
                 (size_t)s.heads * width, blk.q0, fa::kBQ, s.sq, d, s.dh,
                 reinterpret_cast<int8_t*>(qw), pw * 4);
  float q_scale[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = blk.q0 + ty * 4 + i;
    q_scale[i] =
        qp < s.sq ? qsc[((size_t)blk.b * s.sq + qp) * s.heads + blk.h] : 0.f;
  }
  fa::Carry<DH> cy;
  cy.init();
  int t0, t1;
  fa::kv_tiles(s, blk.q0, t0, t1);
  for (int t = t0; t < t1; ++t) {
    const int kv0 = t * fa::kBKV;
    load_stack<DH>(kst + ((size_t)blk.b * s.skv * s.kv_heads + blk.kvh) * width,
                   (size_t)s.kv_heads * width, kv0, fa::kBKV, s.skv, d, s.dh,
                   reinterpret_cast<int8_t*>(kw), pw * 4);
    for (int r = threadIdx.x; r < fa::kBKV; r += fa::kThreads)
      kscale[r] = kv0 + r < s.skv
                      ? ksc[((size_t)blk.b * s.skv + kv0 + r) * s.kv_heads +
                            blk.kvh]
                      : 0.f;
    fa::load_v<T, DH>(s, blk, v, kv0, vs);
    __syncthreads();
    int acc[4][4] = {};
    for (int l = 0; l < lt.n; ++l) {
      const int* qa = qw + lt.a_plane[l] * (DH / 4);
      const int* kb = kw + lt.b_plane[l] * (DH / 4);
      const int len = lt.planes[l] * (DH / 4);
      for (int w = 0; w < len; ++w) {
        int a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qa[(ty * 4 + i) * pw + w];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = kb[(tx + 16 * j) * pw + w];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
    }
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sc[i][j] = (float)acc[i][j] * q_scale[i] * kscale[tx + 16 * j] *
                   s.scale;
    fa::online_step<T, DH>(s, blk.q0, kv0, sc, cy, ps, vs);
  }
  fa::store_out<T, DH>(s, blk, cy, out);
}

template <typename T, int DH>
cudaError_t launch(const void* qst, const void* qsc, const void* kst,
                   const void* ksc, const void* v, void* out,
                   const fa::Shape& s, const Levels& lt, int d,
                   cudaStream_t stream) {
  const int bytes = smem_bytes<DH>(d);
  cudaError_t err =
      cudaFuncSetAttribute(flash_l2r_kernel<T, DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)s.batch * s.heads * ((s.sq + fa::kBQ - 1) / fa::kBQ);
  flash_l2r_kernel<T, DH><<<(unsigned)blocks, fa::kThreads, bytes, stream>>>(
      (const int8_t*)qst, (const float*)qsc, (const int8_t*)kst,
      (const float*)ksc, (const T*)v, (T*)out, s, lt, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* qst, const void* qsc, const void* kst,
                     const void* ksc, const void* v, void* out,
                     const fa::Shape& s, const Levels& lt, int d,
                     cudaStream_t stream) {
  switch (fa::head_tile(s.dh)) {
    case 16: return launch<T, 16>(qst, qsc, kst, ksc, v, out, s, lt, d, stream);
    case 32: return launch<T, 32>(qst, qsc, kst, ksc, v, out, s, lt, d, stream);
    case 64: return launch<T, 64>(qst, qsc, kst, ksc, v, out, s, lt, d, stream);
    case 128:
      return launch<T, 128>(qst, qsc, kst, ksc, v, out, s, lt, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out (B, Sq, H, dh) in v's dtype (f32: is_bf16 = 0, bf16: 1) = flash
// attention over the level-walk scores of the plane stacks q_stack, k_stack
// (int8, D planes of dh) with scales q_scale (B, Sq, H) and k_scale
// (B, Skv, Kv), f32.  Level l walks planes [a_plane[l], a_plane[l] +
// planes[l]) of q against [b_plane[l], ...) of k; has_window = 0 means no
// window.  Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int flash_attention_l2r(
    const void* q_stack, const void* q_scale, const void* k_stack,
    const void* k_scale, const void* v, void* out, int batch, int sq, int skv,
    int heads, int kv_heads, int dh, int d, int causal, int has_window,
    int window, float scale, int n_levels, const int* a_plane,
    const int* b_plane, const int* planes, int is_bf16, void* stream) {
  if (batch < 1 || sq < 1 || skv < 1 || kv_heads < 1 || heads % kv_heads ||
      dh < 1 || !fa::head_tile(dh) || d < 1 || d > 8 || n_levels < 0 ||
      n_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  Levels lt = {};
  lt.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    if (a_plane[l] < 0 || b_plane[l] < 0 || planes[l] < 1 ||
        a_plane[l] + planes[l] > d || b_plane[l] + planes[l] > d)
      return (int)cudaErrorInvalidValue;
    lt.a_plane[l] = a_plane[l];
    lt.b_plane[l] = b_plane[l];
    lt.planes[l] = planes[l];
  }
  const fa::Shape s = {batch,  sq, skv, heads, kv_heads, dh, causal ? 1 : 0,
                       has_window ? 1 : 0, window, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16
                   ? dispatch<__nv_bfloat16>(q_stack, q_scale, k_stack,
                                             k_scale, v, out, s, lt, d, st)
                   : dispatch<float>(q_stack, q_scale, k_stack, k_scale, v,
                                     out, s, lt, d, st));
}
