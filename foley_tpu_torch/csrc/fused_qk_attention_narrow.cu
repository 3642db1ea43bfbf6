// Fused qk-RMSNorm + RoPE + softmax attention for narrow heads (head_dim 32 or 64), bf16,
// fp16 or fp32, on the CUDA cores.
//
// Replaces the Pallas kernel foley_tpu/ops/pallas/fused_attention.py:82
// (fused_qk_attention_headfirst; body _kernel :57, helpers _norm_rope :50, _rot_half_lanes :39)
// at the head widths the wgmma kernels do not take: fused_qk_attention.cu and
// attention_f32.cu are built for head_dim 128 (XL, XXL); the TINY config has 2 heads of 32.
// It computes what they compute, per batch row b, head h and query row i:
//   qn = rope(rms_norm(q[b, i, h]) * wq[i]),  kn = rope(rms_norm(k[b, j, h]) * wk[j])   (fp32)
//   o[b, i, h] = softmax_j(qn . kn / sqrt(D)) @ v[b, :, h]
// with the normalised/rotated q and k rounded to the input type before the products, fp32
// logits and accumulation, and p rounded to that type before p @ v. The rotation is
// pair-adjacent: out[2m] = x[2m] cos[2m] - x[2m+1] sin[2m],
// out[2m+1] = x[2m+1] cos[2m+1] + x[2m] sin[2m+1]. The weight and cos/sin tables are fp32
// [L, D], one row per position.
//
// Bound on an NVIDIA H100 SXM: at TINY's shapes (a 1 s request: B 2, L 50-60, 2 heads of 32)
// a launch moves about 60 KB and does about 1 MFLOP, under a microsecond at either rate:
// what it costs is the launch and one pass of latency. So the design is the plain one, and
// exact where the wgmma kernels need a 64-row tile:
//  * One thread a query row, 128 rows a block, grid (query blocks, B * H). The thread holds
//    its normalised, rotated q row and its output row (D floats each) in registers.
//  * Keys come in tiles of 32: the first 32 threads load, normalise and rotate one K row
//    each, the next 32 load one V row each, into shared memory (fp32, a row padded by one
//    word so the row-per-thread writes fall in different banks); every thread of a warp
//    then reads the same word of a key row, a broadcast.
//  * Online softmax over each tile: the tile's logits in the thread's own column of shared
//    memory (not registers: a register array would need the key loops unrolled, and the
//    unrolled source took nvcc most of a minute), one rescale of the output a tile, exp in
//    fp32 (expf). Only the loops over D are unrolled, so q and o stay in registers.
//  * Ragged edges: keys past Lk get no weight, rows past Lq are not stored.
// fp32 is exact fp32 on the CUDA cores, as attention_f32.cu's 3xTF32 products are to fp32's
// accuracy.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // query rows a block, one a thread
constexpr int kBN = 32;   // keys a tile

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float load(__half x) { return __half2float(x); }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half(x));
  }
  static __device__ __forceinline__ __half store(float x) { return __float2half(x); }
};

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  const float* wq;
  const float* wk;
  const float* cq;
  const float* sq;
  const float* ck;
  const float* sk;
  int64_t s[12];  // element strides (batch, length, head) of q, k, v and o
  int heads, lq, lk;
  float eps, scale;
};

// Row `row` of a [B, L, H, D] operand of T, for batch b and head h, into fp32 registers.
template <int D, typename T>
__device__ __forceinline__ void load_row(float* x, const T* base, const int64_t* s, int b,
                                         int row, int h) {
  const T* src = base + b * s[0] + row * s[1] + h * s[2];
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = Cvt<T>::load(src[i]);
}

// x <- T(rope(x * rsqrt(mean(x^2) + eps) * w)) in fp32, held as fp32; the tables' row `row`.
template <int D, typename T>
__device__ __forceinline__ void norm_rope(float* x, const float* w, const float* cs,
                                          const float* sn, int row, float eps) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) ss += x[i] * x[i];
  const float inv = rsqrtf(ss * (1.0f / D) + eps);
  const int64_t off = static_cast<int64_t>(row) * D;
#pragma unroll
  for (int i = 0; i < D; i += 2) {
    const float y0 = x[i] * inv * w[off + i], y1 = x[i + 1] * inv * w[off + i + 1];
    x[i] = Cvt<T>::round(y0 * cs[off + i] - y1 * sn[off + i]);
    x[i + 1] = Cvt<T>::round(y1 * cs[off + i + 1] + y0 * sn[off + i + 1]);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kBM) narrow_kernel(const Params<T> p) {
  __shared__ float ks[kBN][D + 1];
  __shared__ float vs[kBN][D + 1];
  __shared__ float ls[kBN][kBM];  // each thread's logits of the tile, in its own column
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kBM + tid;
  const bool live = row < p.lq;

  float q[D], o[D];
  float m = -CUDART_INF_F, l = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) o[i] = 0.f;
  if (live) {
    load_row<D, T>(q, p.q, p.s, b, row, h);
    norm_rope<D, T>(q, p.wq, p.cq, p.sq, row, p.eps);
  }

  for (int t0 = 0; t0 < p.lk; t0 += kBN) {
    __syncthreads();  // the previous tile is consumed
    if (tid < kBN) {  // a K row: loaded, normalised, rotated
      const int j = t0 + tid;
      float x[D];
      if (j < p.lk) {
        load_row<D, T>(x, p.k, p.s + 3, b, j, h);
        norm_rope<D, T>(x, p.wk, p.ck, p.sk, j, p.eps);
      } else {
#pragma unroll
        for (int i = 0; i < D; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < D; ++i) ks[tid][i] = x[i];
    } else if (tid < 2 * kBN) {  // a V row
      const int j = t0 + tid - kBN;
      float x[D];
      if (j < p.lk) {
        load_row<D, T>(x, p.v, p.s + 6, b, j, h);
      } else {
#pragma unroll
        for (int i = 0; i < D; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < D; ++i) vs[tid - kBN][i] = x[i];
    }
    __syncthreads();
    if (!live) continue;
    const int n = min(kBN, p.lk - t0);
    float mt = m;
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) acc += q[i] * ks[j][i];
      acc *= p.scale;
      ls[j][tid] = acc;
      mt = fmaxf(mt, acc);
    }
    const float corr = m == -CUDART_INF_F ? 0.f : expf(m - mt);  // mt is finite: n >= 1
    l *= corr;
#pragma unroll
    for (int i = 0; i < D; ++i) o[i] *= corr;
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      const float pj = expf(ls[j][tid] - mt);
      l += pj;
      const float pr = Cvt<T>::round(pj);
#pragma unroll
      for (int i = 0; i < D; ++i) o[i] += pr * vs[j][i];
    }
    m = mt;
  }
  if (live) {
    T* dst = p.o + b * p.s[9] + row * p.s[10] + h * p.s[11];
    const float inv = 1.0f / l;
#pragma unroll
    for (int i = 0; i < D; ++i) dst[i] = Cvt<T>::store(o[i] * inv);
  }
}

template <typename T>
int entry(const void* q, const void* k, const void* v, void* o, const void* wq, const void* wk,
          const void* cq, const void* sq, const void* ck, const void* sk,
          const int64_t* strides, int batch, int heads, int lq, int lk, int head_dim, float eps,
          void* stream) {
  Params<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<T*>(o);
  p.wq = static_cast<const float*>(wq);
  p.wk = static_cast<const float*>(wk);
  p.cq = static_cast<const float*>(cq);
  p.sq = static_cast<const float*>(sq);
  p.ck = static_cast<const float*>(ck);
  p.sk = static_cast<const float*>(sk);
  for (int i = 0; i < 12; ++i) p.s[i] = strides[i];
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.eps = eps;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(head_dim)));  // D ** -0.5
  const dim3 grid((lq + kBM - 1) / kBM, batch * heads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 32) {
    narrow_kernel<32, T><<<grid, kBM, 0, s>>>(p);
  } else if (head_dim == 64) {
    narrow_kernel<64, T><<<grid, kBM, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries, bound with ctypes, one for each element type. Pointers are device
// pointers: q, k, v and o of the type [B, L, H, head_dim] with a unit stride on the last
// axis; the six tables fp32 [L, head_dim], contiguous. `strides` holds 12 element strides:
// (batch, length, head) for q, k, v and o, in that order. `head_dim` must be 32 or 64
// (cudaErrorInvalidValue otherwise). Launches on `stream` and returns cudaGetLastError() (0
// on success).
#define NARROW_ENTRY(suffix, T)                                                               \
  extern "C" int fused_qk_attention_narrow_##suffix(                                          \
      const void* q, const void* k, const void* v, void* o, const void* wq, const void* wk,  \
      const void* cq, const void* sq, const void* ck, const void* sk, const int64_t* strides, \
      int batch, int heads, int lq, int lk, int head_dim, float eps, void* stream) {          \
    return entry<T>(q, k, v, o, wq, wk, cq, sq, ck, sk, strides, batch, heads, lq, lk,       \
                    head_dim, eps, stream);                                                   \
  }

NARROW_ENTRY(bf16, __nv_bfloat16)
NARROW_ENTRY(f16, __half)
NARROW_ENTRY(f32, float)
