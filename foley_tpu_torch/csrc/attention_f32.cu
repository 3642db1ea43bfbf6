// Softmax attention in true fp32 for Hopper (sm_90a), on the CUDA cores: the fp32 variants of
// K2 (flash_attention_f32, head_dim 64 or 128) and of K1 (fused_qk_attention_f32, head_dim
// 128, with the qk-RMSNorm + RoPE prologue).
//
// Replaces, for fp32 operands, the Pallas kernels foley_tpu/ops/pallas/flash_attention.py:60
// (_flash_attention_bhld) and foley_tpu/ops/pallas/fused_attention.py:82
// (fused_qk_attention_headfirst). It is held to the JAX package's fp32 arithmetic at
// Precision.HIGHEST (foley_tpu/ops/attention.py::_sdpa_xla on the denoiser's path,
// foley_tpu/models/siglip2.py::_mha): every product and every sum in fp32. wgmma has no fp32
// product, and a single TF32 pass keeps about three decimal digits, so the products run as
// fp32 FMA. What it computes, per batch row b, head h and query row i:
//   o[b, i, h] = softmax_j(q'[b, i, h] . k'[b, j, h] / sqrt(D)) @ v[b, :, h]
// with q' = q and k' = k (K2), or (K1) q' = rope(rms_norm(q) * wq[i]) and k' likewise: the
// 16-bit kernel's prologue, in fp32 throughout, with no cast between the rotation and the
// product. The rotation is pair-adjacent:
//   out[2m] = x[2m] cos[2m] - x[2m+1] sin[2m],  out[2m+1] = x[2m+1] cos[2m+1] + x[2m] sin[2m+1].
//
// Bound on an NVIDIA H100 SXM (67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s, at a 700 W power
// limit): operations. SigLIP2's 5 s call (B 40 frames, L 1024, 12 heads of 64) does 128.8
// GFLOP, 1.92 ms (its bytes take 150 us); K1's 5 s joint call (B 2, L 290, 12 heads of 128)
// 1.03 GFLOP, 15.4 us. The design is the plain one that keeps the FMA units fed from shared
// memory; it is right first, and a later design may put the products on the tensor cores
// in 3xTF32, which keeps fp32's accuracy:
//  * A block takes 64 query rows of one (b, h), with 256 threads. Q stays in shared memory;
//    K and V pass through it in tiles of 64 keys. Thread (ty, tx) of a 16 x 16 grid owns the
//    query rows 4 ty .. 4 ty + 3: their logits at the keys tx + 16 j (j < 4), and their
//    output columns 4 tx + 64 m .. + 3 (m < D / 64).
//  * S = Q K^T reads four 16-byte Q chunks (one address across the half-warp) and four
//    16-byte K chunks a step of 4 columns, for 64 FMA. Rows padded by 4 floats keep the K
//    reads free of bank conflicts.
//  * The online softmax runs in registers. A row's 16 threads share a half-warp, so its max
//    and its sum reduce by shuffles. exp is expf (2 ulp), not the special-function unit's
//    approximation. p is written over the K tile once every thread is done reading it, and
//    O += P V reads p (one address across the half-warp) and V in 16-byte chunks.
//  * No asynchronous copies: 98 KB of shared memory at D 128 (50 KB at D 64) lets two blocks
//    share an SM, and one computes while the other loads.
//  * Ragged edges: rows past Lq and Lk load as zeros (a zero row stays zero through the
//    norm); keys >= Lk get -inf logits; rows >= Lq are not stored.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // query rows a block
constexpr int kBN = 64;        // keys a tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kNormD = 128;    // K1's head_dim

template <int D>
struct Cfg {
  static constexpr int kLd = D + 4;     // floats between rows of the Q and K tiles
  static constexpr int kLdP = kBN + 4;  // floats between rows of p, written over the K tile
  static constexpr int kChunks = D / 64;  // 4-column chunks of O a thread owns in a row
  static constexpr int kSmem = (2 * kBM * kLd + kBN * D) * 4;
  static_assert(kBM * kLdP <= kBN * kLd, "p must fit over the K tile");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int64_t s[12];  // element strides (batch, length, head) of q, k, v and o, in that order
  int heads, lq, lk;
  float scale;    // 1 / sqrt(D), on the fp32 logits
  // K1 only: the per-position fp32 [L, 128] norm weights and rotation tables, and the eps
  const float* wq;
  const float* wk;
  const float* cq;
  const float* sq;
  const float* ck;
  const float* sk;
  float eps;
};

__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Rows [r0, r0 + 64) of one (b, h) of a [B, L, H, D] operand (`base` at its row 0, `sl`
// elements between rows) into `dst`, LD floats between rows; rows at or past `len` as zeros.
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* base, int64_t sl, int r0,
                                          int len) {
  constexpr int kC = D / 4;
  for (int i = threadIdx.x; i < kBM * kC; i += kThreads) {
    const int r = i / kC, c = i % kC;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < len)
      x = __ldg(reinterpret_cast<const float4*>(base + static_cast<int64_t>(r0 + r) * sl) + c);
    *reinterpret_cast<float4*>(dst + r * LD + 4 * c) = x;
  }
}

// The same for K1's q and k (D 128), each row x <- rope(x * rsqrt(mean(x^2) + eps) * w) in
// fp32, w, cos and sin the row's position's table rows: warp w takes the rows w, w + 8, ...,
// lane l the columns 4 l .. 4 l + 3 (a rotation pair never straddles two lanes).
template <int LD>
__device__ __forceinline__ void load_tile_norm_rope(float* dst, const float* base, int64_t sl,
                                                    int r0, int len, const float* w,
                                                    const float* cs, const float* sn,
                                                    float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = r0 + r;
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < len) {  // the same for the whole warp
      const float4 x =
          __ldg(reinterpret_cast<const float4*>(base + static_cast<int64_t>(row) * sl) + lane);
      float ss = x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      const float inv = rsqrtf(ss * (1.0f / kNormD) + eps);
      const int64_t t = static_cast<int64_t>(row) * kNormD + 4 * lane;
      const float4 wv = __ldg(reinterpret_cast<const float4*>(w + t));
      const float4 cv = __ldg(reinterpret_cast<const float4*>(cs + t));
      const float4 sv = __ldg(reinterpret_cast<const float4*>(sn + t));
      const float y0 = x.x * inv * wv.x, y1 = x.y * inv * wv.y;
      const float y2 = x.z * inv * wv.z, y3 = x.w * inv * wv.w;
      y = make_float4(y0 * cv.x - y1 * sv.x, y1 * cv.y + y0 * sv.y, y2 * cv.z - y3 * sv.z,
                      y3 * cv.w + y2 * sv.w);
    }
    *reinterpret_cast<float4*>(dst + r * LD + 4 * lane) = y;
  }
}

template <int D, bool kNormRope>
__global__ void __launch_bounds__(kThreads, 2) attention_f32_kernel(const Params p) {
  using C = Cfg<D>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBM * C::kLd;  // the K tile, then p over it
  float* vs = ks + kBN * C::kLd;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * kBM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* qb = p.q + b * p.s[0] + h * p.s[2];
  const float* kb = p.k + b * p.s[3] + h * p.s[5];
  const float* vb = p.v + b * p.s[6] + h * p.s[8];
  if (kNormRope)
    load_tile_norm_rope<C::kLd>(qs, qb, p.s[1], q0, p.lq, p.wq, p.cq, p.sq, p.eps);
  else
    load_tile<D, C::kLd>(qs, qb, p.s[1], q0, p.lq);

  float o[4][C::kChunks][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) o[i][c][0] = o[i][c][1] = o[i][c][2] = o[i][c][3] = 0.f;
  }

  const int n_tiles = (p.lk + kBN - 1) / kBN;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBN;
    __syncthreads();  // the last tile's reads of p and V are done (at t 0: Q is in place)
    if (kNormRope)
      load_tile_norm_rope<C::kLd>(ks, kb, p.s[4], k0, p.lk, p.wk, p.ck, p.sk, p.eps);
    else
      load_tile<D, C::kLd>(ks, kb, p.s[4], k0, p.lk);
    load_tile<D, D>(vs, vb, p.s[7], k0, p.lk);
    __syncthreads();

    // S = Q K^T for rows 4 ty + i and keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * C::kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * C::kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
      }
    }

    // the online softmax: the tile's first key is < Lk, so each row's new max is finite
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < p.lk) ? s[i][j] * p.scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);  // 0 while m is -inf
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        o[i][c][0] *= alpha;
        o[i][c][1] *= alpha;
        o[i][c][2] *= alpha;
        o[i][c][3] *= alpha;
      }
    }

    __syncthreads();  // every read of the K tile is done: p goes over it
    float* ps = ks;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(4 * ty + i) * C::kLdP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // O += P V for rows 4 ty + i and columns 4 tx + 64 c .. + 3
#pragma unroll 2
    for (int j = 0; j < kBN; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * C::kLdP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + (j + jj) * D + 4 * tx + 64 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pij = part(pv[i], jj);
            o[i][c][0] = fmaf(pij, vv.x, o[i][c][0]);
            o[i][c][1] = fmaf(pij, vv.y, o[i][c][1]);
            o[i][c][2] = fmaf(pij, vv.z, o[i][c][2]);
            o[i][c][3] = fmaf(pij, vv.w, o[i][c][3]);
          }
        }
      }
    }
  }

  // each row's sum over its 16 threads, then o / l
  float* ob = p.o + b * p.s[9] + h * p.s[11];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + 4 * ty + i;
    if (row >= p.lq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      *reinterpret_cast<float4*>(ob + static_cast<int64_t>(row) * p.s[10] + 4 * tx + 64 * c) =
          make_float4(o[i][c][0] * inv, o[i][c][1] * inv, o[i][c][2] * inv, o[i][c][3] * inv);
    }
  }
}

template <int D, bool kNormRope>
int launch(const Params& p, int batch, void* stream) {
  using C = Cfg<D>;
  static bool attr_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64 || !attr_set[device]) {
    err = cudaFuncSetAttribute(attention_f32_kernel<D, kNormRope>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err == cudaSuccess)  // room for two blocks an SM
      err = cudaFuncSetAttribute(attention_f32_kernel<D, kNormRope>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) attr_set[device] = true;
  }
  const dim3 grid((p.lq + kBM - 1) / kBM, batch * p.heads);
  attention_f32_kernel<D, kNormRope>
      <<<grid, kThreads, C::kSmem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   const int64_t* strides, int heads, int lq, int lk, int head_dim) {
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  for (int i = 0; i < 12; ++i) p.s[i] = strides[i];
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.scale = 1.0f / sqrtf(static_cast<float>(head_dim));
  return p;
}

}  // namespace

// Plain C entries, bound with ctypes, with the signatures of the 16-bit kernels' entries.
// Pointers are device pointers to fp32 [B, L, H, D] data; `strides` holds 12 element
// strides: (batch, length, head) for q, k, v and o, in that order, with a unit stride on D.
// Every pointer must be 16-byte aligned and every stride a multiple of 4 (the wrappers check),
// and batch * heads at most 65535 (the grid's y extent). Each launches on `stream` and returns
// cudaGetLastError() (0 on success).

// K2 in fp32: `head_dim` 64 or 128 (cudaErrorInvalidValue otherwise).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   const int64_t* strides, int batch, int heads, int lq,
                                   int lk, int head_dim, void* stream) {
  const Params p = make_params(q, k, v, o, strides, heads, lq, lk, head_dim);
  if (head_dim == 64) return launch<64, false>(p, batch, stream);
  if (head_dim == 128) return launch<128, false>(p, batch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K1 in fp32, head_dim 128: the six tables fp32 [L, 128], contiguous and 16-byte aligned.
extern "C" int fused_qk_attention_f32(const void* q, const void* k, const void* v, void* o,
                                      const void* wq, const void* wk, const void* cq,
                                      const void* sq, const void* ck, const void* sk,
                                      const int64_t* strides, int batch, int heads, int lq,
                                      int lk, float eps, void* stream) {
  Params p = make_params(q, k, v, o, strides, heads, lq, lk, kNormD);
  p.wq = static_cast<const float*>(wq);
  p.wk = static_cast<const float*>(wk);
  p.cq = static_cast<const float*>(cq);
  p.sq = static_cast<const float*>(sq);
  p.ck = static_cast<const float*>(ck);
  p.sk = static_cast<const float*>(sk);
  p.eps = eps;
  return launch<kNormD, true>(p, batch, stream);
}
