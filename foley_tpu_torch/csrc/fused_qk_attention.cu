// Fused qk-RMSNorm + RoPE + softmax attention for Hopper (sm_90a), bf16, head_dim 128.
//
// Replaces the Pallas kernel foley_tpu/ops/pallas/fused_attention.py:82
// (fused_qk_attention_headfirst; body _kernel :57, helpers _norm_rope :50, _rot_half_lanes :39).
// What it computes, per batch row b, head h and query row i:
//   qn = rope(rms_norm(q[b, i, h]) * wq[i]),  kn = rope(rms_norm(k[b, j, h]) * wk[j])   (fp32)
//   o[b, i, h] = softmax_j(qn . kn / sqrt(D)) @ v[b, :, h]
// with the normalised/rotated q and k cast to bf16 before the products, fp32 accumulation,
// and p cast to bf16 before p @ v. The rotation is pair-adjacent:
//   out[2m] = x[2m] cos[2m] - x[2m+1] sin[2m],  out[2m+1] = x[2m+1] cos[2m+1] + x[2m] sin[2m+1].
// The weight and cos/sin tables are fp32 [L, D], one row per position, so one launch serves
// the joint [v_cond; audio] sequence whose two streams have different norm weights and tables.
//
// Bound on an H100: at the 5 s shapes (joint L = 290, single L = 250, B*H = 24) a launch
// moves q, k, v and o in bf16 plus the fp32 tables (about 8 MB at L = 290) against
// 4*B*H*L*L*D operations (about 1 GFLOP): about 130 operations per byte, below the card's
// ~295 bf16 operations per byte, so memory bound, about 2.4 us at 3.35 TB/s. The ratio grows
// with L; past L ~ 640 (the long-form windows) the tensor-core rate bounds it instead.
//
// Design. The TPU kernel keeps a head's whole K/V in VMEM; an SM has 227 KB of shared memory,
// so this kernel walks K/V in 64-row tiles with an online (running max / running sum)
// softmax. A block of 4 warps owns 64 query rows of one (b, h); each warp owns 16 rows.
//  * Prologue: the raw Q tile is loaded (16-byte loads through the [B, L, H, D] strides, no
//    transpose), RMS-normed and rotated in fp32 once, cast to bf16 and kept in registers as
//    mma.sync A fragments for the whole K/V walk.
//  * Each K tile is normed and rotated the same way as it arrives in shared memory; V is
//    used raw. The fp32 tables are read from global memory (shared by every head, they stay
//    in L2) and not staged in shared memory.
//  * S = Q K^T and O += P V run on mma.sync m16n8k16 bf16 tensor-core tiles with fp32
//    accumulators; P is re-packed from the S accumulators in registers.
//  * Ragged edges are masked in the kernel: query rows >= Lq are zero-filled and not stored,
//    keys >= Lk are zero-filled and their logits set to -inf. A row whose running max is
//    still -inf uses 0 as its exponent base, so exp(-inf - -inf) never produces NaN.
// Shared memory: two 64 x (128+8) bf16 tiles (34 KB); the Q tile reuses the V buffer.
// wgmma, TMA and a pipelined K/V ring are left for a later, faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;   // shared-memory row stride in bf16 elements (bank-conflict pad)

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* wq;
  const float* wk;
  const float* cq;
  const float* sq;
  const float* ck;
  const float* sk;
  int64_t q_sb, q_sl, q_sh;  // element strides of the batch, length and head axes
  int64_t k_sb, k_sl, k_sh;
  int64_t v_sb, v_sl, v_sh;
  int64_t o_sb, o_sl, o_sh;
  int heads, lq, lk;
  float eps;
  float scale_log2;  // log2(e) / sqrt(D)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// D = A * B + D for one m16n8k16 tile, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + 64) of one (b, h) slice into a shared tile; rows past `len` are
// zero-filled. Each thread moves 16-byte chunks (8 bf16); a row is 16 chunks.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          int64_t row_stride, int row0, int len) {
  for (int c = threadIdx.x; c < kBM * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8);
    const int col = (c % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < len) {
      val = *reinterpret_cast<const uint4*>(base + (int64_t)(row0 + r) * row_stride + col);
    }
    *reinterpret_cast<uint4*>(dst + r * kLds + col) = val;
  }
}

// In place on a shared tile: x <- bf16(rope(x * rsqrt(mean(x^2) + eps) * w)), fp32 math.
// Warp w handles rows w, w + 4, ...; lane l holds columns 4l..4l+3 (two rotation pairs).
__device__ __forceinline__ void norm_rope_tile(__nv_bfloat16* tile, const float* w,
                                               const float* cs, const float* sn, int row0,
                                               int len, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += kWarps) {
    if (row0 + r >= len) continue;  // warp-uniform: the zero rows stay zero
    __nv_bfloat16* px = tile + r * kLds + lane * 4;
    const uint2 raw = *reinterpret_cast<const uint2*>(px);
    const __nv_bfloat162 x01 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 x23 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    float x[4] = {__low2float(x01), __high2float(x01), __low2float(x23), __high2float(x23)};
    float ss = x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float inv = rsqrtf(ss * (1.0f / kD) + eps);
    const int64_t t = (int64_t)(row0 + r) * kD + lane * 4;
    const float4 wv = *reinterpret_cast<const float4*>(w + t);
    const float4 cv = *reinterpret_cast<const float4*>(cs + t);
    const float4 sv = *reinterpret_cast<const float4*>(sn + t);
    const float y0 = x[0] * inv * wv.x, y1 = x[1] * inv * wv.y;
    const float y2 = x[2] * inv * wv.z, y3 = x[3] * inv * wv.w;
    uint2 out;
    out.x = pack_bf16(y0 * cv.x - y1 * sv.x, y1 * cv.y + y0 * sv.y);
    out.y = pack_bf16(y2 * cv.z - y3 * sv.z, y3 * cv.w + y2 * sv.w);
    *reinterpret_cast<uint2*>(px) = out;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_qk_attention_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBN * kLds];
  __shared__ __align__(16) __nv_bfloat16 vs[kBN * kLds];  // holds the Q tile in the prologue

  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment coordinates
  const int wr = warp * 16;               // this warp's first row inside the tile

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;

  // ---- prologue: normalise and rotate the Q tile once, keep it as A fragments ----
  load_tile(vs, qb, p.q_sl, q0, p.lq);
  __syncthreads();
  norm_rope_tile(vs, p.wq, p.cq, p.sq, q0, p.lq, p.eps);
  __syncthreads();
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const __nv_bfloat16* r0 = vs + (wr + g) * kLds + kk * 16 + t4 * 2;
    const __nv_bfloat16* r1 = r0 + 8 * kLds;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g and g + 8, raw-logit units
  float l_run[2] = {0.f, 0.f};                      // this thread's share of the row sums

  for (int k0 = 0; k0 < p.lk; k0 += kBN) {
    __syncthreads();  // every warp is done with the previous K/V tile (or the Q tile)
    load_tile(ks, kb, p.k_sl, k0, p.lk);
    load_tile(vs, vb, p.v_sl, k0, p.lk);
    __syncthreads();
    norm_rope_tile(ks, p.wk, p.ck, p.sk, k0, p.lk, p.eps);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBN / 8][4];
#pragma unroll
    for (int nn = 0; nn < kBN / 8; ++nn) s[nn][0] = s[nn][1] = s[nn][2] = s[nn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < kBN / 8; ++nn) {
        const __nv_bfloat16* kr = ks + (nn * 8 + g) * kLds + kk * 16 + t4 * 2;
        mma_bf16(s[nn], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // mask the ragged last tile, then the online-softmax update
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nn = 0; nn < kBN / 8; ++nn) {
      const int key = k0 + nn * 8 + t4 * 2;
      if (key >= p.lk) s[nn][0] = s[nn][2] = -CUDART_INF_F;
      if (key + 1 >= p.lk) s[nn][1] = s[nn][3] = -CUDART_INF_F;
      mx[0] = fmaxf(mx[0], fmaxf(s[nn][0], s[nn][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nn][2], s[nn][3]));
    }
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      base[r] = (m_new == -CUDART_INF_F) ? 0.f : m_new * p.scale_log2;
      alpha[r] = exp2f(m_run[r] * p.scale_log2 - base[r]);  // 0 while m_run is -inf
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nn = 0; nn < kBN / 8; ++nn) {
      s[nn][0] = exp2f(s[nn][0] * p.scale_log2 - base[0]);
      s[nn][1] = exp2f(s[nn][1] * p.scale_log2 - base[0]);
      s[nn][2] = exp2f(s[nn][2] * p.scale_log2 - base[1]);
      s[nn][3] = exp2f(s[nn][3] * p.scale_log2 - base[1]);
      rs[0] += s[nn][0] + s[nn][1];
      rs[1] += s[nn][2] + s[nn][3];
    }
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
#pragma unroll
    for (int dd = 0; dd < kD / 8; ++dd) {
      acc[dd][0] *= alpha[0];
      acc[dd][1] *= alpha[0];
      acc[dd][2] *= alpha[1];
      acc[dd][3] *= alpha[1];
    }

    // O += P V: P (bf16) comes straight from the S accumulators
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const __nv_bfloat16* v0 = vs + (j * 16 + t4 * 2) * kLds + g;
#pragma unroll
      for (int dd = 0; dd < kD / 8; ++dd) {
        const __nv_bfloat16* vc = v0 + dd * 8;
        const uint32_t b0 = pack_raw(vc[0], vc[kLds]);
        const uint32_t b1 = pack_raw(vc[8 * kLds], vc[9 * kLds]);
        mma_bf16(acc[dd], pa, b0, b1);
      }
    }
  }

  // ---- epilogue: finish the row sums across the quad, scale, store bf16 ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
  }
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + r * 8;
    if (row >= p.lq) continue;
    __nv_bfloat16* orow = ob + (int64_t)row * p.o_sl + t4 * 2;
#pragma unroll
    for (int dd = 0; dd < kD / 8; ++dd) {
      *reinterpret_cast<uint32_t*>(orow + dd * 8) =
          pack_bf16(acc[dd][2 * r] * l_run[r], acc[dd][2 * r + 1] * l_run[r]);
    }
  }
}

}  // namespace

// Plain C entry, bound with ctypes. Pointers are device pointers; `strides` holds 12 element
// strides: (batch, length, head) for q, k, v and o, in that order. Every pointer must be
// 16-byte aligned and every stride a multiple of 8 (the wrapper checks). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_qk_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                       const void* wq, const void* wk, const void* cq,
                                       const void* sq, const void* ck, const void* sk,
                                       const int64_t* strides, int batch, int heads, int lq,
                                       int lk, float eps, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.wq = static_cast<const float*>(wq);
  p.wk = static_cast<const float*>(wk);
  p.cq = static_cast<const float*>(cq);
  p.sq = static_cast<const float*>(sq);
  p.ck = static_cast<const float*>(ck);
  p.sk = static_cast<const float*>(sk);
  p.q_sb = strides[0]; p.q_sl = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_sl = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_sl = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_sl = strides[10]; p.o_sh = strides[11];
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.eps = eps;
  p.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(kD));
  const dim3 grid((lq + kBM - 1) / kBM, batch * heads);
  fused_qk_attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
