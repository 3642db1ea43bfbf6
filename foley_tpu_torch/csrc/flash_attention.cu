// Unmasked softmax attention (flash attention) for Hopper (sm_90a), bf16, head_dim 64 or 128.
//
// Replaces the Pallas kernel foley_tpu/ops/pallas/flash_attention.py:60
// (_flash_attention_bhld; body _attn_kernel :34, entry flash_attention :96).
// What it computes, per batch row b, head h and query row i:
//   o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h] * (1 / sqrt(D))) @ v[b, :, h]
// with bf16 operands, fp32 products and logits (the scale multiplies the fp32 logits),
// an fp32 softmax, p cast to bf16 before p @ v, fp32 accumulation and a bf16 output.
// Lq and Lk may differ.
//
// Bound on an H100, at SigLIP2's 5 s call (B 40 frames, L 1024, 12 heads of 64): a launch
// does 4*B*H*L*L*D = 128.8 GFLOP of products against 251.7 MB of q, k, v and o in bf16,
// 512 operations per byte, above the card's ~295: bound by the tensor cores, about 130 us at
// 989 TFLOP/s (75 us for its bytes). So the design keeps the logits and p out of device
// memory and reads q, k, v once per query tile, and spends its effort on feeding mma.
//
// Design. The TPU kernel holds a head's whole padded K/V in VMEM and does one full-row
// softmax; at L 1024, D 64 that is 256 KB of bf16, more than an SM's 227 KB beside a Q tile.
// This kernel walks K/V in 64-key tiles with an online (running max / running sum) softmax.
// A block of 4 warps owns 64 query rows of one (b, h); each warp owns 16 rows.
//  * q, k, v and o are read and written through their [B, L, H, D] strides (16-byte rows),
//    so the three projections' reshaped views are used as they are: no transpose, no pad.
//  * K/V tiles are double-buffered in shared memory with cp.async: the next tile's copy is
//    in flight while the current one is computed. Rows past Lk are zero-filled by the copy.
//  * The Q tile is copied once and kept in registers as mma.sync A fragments.
//  * S = Q K^T and O += P V run on mma.sync m16n8k16 bf16 tiles with fp32 accumulators;
//    P is re-packed from the S accumulators in registers; V's B fragments come from
//    ldmatrix.trans.
//  * Ragged edges are masked in the kernel: query rows >= Lq are zero-filled and not stored,
//    keys >= Lk get -inf logits. A row whose running max is still -inf uses 0 as its
//    exponent base, so exp(-inf - -inf) never produces NaN.
// Shared memory: two stages of a K and a V tile of 64 x (D+8) bf16 (36,864 bytes at D 64,
// 69,632 at D 128, dynamic); the Q tile is staged in the second stage's K buffer.
// wgmma, TMA and a deeper K/V ring are left for a later, faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int64_t q_sb, q_sl, q_sh;  // element strides of the batch, length and head axes
  int64_t k_sb, k_sl, k_sh;
  int64_t v_sb, v_sl, v_sh;
  int64_t o_sb, o_sl, o_sh;
  int heads, lq, lk;
  float scale_log2;  // log2(e) / sqrt(D)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// D = A * B + D for one m16n8k16 tile, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four transposed 8x8 bf16 matrices from shared memory; lane l gives the address of row
// (l % 8) of matrix (l / 8).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16-byte asynchronous copy global -> shared; `bytes` 0 zero-fills the destination.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + 64) of one (b, h) slice into a shared tile with row
// stride D + 8; rows past `len` are zero-filled (their source address stays in bounds).
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                                int64_t row_stride, int row0, int len) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBM * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool valid = row0 + r < len;
    const __nv_bfloat16* src = base + (valid ? (int64_t)(row0 + r) * row_stride + col : 0);
    cp_async_16(smem_addr(dst + r * (D + 8) + col), src, valid ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  constexpr int kLds = D + 8;          // shared row stride in bf16 elements (bank-conflict pad)
  constexpr int kTile = kBN * kLds;    // elements of one K or V tile
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  // stage s: K at smem + 2*s*kTile, V at smem + (2*s + 1)*kTile

  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment coordinates
  const int wr = warp * 16;               // this warp's first row inside the tile

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const int n_tiles = (p.lk + kBN - 1) / kBN;

  // ---- prologue: Q tile into stage 1's K buffer, K/V tile 0 into stage 0 ----
  __nv_bfloat16* qs = smem + 2 * kTile;
  load_tile_async<D>(qs, qb, p.q_sl, q0, p.lq);
  load_tile_async<D>(smem, kb, p.k_sl, 0, p.lk);
  load_tile_async<D>(smem + kTile, vb, p.v_sl, 0, p.lk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* r0 = qs + (wr + g) * kLds + kk * 16 + t4 * 2;
    const __nv_bfloat16* r1 = r0 + 8 * kLds;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }
  __syncthreads();  // stage 1 is free for tile 1

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g and g + 8, raw-logit units
  float l_run[2] = {0.f, 0.f};                      // this thread's share of the row sums

  // ldmatrix.trans row address of this lane inside a 16-key x 16-column V block
  const int v_row = (lane / 8 % 2) * 8 + lane % 8;
  const int v_col = (lane / 16) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {  // prefetch tile t + 1 into the other stage
      __nv_bfloat16* nk = smem + 2 * ((t + 1) % 2) * kTile;
      load_tile_async<D>(nk, kb, p.k_sl, (t + 1) * kBN, p.lk);
      load_tile_async<D>(nk + kTile, vb, p.v_sl, (t + 1) * kBN, p.lk);
      cp_async_commit();
      cp_async_wait<1>();  // tile t has landed; t + 1 may still be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = smem + 2 * (t % 2) * kTile;
    const __nv_bfloat16* vs = ks + kTile;
    const int k0 = t * kBN;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBN / 8][4];
#pragma unroll
    for (int nn = 0; nn < kBN / 8; ++nn) s[nn][0] = s[nn][1] = s[nn][2] = s[nn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
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
    for (int dd = 0; dd < D / 8; ++dd) {
      acc[dd][0] *= alpha[0];
      acc[dd][1] *= alpha[0];
      acc[dd][2] *= alpha[1];
      acc[dd][3] *= alpha[1];
    }

    // O += P V: P (bf16) comes straight from the S accumulators; V through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const uint32_t vaddr = smem_addr(vs + (j * 16 + v_row) * kLds + v_col);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, vaddr + dp * 16 * sizeof(__nv_bfloat16));
        mma_bf16(acc[2 * dp], pa, vb4[0], vb4[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb4[2], vb4[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
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
    for (int dd = 0; dd < D / 8; ++dd) {
      *reinterpret_cast<uint32_t*>(orow + dd * 8) =
          pack_bf16(acc[dd][2 * r] * l_run[r], acc[dd][2 * r + 1] * l_run[r]);
    }
  }
}

template <int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int kSmem = 4 * kBN * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.lq + kBM - 1) / kBM, batch * p.heads);
  flash_attention_kernel<D><<<grid, kThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry, bound with ctypes. Pointers are device pointers to bf16 [B, L, H, D] data;
// `strides` holds 12 element strides: (batch, length, head) for q, k, v and o, in that order,
// with a unit stride on D. Every pointer must be 16-byte aligned and every stride a multiple
// of 8 (the wrapper checks). `head_dim` must be 64 or 128 (cudaErrorInvalidValue otherwise).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    const int64_t* strides, int batch, int heads, int lq,
                                    int lk, int head_dim, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_sb = strides[0]; p.q_sl = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_sl = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_sl = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_sl = strides[10]; p.o_sh = strides[11];
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(head_dim));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(p, batch, s);
  if (head_dim == 128) return launch<128>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
