// Fused qk-RMSNorm + RoPE + softmax attention for Hopper (sm_90a) at every even head width
// 2 <= D <= 256 but 128, in bf16, fp16 or fp32, on the tensor cores through mma.sync.
//
// Replaces the Pallas kernel foley_tpu/ops/pallas/fused_attention.py:82
// (fused_qk_attention_headfirst; body _kernel :57, helpers _norm_rope :50, _rot_half_lanes :39)
// at the head widths the wgmma kernels do not take: fused_qk_attention.cu and attention_f32.cu
// are built for head_dim 128 (XL, XXL). The TPU kernel takes any width (it pads only the key
// length), and a YAML config may give any hidden size and head count: TINY has 2 heads of 32,
// a 1536-wide denoiser with 24 heads has heads of 64, with 16 heads of 96. It computes what
// the TPU kernel computes, per batch row b, head h and query row i:
//   qn = rope(rms_norm(q[b, i, h]) * wq[i]),  kn = rope(rms_norm(k[b, j, h]) * wk[j])   (fp32)
//   o[b, i, h] = softmax_j(qn . kn / sqrt(D)) @ v[b, :, h]
// with the normalised, rotated q and k rounded to the input type before the products, fp32
// logits and accumulation, and p rounded to that type before p @ v. The rotation is
// pair-adjacent: out[2m] = x[2m] cos[2m] - x[2m+1] sin[2m],
// out[2m+1] = x[2m+1] cos[2m+1] + x[2m] sin[2m+1]. The weight and cos/sin tables are fp32
// [L, D], one row per position.
//
// Bound on an NVIDIA H100 SXM (989 TFLOP/s dense bf16 / fp16, 495 TF32, 3.35 TB/s, at a
// 700 W power limit): the same FLOPs as at D 128 for the same hidden width. A 30 s window's
// joint call with 24 heads of 64 (B 2, L 1740) does 4 B H L^2 D = 37.2 GFLOP: 37.6 us in
// bf16 (its 43 MB of q, k, v and o take 12.8 us), 225.5 us at three TF32 products a
// product; TINY's calls (B 2, 2 heads of 32, L 50-58) move about 70 KB and are a launch's
// latency. What the design does about it:
//  * A block takes 128 query rows of one (b, h) (64 in fp32 past D 128, where the fp32 tiles
//    leave shared memory for no more), 16 rows a warp. Every block normalises and rotates
//    every key tile itself, reading the key rows' fp32 weight, cos and sin (12 bytes a key
//    element, from L2: the tables are shared by every (b, h)); 128 rows a block halve that
//    traffic against 64, and it is what bounds a long call (at L 1740 the tables' reads
//    outweigh the products), so the rows a block are as many as the registers allow.
//  * Keys come in tiles of 64 (32 in fp32 past D 128), double-buffered: the next tile's K
//    and V rows are in flight through cp.async while this one is normalised and consumed.
//    Q and the current K tile are normalised and rotated in place in shared memory, eight
//    threads a row (the row's sum of squares reduced by shuffles), and rounded to the input
//    type; V is used as loaded.
//  * In bf16 / fp16: S = Q K^T and O += P V by mma.sync.m16n8k16 with fp32 accumulators, fed
//    by ldmatrix (V through ldmatrix.trans), the online softmax in registers between them:
//    the S accumulators are the P fragment of P V, rounded to the input type.
//  * In fp32: the same structure with 3xTF32 mma.sync.m16n8k8: each fp32 operand split into
//    hi = tf32(x) (to nearest, hopper.cuh's tf32_rna) and lo = tf32(x - hi), a.b formed as
//    a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, which keeps the JAX package's Precision.HIGHEST
//    accuracy (attention_f32.cu says why one TF32 pass would not). A tile's P V is summed
//    by the tensor cores alone, one 8-column block of O at a time, and added to O in fp32
//    registers, as attention_f32.cu does. The fp32 A fragment holds key columns t and t + 4
//    of a k-step where the S accumulator holds keys 2t and 2t + 1; the keys of each k-step
//    are relabelled (column t is key 2t, column t + 4 key 2t + 1) and V's rows read in that
//    order, so P needs no shuffle.
//  * Widths: D is padded in shared memory to DP, the next multiple of 16 (a k16 step) up to
//    128 and of 32 past it, zero-filled: zero columns stay zero through the norm (whose mean
//    is over the true D) and the rotation, add nothing to Q K^T, and give output columns that
//    are not stored. The kernel is built for the 12 such DP from 16 to 256 (past 128 a DP of
//    every 32, which keeps nvcc's time down at up to 23% padding). D = 128 goes to the wgmma
//    kernels.
//  * Build: each element type's entry alone where K1_MMA_BF16, K1_MMA_F16 or K1_MMA_F32 is
//    defined (ops/kernels/build.py builds the three parts in parallel: each part's 12
//    instantiations, fully unrolled, take nvcc far longer than the other kernels), all three
//    otherwise.
//  * Loads: rows of D elements through their strides in cp.async chunks of 16 bytes, or 8 or
//    4 where a row's bytes, strides or pointer are not multiples of 16 (the wrapper picks the
//    widest that divides them all), so widths that are not a multiple of 8 load too.
//  * Shared memory: (rows + 4 x keys) x (DP + one 16-byte pad) elements; the pad puts the
//    eight rows an ldmatrix reads (and the fp32 path's scalar fragment reads) in different
//    banks. 202,752 bytes at DP 256 in 16 bits, 199,680 in fp32.
//  * Registers: O is 16 x DP fp32 a warp, DP / 2 a thread (128 at DP 256). Past D 256 it
//    would not fit beside S and P; the wrapper refuses D > 256. In 16 bits up to DP 128 a
//    thread is held to 128 registers, so that two blocks share an SM and one block's norm
//    pass and waits overlap the other's products: on an H100 (700 W) that took the 24-head
//    L 1740 call from 577 to 388 us, with no spill (at one block an SM a tile's chain of
//    copy, norm, products and softmax runs with nothing beside it).
//  * Ragged edges: rows past Lq and Lk load as zeros (a zero row stays zero through the
//    norm); keys >= Lk get -inf logits; rows >= Lq are not stored.

#include "hopper.cuh"

namespace {

using hopper::exp2_ftz;
using hopper::smem_u32;
using hopper::tf32_rna;

constexpr int kMaxD = 256;

// The element type's loads, stores and packing of fp32 pairs.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ float zero() { return 0.f; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {  // a in the low half
    __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() { return __float2bfloat16(0.f); }
};

template <>
struct Io<__half> {
  static __device__ __forceinline__ float2 load2(const __half* p) {
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  }
  static __device__ __forceinline__ void store2(__half* p, float a, float b) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    __half2 v = __floats2half2_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __half zero() { return __float2half(0.f); }
};

// c (16 x 8 fp32) += a (16 x 16) * b (16 x 8), 16-bit operands.
template <typename T>
__device__ __forceinline__ void mma_k16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma_k16<__nv_bfloat16>(float* c, const uint32_t* a, uint32_t b0,
                                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma_k16<__half>(float* c, const uint32_t* a, uint32_t b0,
                                                uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8 fp32) += a (16 x 8 tf32) * b (8 x 8 tf32).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as tf32 hi and lo: hi = tf32(x), lo = tf32(x - hi), each to nearest.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a . b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ah, const uint32_t* al,
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// N bytes from global `src` to shared `dst`, or N zero bytes when `live` is false (src-size 0
// reads nothing).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool live) {
  const int n = live ? N : 0;
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(N), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T, int DP>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr bool kWideF32 = kF32 && DP > 128;  // fp32 tiles past D 128: half the rows
  static constexpr int kWarps = kWideF32 ? 4 : 8;
  static constexpr int kMinBlocks = (!kF32 && DP <= 128) ? 2 : 1;  // blocks an SM
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBM = 16 * kWarps;  // query rows a block
  static constexpr int kBN = kWideF32 ? 32 : 64;  // keys a tile
  static constexpr int kStride = DP + 16 / static_cast<int>(sizeof(T));  // elements a row
  static constexpr int kSmem = (kBM + 4 * kBN) * kStride * static_cast<int>(sizeof(T));
  static_assert(DP % 16 == 0 && DP <= kMaxD, "DP is a multiple of 16 up to 256");
  static_assert(kSmem <= 232448, "shared memory");
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
  int heads, lq, lk, d, vec;
  float eps, scale_log2;
};

// Rows [row0, row0 + rows) of head h of batch b of a [B, L, H, D] operand (strides s) into
// `dst` (kStride elements a row), in cp.async chunks of `vec` bytes; rows >= len as zeros.
template <class C, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* base, const int64_t* s, int b, int h,
                                          int row0, int rows, int len, int d, int vec) {
  const char* src = reinterpret_cast<const char*>(base + b * s[0] + h * s[2]);
  const int per_row = d * static_cast<int>(sizeof(T)) / vec;
  const int64_t row_bytes = s[1] * static_cast<int64_t>(sizeof(T));
  for (int i = threadIdx.x; i < rows * per_row; i += C::kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * vec;
    const bool live = row0 + r < len;
    const char* g = src + (live ? (row0 + r) * row_bytes : 0) + c;
    char* sm = reinterpret_cast<char*>(dst + r * C::kStride) + c;
    if (vec == 16) {
      cp_async<16>(sm, g, live);
    } else if (vec == 8) {
      cp_async<8>(sm, g, live);
    } else {
      cp_async<4>(sm, g, live);
    }
  }
}

// Rows [row0, row0 + rows) of `tile` <- T(rope(x * rsqrt(mean(x^2) + eps) * w)) in fp32, the
// tables' rows row0 + r; eight threads a row, each with the pairs m = sub, sub + 8, ... Rows
// >= len (zeros) are left as they are.
template <class C, int DP, typename T>
__device__ __forceinline__ void norm_rope_rows(T* tile, int rows, int row0, int len,
                                               const float* w, const float* cs,
                                               const float* sn, int d, float eps) {
  constexpr int kPairs = DP / 16;
  const int sub = threadIdx.x & 7, half = d >> 1;
  for (int r = threadIdx.x >> 3; r < rows; r += C::kThreads / 8) {
    const bool live = row0 + r < len;
    T* row = tile + r * C::kStride;
    float x[kPairs][2];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int m = sub + 8 * i;
      x[i][0] = x[i][1] = 0.f;
      if (live && m < half) {
        const float2 v = Io<T>::load2(row + 2 * m);
        x[i][0] = v.x;
        x[i][1] = v.y;
        ss += v.x * v.x + v.y * v.y;
      }
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    ss += __shfl_xor_sync(0xffffffffu, ss, 4);
    if (!live) continue;
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    const int64_t off = static_cast<int64_t>(row0 + r) * d;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int m = sub + 8 * i;
      if (m < half) {
        const float2 wv = *reinterpret_cast<const float2*>(w + off + 2 * m);
        const float2 cv = *reinterpret_cast<const float2*>(cs + off + 2 * m);
        const float2 sv = *reinterpret_cast<const float2*>(sn + off + 2 * m);
        const float y0 = x[i][0] * inv * wv.x, y1 = x[i][1] * inv * wv.y;
        Io<T>::store2(row + 2 * m, y0 * cv.x - y1 * sv.x, y1 * cv.y + y0 * sv.y);
      }
    }
  }
}

// S (16 rows of this warp x kBN keys, fp32) += Q K^T. Thread (g = lane / 4, t = lane % 4)
// holds s[n][0, 1] = row g, keys 8 n + 2 t + {0, 1}, and s[n][2, 3] the same keys of row g + 8.
template <class C, int DP, typename T>
__device__ __forceinline__ void logits16(float (*s)[4], const T* qw, const T* kt, int lane) {
#pragma unroll 2
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, qw + (lane & 15) * C::kStride + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n2 = 0; n2 < C::kBN / 16; ++n2) {
      uint32_t bb[4];
      ldsm_x4(bb, kt + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * C::kStride + kk * 16
                      + ((lane >> 3) & 1) * 8);
      mma_k16<T>(s[2 * n2], a, bb[0], bb[1]);
      mma_k16<T>(s[2 * n2 + 1], a, bb[2], bb[3]);
    }
  }
}

// The same in 3xTF32.
template <class C, int DP>
__device__ __forceinline__ void logits32(float (*s)[4], const float* qw, const float* kt,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int kk = 0; kk < DP / 8; ++kk) {
    const float* q = qw + g * C::kStride + kk * 8 + t;
    uint32_t ah[4], al[4];
    split(q[0], ah[0], al[0]);
    split(q[8 * C::kStride], ah[1], al[1]);
    split(q[4], ah[2], al[2]);
    split(q[8 * C::kStride + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < C::kBN / 8; ++n) {
      const float* k = kt + (n * 8 + g) * C::kStride + kk * 8 + t;
      mma_3xtf32(s[n], ah, al, k[0], k[4]);
    }
  }
}

// O += P V for 16-bit operands: P from the S accumulators, rounded to T.
template <class C, int DP, typename T>
__device__ __forceinline__ void accumulate16(float (*o)[4], float (*s)[4], const T* vt,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < C::kBN / 16; ++kk) {
    const uint32_t a[4] = {Io<T>::pack(s[2 * kk][0], s[2 * kk][1]),
                           Io<T>::pack(s[2 * kk][2], s[2 * kk][3]),
                           Io<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           Io<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int n2 = 0; n2 < DP / 16; ++n2) {
      uint32_t bb[4];
      ldsm_x4_trans(bb, vt + (kk * 16 + (lane & 15)) * C::kStride + n2 * 16 + (lane >> 4) * 8);
      mma_k16<T>(o[2 * n2], a, bb[0], bb[1]);
      mma_k16<T>(o[2 * n2 + 1], a, bb[2], bb[3]);
    }
  }
}

// O += P V in 3xTF32: each 8-column block of O summed over the tile by the tensor cores,
// then added in fp32. A k-step's column t is key 2 t, column t + 4 key 2 t + 1.
template <class C, int DP>
__device__ __forceinline__ void accumulate32(float (*o)[4], float (*s)[4], const float* vt,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t ph[C::kBN / 8][4], pl[C::kBN / 8][4];
#pragma unroll
  for (int kk = 0; kk < C::kBN / 8; ++kk) {
    split(s[kk][0], ph[kk][0], pl[kk][0]);  // row g, key 2 t
    split(s[kk][2], ph[kk][1], pl[kk][1]);  // row g + 8, key 2 t
    split(s[kk][1], ph[kk][2], pl[kk][2]);  // row g, key 2 t + 1
    split(s[kk][3], ph[kk][3], pl[kk][3]);  // row g + 8, key 2 t + 1
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < C::kBN / 8; ++kk) {
      const float* v = vt + (kk * 8 + 2 * t) * C::kStride + n * 8 + g;
      mma_3xtf32(part, ph[kk], pl[kk], v[0], v[C::kStride]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] += part[c];
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<T, DP>::kThreads, Cfg<T, DP>::kMinBlocks)
attention_kernel(const Params<T> p) {
  using C = Cfg<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + C::kBM * C::kStride;      // two stages of K
  T* vs = ks + 2 * C::kBN * C::kStride;  // two stages of V
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * C::kBM;
  const int d = p.d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (d < DP) {  // the padded columns [d, DP) of every row: zero once, the loads skip them
    const int pad = DP - d;
    for (int i = threadIdx.x; i < (C::kBM + 4 * C::kBN) * pad; i += C::kThreads)
      qs[(i / pad) * C::kStride + d + i % pad] = Io<T>::zero();
  }
  load_rows<C>(qs, p.q, p.s, b, h, q0, C::kBM, p.lq, d, p.vec);
  load_rows<C>(ks, p.k, p.s + 3, b, h, 0, C::kBN, p.lk, d, p.vec);
  load_rows<C>(vs, p.v, p.s + 6, b, h, 0, C::kBN, p.lk, d, p.vec);
  cp_async_commit();

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const int tiles = (p.lk + C::kBN - 1) / C::kBN;
  const T* qw = qs + warp * 16 * C::kStride;
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < tiles) {
      const int nxt = (cur ^ 1) * C::kBN * C::kStride;
      load_rows<C>(ks + nxt, p.k, p.s + 3, b, h, (t + 1) * C::kBN, C::kBN, p.lk, d, p.vec);
      load_rows<C>(vs + nxt, p.v, p.s + 6, b, h, (t + 1) * C::kBN, C::kBN, p.lk, d, p.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and at t = 0 Q) has landed
    T* kt = ks + cur * C::kBN * C::kStride;
    const T* vt = vs + cur * C::kBN * C::kStride;
    if (t == 0) norm_rope_rows<C, DP>(qs, C::kBM, q0, p.lq, p.wq, p.cq, p.sq, d, p.eps);
    norm_rope_rows<C, DP>(kt, C::kBN, t * C::kBN, p.lk, p.wk, p.ck, p.sk, d, p.eps);
    __syncthreads();  // Q and this K tile are normalised

    float s[C::kBN / 8][4];
#pragma unroll
    for (int n = 0; n < C::kBN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (C::kF32) {
      logits32<C, DP>(s, qw, kt, lane);
    } else {
      logits16<C, DP>(s, qw, kt, lane);
    }

    // online softmax in the log2 domain: rows g (c = 0, 1) and g + 8 (c = 2, 3)
    const int key0 = t * C::kBN + 2 * (lane & 3);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < C::kBN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = key0 + 8 * n + (c & 1) < p.lk ? s[n][c] * p.scale_log2 : -CUDART_INF_F;
        s[n][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the row's four threads share its max
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2_ftz(m[r] - mx[r]);  // 0 while m is -inf; mx is finite (key0 < lk)
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < C::kBN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = exp2_ftz(s[n][c] - mx[c >> 1]);
        sum[c >> 1] += s[n][c];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    if constexpr (C::kF32) {
      accumulate32<C, DP>(o, s, vt, lane);
    } else {
      accumulate16<C, DP>(o, s, vt, lane);
    }
    __syncthreads();  // this stage is consumed before the next iteration refills it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.0f / l[r];
  }
  const int row = q0 + warp * 16 + (lane >> 2);
  T* out = p.o + b * p.s[9] + h * p.s[11];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * (lane & 3);
    if (col < d) {
      if (row < p.lq) Io<T>::store2(out + row * p.s[10] + col, o[n][0] * l[0], o[n][1] * l[0]);
      if (row + 8 < p.lq)
        Io<T>::store2(out + (row + 8) * p.s[10] + col, o[n][2] * l[1], o[n][3] * l[1]);
    }
  }
}

template <typename T, int DP>
int launch(const Params<T>& p, int batch, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  static bool attr_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64 || !attr_set[device]) {
    err = cudaFuncSetAttribute(attention_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) attr_set[device] = true;
  }
  const dim3 grid((p.lq + C::kBM - 1) / C::kBM, batch * p.heads);
  attention_kernel<T, DP><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int entry(const void* q, const void* k, const void* v, void* o, const void* wq, const void* wk,
          const void* cq, const void* sq, const void* ck, const void* sk,
          const int64_t* strides, int batch, int heads, int lq, int lk, int head_dim, int vec,
          float eps, void* stream) {
  if (head_dim < 2 || head_dim > kMaxD || head_dim % 2 || batch < 1 || heads < 1 || lq < 1
      || lk < 1 || batch * heads > 65535 || (vec != 4 && vec != 8 && vec != 16)
      || (head_dim * static_cast<int>(sizeof(T))) % vec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  p.d = head_dim;
  p.vec = vec;
  p.eps = eps;
  p.scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(head_dim)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((head_dim + 15) / 16) {
    case 1: return launch<T, 16>(p, batch, s);
    case 2: return launch<T, 32>(p, batch, s);
    case 3: return launch<T, 48>(p, batch, s);
    case 4: return launch<T, 64>(p, batch, s);
    case 5: return launch<T, 80>(p, batch, s);
    case 6: return launch<T, 96>(p, batch, s);
    case 7: return launch<T, 112>(p, batch, s);
    case 8: return launch<T, 128>(p, batch, s);
    case 9:
    case 10: return launch<T, 160>(p, batch, s);
    case 11:
    case 12: return launch<T, 192>(p, batch, s);
    case 13:
    case 14: return launch<T, 224>(p, batch, s);
    default: return launch<T, 256>(p, batch, s);
  }
}

}  // namespace

// Plain C entries, bound with ctypes, one for each element type. Pointers are device
// pointers: q, k, v and o of the type [B, L, H, head_dim] with a unit stride on the last
// axis; the six tables fp32 [L, head_dim], contiguous, 8-byte aligned. `strides` holds 12
// element strides: (batch, length, head) for q, k, v and o, in that order. `head_dim` is even,
// 2 to 256 (the wrapper sends 128 to the wgmma kernels); `vec` (4, 8 or 16) divides a row's
// bytes, every q / k / v stride in bytes and their pointers; o's rows and pointer are 4-byte
// (16-bit) or 8-byte (fp32) aligned; batch * heads at most 65535. cudaErrorInvalidValue
// otherwise. Launches on `stream` and returns cudaGetLastError() (0 on success).
#define MMA_ENTRY(suffix, T)                                                                   \
  extern "C" int fused_qk_attention_mma_##suffix(                                              \
      const void* q, const void* k, const void* v, void* o, const void* wq, const void* wk,   \
      const void* cq, const void* sq, const void* ck, const void* sk, const int64_t* strides,  \
      int batch, int heads, int lq, int lk, int head_dim, int vec, float eps, void* stream) {  \
    return entry<T>(q, k, v, o, wq, wk, cq, sq, ck, sk, strides, batch, heads, lq, lk,        \
                    head_dim, vec, eps, stream);                                               \
  }

#if !defined(K1_MMA_BF16) && !defined(K1_MMA_F16) && !defined(K1_MMA_F32)
#define K1_MMA_BF16
#define K1_MMA_F16
#define K1_MMA_F32
#endif
#ifdef K1_MMA_BF16
MMA_ENTRY(bf16, __nv_bfloat16)
#endif
#ifdef K1_MMA_F16
MMA_ENTRY(f16, __half)
#endif
#ifdef K1_MMA_F32
MMA_ENTRY(f32, float)
#endif
