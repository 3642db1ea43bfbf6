// Softmax attention in fp32 for Hopper (sm_90a), with both products on the tensor cores in
// 3xTF32: the fp32 variants of K2 (flash_attention_f32, head_dim 64 or 128) and of K1
// (fused_qk_attention_f32, head_dim 128, with the qk-RMSNorm + RoPE prologue).
//
// Replaces, for fp32 operands, the Pallas kernels foley_tpu/ops/pallas/flash_attention.py:60
// (_flash_attention_bhld) and foley_tpu/ops/pallas/fused_attention.py:82
// (fused_qk_attention_headfirst). It is held to the JAX package's fp32 arithmetic at
// Precision.HIGHEST (foley_tpu/ops/attention.py::_sdpa_xla on the denoiser's path,
// foley_tpu/models/siglip2.py::_mha). What it computes, per batch row b, head h and query
// row i:
//   o[b, i, h] = softmax_j(q'[b, i, h] . k'[b, j, h] / sqrt(D)) @ v[b, :, h]
// with q' = q and k' = k (K2), or (K1) q' = rope(rms_norm(q) * wq[i]) and k' likewise: the
// 16-bit kernel's prologue, in fp32 throughout, with no cast between the rotation and the
// product. The rotation is pair-adjacent:
//   out[2m] = x[2m] cos[2m] - x[2m+1] sin[2m],  out[2m+1] = x[2m+1] cos[2m+1] + x[2m] sin[2m+1].
//
// Why 3xTF32. wgmma has no fp32 product, and one TF32 pass keeps 11 bits of each operand: a
// relative L2 error of 3-4e-4 against fp32, far outside the 1e-5 the fp32 path is held to.
// Each fp32 operand x is split into hi = tf32(x), rounded to nearest (hopper.cuh, tf32_rna:
// not the tensor cores' truncation, which would leave a biased remainder), and
// lo = tf32(x - hi), and
//   a . b ~ a_lo . b_hi + a_hi . b_lo + a_hi . b_hi,
// the small terms issued first. Only a_lo . b_lo (2^-22 of the product) and lo's own rounding
// (2^-23) are dropped: fp32's accuracy at three tensor-core products, 3 x 495 = 165 TFLOP/s
// of fp32 work against 67 on the CUDA cores. The tensor cores' own accumulation is coarser
// than fp32's: summed by them over a whole row of keys, P V read 1.1-1.3e-5 from the fp32
// version at L 1500-1740 on an H100. So each tile's P V is summed by the tensor cores alone
// and added to the output in fp32 registers: 1-2e-6 at every length.
//
// Bound on an NVIDIA H100 SXM (495 TFLOP/s dense TF32, 3.35 TB/s, at a 700 W power limit):
// operations, 3 x 4 B H Lq Lk D / 495e12. SigLIP2's 5 s call (B 40 frames, L 1024, 12 heads
// of 64) does 128.8 GFLOP: 780.9 us (its bytes 150 us); K1's 30 s joint call (B 2, L 1740,
// 12 heads of 128) 37.2 GFLOP: 225.5 us; K1's 5 s joint call (L 290) 1.03 GFLOP: 6.3 us,
// where its 14.3 MB of bytes take 4.3 us. The design:
//  * A block takes 64 query rows of one (b, h) a consumer warpgroup (one at D 128, two at
//    D 64), which issue every wgmma and run the online softmax, and two warpgroups of
//    converter warps that feed them. Every tile must pass through registers to be split, so
//    the converters load q, k and v straight from global memory in 16-byte loads and write
//    the hi and lo tiles in the 128-byte swizzle wgmma reads; there is no TMA, whose raw
//    staging ring the shared-memory budget has no room for. K1's norm + RoPE runs on the
//    converters too, on the fp32 values before the split. The converters, not the products,
//    set the pace (on an H100 at L 1740 they take 565 us alone, the products 500 us), so
//    they hold the next K and V tiles in registers, issue the next K tile's loads before
//    they write this V tile, and are eight warps, each with a share of every tile.
//  * wgmma takes tf32 operands K-major only (PTX allows the transpose bits for 16-bit types
//    alone), so V cannot be read MN-major as the 16-bit kernels read it: the converters
//    write V^T (rows of D, keys contiguous), transposing 4 x 4 blocks in registers. The
//    other option, O^T = V^T P^T with V^T as the A operand from registers and P written to
//    shared memory, would add a P round trip through shared memory and a barrier a tile;
//    this one keeps P in registers. P goes straight from the softmax into A fragments
//    (split in registers); the tf32 A fragment holds columns t and t + 4 of a k-step where
//    the accumulator holds keys 2t and 2t + 1, so V^T stores each group of 8 keys in the
//    order 0 2 4 6 1 3 5 7 and the two agree without a shuffle.
//  * S = Q K^T: 3 wgmma a k-step of 8 (Q and K hi / lo both in shared memory);
//    O += P V: 3 wgmma a k-step of 8 keys (P hi / lo from registers, V^T hi / lo in shared
//    memory). The loop is the 16-bit kernels' (hopper.cuh, attention_consumer): S of the next
//    tile and P V of this one are in flight while this tile's softmax runs; exp2 is
//    ex2.approx on log2(e)-scaled logits (2 ulp).
//  * The budget decides the tiles. A hi + lo tile of 64 rows x D fp32 is 512 D bytes: Q
//    takes 64 KB at D 128 (64 KB for 128 rows at D 64), a stage of K and V^T 64 KB with
//    tiles of 32 keys at D 128 (64 keys at D 64). Q and two stages: 192 KB, one block an SM.
//    K and V^T are released separately (K once S is done, V^T once P V is), so two stages
//    let the converters write a tile while the products of the one before run. Registers:
//    setmaxnreg gives a consumer thread 232 at D 128 (176 at D 64: half the output columns)
//    for its output, its tile's P V and P's hi and lo, and the converters the rest.
//  * Ragged edges: rows past Lq and Lk load as zeros (a zero row stays zero through the
//    norm); keys >= Lk get -inf logits; rows >= Lq are not stored.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kConvWarps = 8;    // converter warps: two warpgroups
constexpr int kNormD = 128;      // K1's head_dim
constexpr int kStages = 2;       // K and V^T stages

template <int D>
struct Cfg {
  // consumer warpgroups of 64 query rows: two at D 64, one at D 128 (Q's hi and lo tiles of
  // 128 rows would take 128 KB there)
  static constexpr int kGroups = D == 64 ? 2 : 1;
  static constexpr int kBM = 64 * kGroups;      // query rows a block
  static constexpr int kBN = 4096 / D;          // keys a tile: 32 at D 128, 64 at D 64
  static constexpr int kThreads = 128 * kGroups + 32 * kConvWarps;
  // registers a thread: the block holds kThreads x (65,536 / kThreads); setmaxnreg gives the
  // consumer warpgroups what their accumulators need and leaves the converters the rest
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kConsumerRegs = D == 64 ? 176 : 232;
  static constexpr int kConvRegs =
      (kThreads * kLaunchRegs - 128 * kGroups * kConsumerRegs) / (32 * kConvWarps) / 8 * 8;
  static_assert(128 * kGroups * kConsumerRegs + 32 * kConvWarps * kConvRegs <=
                    kThreads * kLaunchRegs, "setmaxnreg moves registers only inside the block");
  static constexpr int kQBytes = kBM * D * 4;   // Q's hi tile (its lo tile follows)
  static constexpr int kTile = kBN * D * 4;     // one of K hi, K lo, V^T hi, V^T lo
  static constexpr int kStageBytes = 4 * kTile;
  static constexpr int kBarOffset = 2 * kQBytes + kStages * kStageBytes;
  static constexpr int kSmem = kBarOffset + (1 + 4 * kStages) * 8 + 1024;  // + alignment
  static_assert(kBM % kBN == 0, "Q is converted in passes of a K tile's rows");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int64_t s[12];  // element strides (batch, length, head) of q, k, v and o, in that order
  int heads, lq, lk;
  float scale_log2;  // log2(e) / sqrt(D), on the fp32 logits
  // K1 only: the per-position fp32 [L, 128] norm weights and rotation tables, and the eps
  const float* wq;
  const float* wk;
  const float* cq;
  const float* sq;
  const float* ck;
  const float* sk;
  float eps;
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// x split into tf32 hi and lo, written to shared memory at `hi` and `lo`: x ~ hi + lo.
__device__ __forceinline__ void store_split(uint32_t hi, uint32_t lo, const float4& x) {
  uint32_t h[4], l[4];
  const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = tf32_rna(v[i]);
    l[i] = tf32_rna(v[i] - __uint_as_float(h[i]));
  }
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi), "r"(h[0]), "r"(h[1]),
               "r"(h[2]), "r"(h[3])
               : "memory");
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo), "r"(l[0]), "r"(l[1]),
               "r"(l[2]), "r"(l[3])
               : "memory");
}

// R rows of a [B, L, H, D] operand (Q, or a K tile) as a converter thread holds them: slot i
// is the row (W i + warp) * (32 / C) + lane / C of the R (W converter warps), columns
// 4 (lane % C) .. + 3 (C = D / 4 chunks of 16 bytes a row), so a row's chunks lie in
// neighbouring lanes. With NORM (K1, D 128) it also holds the rows' weight, cos and sin.
template <int D, int R, bool NORM>
struct RowTile {
  static constexpr int kC = D / 4;
  static constexpr int kRowsPerWarp = 32 / kC;  // rows one warp instruction covers
  static constexpr int kSlots = R * kC / (32 * kConvWarps);
  static_assert(kSlots >= 1 && R * kC % (32 * kConvWarps) == 0, "whole rows a warp");
  static_assert(!NORM || D == kNormD, "the norm + RoPE prologue is K1's, at D 128");
  float4 x[kSlots];
  float4 w[NORM ? kSlots : 1], c[NORM ? kSlots : 1], s[NORM ? kSlots : 1];

  static __device__ __forceinline__ int row(int i, int warp, int lane) {
    return (kConvWarps * i + warp) * kRowsPerWarp + lane / kC;
  }

  // Rows r0 .. r0 + R - 1 of the (b, h) at `base` (`sl` elements between rows); rows at or
  // past `len` as zeros. Tables: fp32 [L, D], contiguous.
  __device__ __forceinline__ void load(const float* base, int64_t sl, int r0, int len,
                                       const float* wt, const float* ct, const float* st,
                                       int warp, int lane) {
    const int col = 4 * (lane % kC);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = r0 + row(i, warp, lane);
      x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (NORM) w[i] = c[i] = s[i] = x[i];
      if (r < len) {
        x[i] = ldg4(base + static_cast<int64_t>(r) * sl + col);
        if (NORM) {
          const int64_t t = static_cast<int64_t>(r) * D + col;
          w[i] = ldg4(wt + t);
          c[i] = ldg4(ct + t);
          s[i] = ldg4(st + t);
        }
      }
    }
  }

  // Writes the rows, normalised and rotated with NORM, as tf32 hi and lo into the swizzled
  // tiles at shared addresses `hi` and `lo` of `rows` rows (slab of 32 columns j at
  // j * rows * 128 bytes, row r at r * 128 inside it, chunk c at (c ^ r % 8) * 16), from row
  // `row0` of the tile on.
  __device__ __forceinline__ void store(uint32_t hi, uint32_t lo, int rows, int row0, float eps,
                                        int warp, int lane) const {
    const int chunk = lane % kC;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      float4 y = x[i];
      if (NORM) {
        float ss = y.x * y.x + y.y * y.y + y.z * y.z + y.w * y.w;
#pragma unroll
        for (int off = kC / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
        const float inv = rsqrtf(ss * (1.0f / D) + eps);
        const float y0 = y.x * inv * w[i].x, y1 = y.y * inv * w[i].y;
        const float y2 = y.z * inv * w[i].z, y3 = y.w * inv * w[i].w;
        y = make_float4(y0 * c[i].x - y1 * s[i].x, y1 * c[i].y + y0 * s[i].y,
                        y2 * c[i].z - y3 * s[i].z, y3 * c[i].w + y2 * s[i].w);
      }
      const int r = row0 + row(i, warp, lane);
      const uint32_t off = (chunk / 8) * rows * 128 + r * 128 + (((chunk % 8) ^ (r & 7)) << 4);
      store_split(hi + off, lo + off, y);
    }
  }
};

// A tile of BN keys of V as a converter thread holds it, to be written transposed (V^T: D rows
// of BN keys, K-major for O += P V). Unit u = thread + 32 W j (W converter warps) covers keys
// g8 + half + {0, 2, 4, 6} (g8 = 32 (u / 2D) + 8 ((u % 8) / 2), half = u % 2) and columns
// 4m .. 4m + 3 (m = (u / 8) % (D / 4)): one 16-byte chunk of each of four V^T rows, as the
// key order 0 2 4 6 1 3 5 7 of every group of 8 puts them. Eight neighbouring lanes write the
// eight chunks of one row.
template <int D, int BN>
struct VTile {
  static constexpr int kUnits = BN * D / 16;
  static constexpr int kPer = kUnits / (32 * kConvWarps);
  static_assert(kPer >= 1 && kUnits % (32 * kConvWarps) == 0 && BN % 32 == 0,
                "whole units a thread, whole slabs");
  float4 x[kPer][4];

  __device__ __forceinline__ void load(const float* base, int64_t sl, int k0, int len, int tid) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int u = tid + 32 * kConvWarps * j, gh = u % 8, m = (u / 8) % (D / 4);
      const int key0 = k0 + 32 * (u / (2 * D)) + 8 * (gh / 2) + gh % 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 2 * e;
        x[j][e] = key < len ? ldg4(base + static_cast<int64_t>(key) * sl + 4 * m)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }

  // Into the swizzled V^T tiles at shared addresses `hi` and `lo` (slab of 32 keys j at
  // j * D * 128 bytes).
  __device__ __forceinline__ void store(uint32_t hi, uint32_t lo, int tid) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int u = tid + 32 * kConvWarps * j, gh = u % 8, m = (u / 8) % (D / 4);
      const uint32_t slab = (u / (2 * D)) * D * 128;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * m + i;
        const uint32_t off = slab + d * 128 + ((gh ^ (d & 7)) << 4);
        store_split(hi + off, lo + off, make_float4(comp(x[j][0], i), comp(x[j][1], i),
                                                    comp(x[j][2], i), comp(x[j][3], i)));
      }
    }
  }
};

// p (the 64 x BN softmax block, accumulator layout) as tf32 A fragments, hi and lo, one a
// k-step of 8 keys: the accumulator's n8 block kk holds keys 2t and 2t + 1 of rows r and
// r + 8 (t = thread % 4), which the fragment takes as columns t and t + 4 (V^T's key order).
template <int BN>
__device__ __forceinline__ void split_p(const float* s, uint32_t (*ph)[4], uint32_t (*pl)[4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    const float v[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ph[kk][i] = tf32_rna(v[i]);
      pl[kk][i] = tf32_rna(v[i] - __uint_as_float(ph[kk][i]));
    }
  }
}

// The consumer warpgroup's main loop, hopper.cuh's attention_consumer in 3xTF32 for one
// warpgroup: Q hi / lo at `qs`, the K / V^T stages in `ring` (stage s: K hi, K lo, V^T hi,
// V^T lo, kTile bytes each). Waits on kfull / vfull, arrives on kempty once S of a tile is
// done and on vempty once its P V is. Each tile's P V is summed by the tensor cores into
// `acc` alone and added to o in fp32 (the tensor cores' own accumulation over a whole row of
// keys reads 1.1-1.3e-5 at L 1500-1740; per tile, 2e-6). Returns o (D / 2 registers,
// unnormalised) and l.
template <int D>
__device__ __forceinline__ void consume(uint32_t qs, uint32_t ring, uint64_t* kfull,
                                        uint64_t* vfull, uint64_t* kempty, uint64_t* vempty,
                                        int lk, float scale_log2, float* o, float* l) {
  using C = Cfg<D>;
  constexpr int kBN = C::kBN;
  const int n_tiles = (lk + kBN - 1) / kBN;
  float s[kBN / 2], acc[D / 2];
  uint32_t ph[kBN / 8][4], pl[kBN / 8][4];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float alpha[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
  l[0] = l[1] = 0.f;

  // descriptors as a base plus a byte offset / 16 at each use (the address is the field's
  // low bits), the base made opaque a tile, so the compiler keeps two registers, not one
  // descriptor a k-step, live across the loop
  const uint64_t dq0 = desc_sw128(qs, 16, 1024), dr0 = desc_sw128(ring, 16, 1024);
  auto issue_s = [&](int t) {  // S = Q K_t^T: D / 8 k-steps of lo.hi, hi.lo, hi.hi
    const int st = t % kStages;
    uint64_t dq = dq0, dk = dr0 + ((st * C::kStageBytes) >> 4);
    asm volatile("" : "+l"(dq), "+l"(dk));
    mbar_wait(&kfull[st], (t / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t qo = ((kk / 4) * C::kBM * 128 + (kk % 4) * 32) >> 4;  // slab kk / 4
      const uint32_t ko = ((kk / 4) * kBN * 128 + (kk % 4) * 32) >> 4;
      constexpr uint32_t kQLo = C::kQBytes >> 4, kKLo = C::kTile >> 4;
      wgmma_ss_tf32<kBN>(s, dq + kQLo + qo, dk + ko, kk > 0);
      wgmma_ss_tf32<kBN>(s, dq + qo, dk + kKLo + ko, 1);
      wgmma_ss_tf32<kBN>(s, dq + qo, dk + ko, 1);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int t) {  // acc = P V_t: BN / 8 k-steps of lo.hi, hi.lo, hi.hi
    const int st = t % kStages;
    uint64_t dv = dr0 + ((st * C::kStageBytes + 2 * C::kTile) >> 4);
    asm volatile("" : "+l"(dv));
    mbar_wait(&vfull[st], (t / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 8; ++kk) {
      const uint32_t vo = ((kk / 4) * D * 128 + (kk % 4) * 32) >> 4;
      constexpr uint32_t kVLo = C::kTile >> 4;
      wgmma_rs_tf32<D>(acc, pl[kk], dv + vo, kk > 0);
      wgmma_rs_tf32<D>(acc, ph[kk], dv + kVLo + vo, 1);
      wgmma_rs_tf32<D>(acc, ph[kk], dv + vo, 1);
    }
    wgmma_commit();
  };
  auto s_done = [&] {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) fence_regs(s[i]);
  };
  auto pv_done = [&] {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_regs(acc[i]);
  };

  issue_s(0);
  wgmma_wait<0>();
  s_done();
  mbar_arrive(&kempty[0]);
  softmax_update<kBN>(s, m, l, alpha, lk, scale_log2);
  split_p<kBN>(s, ph, pl);
  for (int t = 1; t < n_tiles; ++t) {
    issue_s(t);
    issue_pv(t - 1);
    wgmma_wait<1>();  // S of tile t is done; P V of tile t - 1 may still run
    s_done();
    mbar_arrive(&kempty[t % kStages]);
    softmax_update<kBN>(s, m, l, alpha, lk - t * kBN, scale_log2);
    wgmma_wait<0>();
    pv_done();
    mbar_arrive(&vempty[(t - 1) % kStages]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] = (o[4 * j] + acc[4 * j]) * alpha[0];
      o[4 * j + 1] = (o[4 * j + 1] + acc[4 * j + 1]) * alpha[0];
      o[4 * j + 2] = (o[4 * j + 2] + acc[4 * j + 2]) * alpha[1];
      o[4 * j + 3] = (o[4 * j + 3] + acc[4 * j + 3]) * alpha[1];
    }
    split_p<kBN>(s, ph, pl);
  }
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  pv_done();
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] += acc[i];
}

// o / l in fp32 to rows [row0, row0 + 64) of `out` (row stride `sl`, unit columns); rows at
// or past `len` are not stored.
template <int D>
__device__ __forceinline__ void store_out(const float* o, float* l, float* out, int64_t sl,
                                          int row0, int len) {
  const int t = threadIdx.x % 128, lane = t % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * (t / 32) + lane / 4 + 8 * r;
    if (row >= len) continue;
    float* orow = out + static_cast<int64_t>(row) * sl + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(o[4 * j + 2 * r] * l[r], o[4 * j + 2 * r + 1] * l[r]);
    }
  }
}

template <int D, bool NORM>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1) attention_f32_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int kBN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t qs = smem_u32(smem);   // Q hi, then Q lo
  const uint32_t ring = qs + 2 * C::kQBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* qready = bars;              // Q converted
  uint64_t* kfull = bars + 1;           // K tile converted
  uint64_t* vfull = kfull + kStages;    // V^T tile converted
  uint64_t* kempty = vfull + kStages;   // K tile read by S
  uint64_t* vempty = kempty + kStages;  // V^T tile read by P V

  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * C::kBM;
  const int warp = warp_uniform_index(), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qready, kConvWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kfull[s], kConvWarps);
      mbar_init(&vfull[s], kConvWarps);
      mbar_init(&kempty[s], 128 * C::kGroups);
      mbar_init(&vempty[s], 128 * C::kGroups);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * C::kGroups) {
    // ---- the converter warps: Q, then each K and V tile, loaded a tile ahead ----
    setmaxnreg_dec<C::kConvRegs>();
    const int cw = warp - 4 * C::kGroups, tid = threadIdx.x - 128 * C::kGroups;
    const float* qb = p.q + b * p.s[0] + h * p.s[2];
    const float* kb = p.k + b * p.s[3] + h * p.s[5];
    const float* vb = p.v + b * p.s[6] + h * p.s[8];
    auto arrive = [&](uint64_t* bar) {  // this warp's writes, to the async proxy (wgmma)
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
#pragma unroll 1
    for (int r0 = 0; r0 < C::kBM; r0 += kBN) {  // Q in passes of a K tile's rows
      RowTile<D, kBN, NORM> qt;
      qt.load(qb, p.s[1], q0 + r0, p.lq, p.wq, p.cq, p.sq, cw, lane);
      qt.store(qs, qs + C::kQBytes, C::kBM, r0, p.eps, cw, lane);
    }
    arrive(qready);
    // each K and V tile: its loads issued right after the tile before left the registers
    // (K's before that V tile is written), written once its stage is free
    RowTile<D, kBN, NORM> kt;
    VTile<D, kBN> vt;
    const int n_tiles = (p.lk + kBN - 1) / kBN;
    kt.load(kb, p.s[4], 0, p.lk, p.wk, p.ck, p.sk, cw, lane);
    vt.load(vb, p.s[7], 0, p.lk, tid);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages, round = t / kStages;
      const uint32_t stage = ring + st * C::kStageBytes;
      const bool next = t + 1 < n_tiles;
      if (round > 0) mbar_wait(&kempty[st], (round - 1) & 1);
      kt.store(stage, stage + C::kTile, kBN, 0, p.eps, cw, lane);
      arrive(&kfull[st]);
      if (next) kt.load(kb, p.s[4], (t + 1) * kBN, p.lk, p.wk, p.ck, p.sk, cw, lane);
      if (round > 0) mbar_wait(&vempty[st], (round - 1) & 1);
      vt.store(stage + 2 * C::kTile, stage + 3 * C::kTile, tid);
      arrive(&vfull[st]);
      if (next) vt.load(vb, p.s[7], (t + 1) * kBN, p.lk, tid);
    }
    return;
  }

  // ---- the consumer warpgroups: warpgroup g owns query rows q0 + 64 g .. q0 + 64 g + 63 ----
  setmaxnreg_inc<C::kConsumerRegs>();
  const int g = warp / 4;
  float o[D / 2], l[2];
  mbar_wait(qready, 0);
  consume<D>(qs + g * 64 * 128, ring, kfull, vfull, kempty, vempty, p.lk, p.scale_log2, o, l);
  store_out<D>(o, l, p.o + b * p.s[9] + h * p.s[11], p.s[10], q0 + 64 * g, p.lq);
}

template <int D, bool NORM>
int launch(const Params& p, int batch, void* stream) {
  using C = Cfg<D>;
  static bool attr_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64 || !attr_set[device]) {
    err = cudaFuncSetAttribute(attention_f32_kernel<D, NORM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) attr_set[device] = true;
  }
  const dim3 grid((p.lq + C::kBM - 1) / C::kBM, batch * p.heads);
  attention_f32_kernel<D, NORM>
      <<<grid, C::kThreads, C::kSmem, static_cast<cudaStream_t>(stream)>>>(p);
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
  p.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(head_dim));
  return p;
}

}  // namespace

// Plain C entries, bound with ctypes, with the signatures of the 16-bit kernels' entries.
// Pointers are device pointers to fp32 [B, L, H, D] data; `strides` holds 12 element
// strides: (batch, length, head) for q, k, v and o, in that order, with a unit stride on D.
// Every pointer must be 16-byte aligned and every stride a multiple of 4 (the wrappers check),
// batch * heads at most 65535 (the grid's y extent), and batch, heads, lq and lk at least 1
// (cudaErrorInvalidValue otherwise: with no keys the consumer would wait for a tile that
// never comes). Each launches on `stream` and returns cudaGetLastError() (0 on success).

// K2 in fp32: `head_dim` 64 or 128 (cudaErrorInvalidValue otherwise).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   const int64_t* strides, int batch, int heads, int lq,
                                   int lk, int head_dim, void* stream) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1) return static_cast<int>(cudaErrorInvalidValue);
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
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1) return static_cast<int>(cudaErrorInvalidValue);
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
