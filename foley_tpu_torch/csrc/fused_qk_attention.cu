// Fused qk-RMSNorm + RoPE + softmax attention for Hopper (sm_90a), bf16 or fp16, head_dim 128.
//
// Replaces the Pallas kernel foley_tpu/ops/pallas/fused_attention.py:82
// (fused_qk_attention_headfirst; body _kernel :57, helpers _norm_rope :50, _rot_half_lanes :39).
// What it computes, per batch row b, head h and query row i:
//   qn = rope(rms_norm(q[b, i, h]) * wq[i]),  kn = rope(rms_norm(k[b, j, h]) * wk[j])   (fp32)
//   o[b, i, h] = softmax_j(qn . kn / sqrt(D)) @ v[b, :, h]
// with the normalised/rotated q and k cast to the input type (bf16 or fp16) before the
// products, fp32 accumulation, and p cast to that type before p @ v. The rotation is pair-adjacent:
//   out[2m] = x[2m] cos[2m] - x[2m+1] sin[2m],  out[2m+1] = x[2m+1] cos[2m+1] + x[2m] sin[2m+1].
// The weight and cos/sin tables are fp32 [L, D], one row per position, so one launch serves
// the joint [v_cond; audio] sequence whose two streams have different norm weights and tables.
//
// Bound on an NVIDIA H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16 and fp16, at a 700 W power
// limit; fp16 runs the same code at the same rates, the element type a template): at
// the 5 s shapes (joint L 290, single L 250, B*H 24) a launch must read q, k, v, write o and
// read the per-position cos/sin, about 3.6 MB at L 290, against about 1 GFLOP: bound by
// bytes, about 1 us. What holds a launch back at these shapes is latency, not either rate:
// a block runs a chain of copy -> norm -> products per 64-key tile, and 120 blocks give one
// block per SM with nothing to hide the chain behind. The design shortens the chain:
//  * Every copy is asynchronous and in flight early. One thread issues TMA tile loads (4-D
//    tensor maps over the [B, L, H, D] strides, 128-byte swizzle) of Q and of K and V into a
//    ring of 5 stages of 64 keys; the prologue issues all of them that fit, which at L <= 320
//    is the whole K and V of the (b, h). Past that (the 30 s windows, L 1740) the ring
//    streams: a stage is refilled when the products release it.
//  * The norm + RoPE pass runs on its own warps. Eight warps that issue no products
//    normalise and rotate the Q tile, then each K tile, in place in shared memory (the
//    swizzle moves 16-byte chunks and a rotation pair lies inside one), while the consumer
//    warpgroup computes on the tiles before. Each warp owns 8 rows of a tile; the table rows
//    it needs are fetched into registers in one batch of independent 16-byte loads, issued
//    before it waits for the tile's copy, so no global read waits inside its row loop.
//    (Staging the fp32 tables in shared memory would take 96 KB a tile, more than the ring
//    leaves.) The pass ends with fence.proxy.async and an mbarrier arrive, so wgmma reads
//    what the threads wrote.
//  * One consumer warpgroup owns the block's 64 query rows: S = Q K^T is a wgmma with both
//    operands in shared memory, the online softmax runs in registers, and O += P V is a
//    wgmma with P repacked from the S accumulators and V read raw and transposed by its
//    descriptor; S of the next tile and P V of this one are in flight while its softmax
//    runs. It releases a stage to the copy once both products are done. This main loop is
//    K2's (hopper.cuh, attention_consumer).
//  * setmaxnreg moves 16 registers a thread from the consumer warpgroup to the norm warps,
//    whose prefetched table rows are the block's largest state: neither spills.
//  * Ragged edges: TMA zero-fills rows past Lq and Lk; zero rows stay zero through the
//    norm; keys >= Lk get -inf logits; rows >= Lq are not stored.
// Shared memory: the Q tile and 5 stages of a K and a V tile of 64 x 128 16-bit elements,
// 176 KB, one block of 12 warps per SM. The fp32 variant is another kernel
// (attention_f32.cu): wgmma has no true-fp32 product.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 128;
constexpr int kBM = 64;          // query rows per block: one consumer warpgroup
constexpr int kBN = 64;          // keys per tile
constexpr int kStages = 5;       // K/V ring depth: a whole head at L <= 320
constexpr int kNormWarps = 8;    // 8 rows of a tile each
constexpr int kRowsPerWarp = kBM / kNormWarps;
constexpr int kThreads = 128 + kNormWarps * 32;
// registers a thread: the block holds 384 x 168; the consumer warpgroup gives 16 of its 168
// to the two warpgroups of norm warps, which take 8 more each (128 x 152 + 256 x 176 =
// 384 x 168: an increase waits until the block's own pool holds the registers)
constexpr int kConsumerRegs = 152;
constexpr int kNormRegs = 176;
static_assert(128 * kConsumerRegs + kNormWarps * 32 * kNormRegs <= kThreads * 168,
              "setmaxnreg moves registers only inside the block's allocation");
constexpr int kSlab = kBN * 128;         // bytes of one 64-column slab of a 64-row tile
constexpr int kTileBytes = 2 * kSlab;    // a 64 x 128 tile of 16-bit elements
constexpr int kBarOffset = kTileBytes * (1 + 2 * kStages);
constexpr int kSmem = kBarOffset + (2 + 4 * kStages) * 8 + 1024;  // + alignment
static_assert(kBM == kBN, "the Q tile and the K tiles share one layout and one norm pass");

template <typename T>
struct Params {
  const float* wq;
  const float* wk;
  const float* cq;
  const float* sq;
  const float* ck;
  const float* sk;
  T* o;
  int64_t o_sb, o_sl, o_sh;  // element strides of the output's batch, length and head axes
  int heads, lq, lk;
  float eps;
  float scale_log2;  // log2(e) / sqrt(D)
};

// The table rows a norm warp needs for its 8 rows of a tile: lane l holds columns 4l..4l+3.
struct Tabs {
  float4 w[kRowsPerWarp], c[kRowsPerWarp], s[kRowsPerWarp];
};

__device__ __forceinline__ void load_tabs(Tabs& tb, const float* w, const float* cs,
                                          const float* sn, int row, int len, int lane) {
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    tb.w[i] = tb.c[i] = tb.s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row + i < len) {
      const int64_t off = static_cast<int64_t>(row + i) * kD + 4 * lane;
      tb.w[i] = __ldg(reinterpret_cast<const float4*>(w + off));
      tb.c[i] = __ldg(reinterpret_cast<const float4*>(cs + off));
      tb.s[i] = __ldg(reinterpret_cast<const float4*>(sn + off));
    }
  }
}

// In place on rows r0..r0+7 of a swizzled 64 x 128 tile of T:
// x <- T(rope(x * rsqrt(mean(x^2) + eps) * w)), fp32 math. Zero rows stay zero.
template <typename T>
__device__ __forceinline__ void norm_rope_rows(uint8_t* tile, const Tabs& tb, int r0,
                                               float eps, int lane) {
  using Pair = typename Elem<T>::Pair;
  // lane l's 4 columns of row r: slab l / 16, 16-byte chunk (l % 16) / 2 moved by the
  // 128-byte swizzle of TMA, half l % 2 of it
  auto at = [&](int r) {
    return reinterpret_cast<uint2*>(tile + (lane / 16) * kSlab + r * 128 +
                                    ((((lane % 16) / 2) ^ (r & 7)) << 4) + (lane & 1) * 8);
  };
  float x[kRowsPerWarp][4], ss[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const uint2 raw = *at(r0 + i);
    const Pair x01 = *reinterpret_cast<const Pair*>(&raw.x);
    const Pair x23 = *reinterpret_cast<const Pair*>(&raw.y);
    x[i][0] = __low2float(x01);
    x[i][1] = __high2float(x01);
    x[i][2] = __low2float(x23);
    x[i][3] = __high2float(x23);
    ss[i] = x[i][0] * x[i][0] + x[i][1] * x[i][1] + x[i][2] * x[i][2] + x[i][3] * x[i][3];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], off);
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const float inv = rsqrtf(ss[i] * (1.0f / kD) + eps);
    const float4 wv = tb.w[i], cv = tb.c[i], sv = tb.s[i];
    const float y0 = x[i][0] * inv * wv.x, y1 = x[i][1] * inv * wv.y;
    const float y2 = x[i][2] * inv * wv.z, y3 = x[i][3] * inv * wv.w;
    uint2 out;
    out.x = Elem<T>::pack(y0 * cv.x - y1 * sv.x, y1 * cv.y + y0 * sv.y);
    out.y = Elem<T>::pack(y2 * cv.z - y3 * sv.z, y3 * cv.w + y2 * sv.w);
    *at(r0 + i) = out;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_qk_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const Params<T> p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* qs = smem;                // the Q tile
  uint8_t* ring = smem + kTileBytes; // stage s: K at ring + 2 s kTileBytes, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* qfull = bars;            // Q copied
  uint64_t* qready = bars + 1;       // Q normalised and rotated
  uint64_t* kfull = bars + 2;        // K tile copied
  uint64_t* kready = kfull + kStages;  // K tile normalised and rotated
  uint64_t* vfull = kready + kStages;  // V tile copied
  uint64_t* empty = vfull + kStages;   // stage released by the products

  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * kBM;
  const int n_tiles = (p.lk + kBN - 1) / kBN;
  const int warp = warp_uniform_index(), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qready, kNormWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kready[s], kNormWarps);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4) {
    // ---- norm warps; the first lane of the first one also issues every copy ----
    setmaxnreg_inc<kNormRegs>();  // their prefetched table rows are the block's largest state
    const bool issuer = warp == 4 && lane == 0;
    const int r0 = (warp - 4) * kRowsPerWarp;
    auto load_kv = [&](int t) {
      const int s = t % kStages;
      uint8_t* kt = ring + 2 * s * kTileBytes;
      mbar_arrive_expect_tx(&kfull[s], kTileBytes);
      tma_load_4d(kt, &kmap, &kfull[s], 0, h, t * kBN, b);
      tma_load_4d(kt + kSlab, &kmap, &kfull[s], 64, h, t * kBN, b);
      mbar_arrive_expect_tx(&vfull[s], kTileBytes);
      tma_load_4d(kt + kTileBytes, &vmap, &vfull[s], 0, h, t * kBN, b);
      tma_load_4d(kt + kTileBytes + kSlab, &vmap, &vfull[s], 64, h, t * kBN, b);
    };
    if (issuer) {
      mbar_arrive_expect_tx(qfull, kTileBytes);
      tma_load_4d(qs, &qmap, qfull, 0, h, q0, b);
      tma_load_4d(qs + kSlab, &qmap, qfull, 64, h, q0, b);
      for (int t = 0; t < n_tiles && t < kStages; ++t) load_kv(t);
    }
    Tabs tb;
    load_tabs(tb, p.wq, p.cq, p.sq, q0 + r0, p.lq, lane);
    mbar_wait(qfull, 0);
    norm_rope_rows<T>(qs, tb, r0, p.eps, lane);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(qready);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages, round = t / kStages;
      load_tabs(tb, p.wk, p.ck, p.sk, t * kBN + r0, p.lk, lane);
      if (issuer && round > 0) {  // refill the stage once the products release it
        mbar_wait(&empty[s], (round - 1) & 1);
        load_kv(t);
      }
      mbar_wait(&kfull[s], round & 1);
      norm_rope_rows<T>(ring + 2 * s * kTileBytes, tb, r0, p.eps, lane);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&kready[s]);
    }
    return;
  }

  // ---- the consumer warpgroup: query rows q0 .. q0 + 63 ----
  setmaxnreg_dec<kConsumerRegs>();
  float o[kD / 2], l[2];
  mbar_wait(qready, 0);
  attention_consumer<kD, kBN, kStages, 1, T>(smem_u32(qs), kSlab, smem_u32(ring), kready,
                                             vfull, empty, p.lk, p.scale_log2, 0, 0, o, l);
  store_rows<kD, T>(o, l, p.o + b * p.o_sb + h * p.o_sh, p.o_sl, q0, p.lq);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, const void* wq,
           const void* wk, const void* cq, const void* sq, const void* ck, const void* sk,
           const int64_t* strides, int batch, int heads, int lq, int lk, float eps,
           void* stream) {
  static bool attr_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64 || !attr_set[device]) {
    err = cudaFuncSetAttribute(fused_qk_attention_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) attr_set[device] = true;
  }
  const CUtensorMapDataType type = hopper_host::map_type<T>();
  CUtensorMap qm, km, vm;
  int e = hopper_host::tensor_map(&qm, q, batch, lq, heads, kD, strides[0], strides[1],
                                  strides[2], kBM, type);
  if (e == 0) e = hopper_host::tensor_map(&km, k, batch, lk, heads, kD, strides[3], strides[4],
                                          strides[5], kBN, type);
  if (e == 0) e = hopper_host::tensor_map(&vm, v, batch, lk, heads, kD, strides[6], strides[7],
                                          strides[8], kBN, type);
  if (e != 0) return e;
  Params<T> p;
  p.wq = static_cast<const float*>(wq);
  p.wk = static_cast<const float*>(wk);
  p.cq = static_cast<const float*>(cq);
  p.sq = static_cast<const float*>(sq);
  p.ck = static_cast<const float*>(ck);
  p.sk = static_cast<const float*>(sk);
  p.o = static_cast<T*>(o);
  p.o_sb = strides[9]; p.o_sl = strides[10]; p.o_sh = strides[11];
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.eps = eps;
  p.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(kD));
  const dim3 grid((lq + kBM - 1) / kBM, batch * heads);
  fused_qk_attention_kernel<T><<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries, bound with ctypes, one for each element type. Pointers are device
// pointers: q, k, v and o bf16 (fp16) [B, L, H, 128]; the six tables fp32 [L, 128],
// contiguous, 16-byte aligned. `strides` holds 12 element strides: (batch, length, head) for
// q, k, v and o, in that order. Every pointer must be 16-byte aligned and every stride a
// multiple of 8 (the wrapper checks). Launches on `stream` and returns cudaGetLastError() (0
// on success), -1 when the driver cannot describe an operand as a tensor map, -2 when its
// encoder is not reachable.
extern "C" int fused_qk_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                       const void* wq, const void* wk, const void* cq,
                                       const void* sq, const void* ck, const void* sk,
                                       const int64_t* strides, int batch, int heads, int lq,
                                       int lk, float eps, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, wq, wk, cq, sq, ck, sk, strides, batch, heads, lq,
                               lk, eps, stream);
}

extern "C" int fused_qk_attention_f16(const void* q, const void* k, const void* v, void* o,
                                      const void* wq, const void* wk, const void* cq,
                                      const void* sq, const void* ck, const void* sk,
                                      const int64_t* strides, int batch, int heads, int lq,
                                      int lk, float eps, void* stream) {
  return launch<__half>(q, k, v, o, wq, wk, cq, sq, ck, sk, strides, batch, heads, lq, lk, eps,
                        stream);
}
