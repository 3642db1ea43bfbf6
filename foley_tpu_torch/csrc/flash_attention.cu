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
// Bound on an NVIDIA H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s, at a 700 W power limit),
// at SigLIP2's 5 s call (B 40 frames, L 1024, 12 heads of 64): a launch does
// 4*B*H*L*L*D = 128.8 GFLOP of products against 251.7 MB of q, k, v and o in bf16, 512
// operations per byte, above the card's ~295: bound by the tensor cores, 130 us (75 us for
// its bytes). Only wgmma reaches the tensor cores' full rate, and it must be fed from shared
// memory faster than a thread-driven copy can, so the design is the usual one for Hopper:
//  * Warp specialised. One producer warp issues every load as a TMA tile copy (4-D tensor
//    maps over the [B, L, H, D] strides, so the three projections' reshaped views are read
//    as they are) into a ring of 4 K/V stages, with a full and an empty mbarrier a stage and
//    separate full barriers for K and V, so S = Q K^T starts before V has landed.
//  * Consumer warpgroups of 64 query rows each, three at D 64 (192 rows a block) and two at
//    D 128, so every K/V tile that crosses into shared memory feeds 128-192 query rows.
//    S = Q K^T is a wgmma with both operands in shared memory; the online softmax runs in
//    registers on the accumulators; O += P V is a wgmma with P repacked from the S
//    accumulators into A registers and V read MN-major (the descriptor transposes it).
//    Everything in shared memory uses the 128-byte swizzle that TMA writes and wgmma reads.
//  * The exponentials and the products overlap: inside a warpgroup S of the next tile and
//    P V of this one are in flight while its softmax runs, and the warpgroups take turns
//    to issue their products (named barriers), so one's softmax runs while another's
//    products do. exp2 is the special-function unit's ex2.approx alone. setmaxnreg gives
//    the producer's registers to the consumers (160 a thread at D 64, 240 at D 128).
//  * Persistent: one block an SM walks the (query block, b, h) items; the producer runs
//    ahead into the next item (Q double-buffered), so an item's first copies and last
//    products overlap its neighbour's.
//  * Tiles of 128 keys at D 64 (S is m64n128, O is m64n64), 64 keys at D 128 (m64n64 and
//    m64n128), so the registers of S and O stay within one thread's budget.
//  * Ragged edges: TMA zero-fills rows past Lq and Lk (the length is its own tensor-map
//    axis, so a box never reads the next batch row); keys >= Lk get -inf logits, rows >= Lq
//    are not stored. A row whose running max is still -inf uses 0 as its exponent base.
// Shared memory: two Q tiles and 4 stages of a K and a V tile, 176 KB at D 64 and 192 KB
// at D 128.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 4;                // K/V ring depth
constexpr int kProducerRegs = 24;

template <int D>
struct Cfg {
  // consumer warpgroups of 64 query rows, and the registers each thread of them takes from
  // the producer warpgroup: the block holds kThreads x (65,536 / kThreads) registers, and
  // setmaxnreg moves them only inside that
  static constexpr int kGroups = D == 64 ? 3 : 2;
  static constexpr int kConsumerRegs = D == 64 ? 160 : 240;
  static constexpr int kBM = 64 * kGroups;              // query rows per work item
  static constexpr int kThreads = (kGroups + 1) * 128;  // + the producer warpgroup
  static_assert(kGroups * 128 * kConsumerRegs + 128 * kProducerRegs <=
                    kThreads * (65536 / kThreads / 8 * 8), "setmaxnreg exceeds the block's pool");
  static constexpr int kBN = D == 64 ? 128 : 64;   // keys per tile
  static constexpr int kSlabs = D / 64;            // 64-column slabs of 128-byte rows
  static constexpr int kQBytes = kBM * D * 2;      // one of the two Q buffers
  static constexpr int kTileBytes = kBN * D * 2;   // one K or V tile
  static constexpr int kBarOffset = 2 * kQBytes + kStages * 2 * kTileBytes;
  static constexpr int kSmem = kBarOffset + (4 + 3 * kStages) * 8 + 1024;  // + alignment
};

struct Params {
  __nv_bfloat16* o;
  int64_t o_sb, o_sl, o_sh;  // element strides of the output's batch, length and head axes
  int heads, lq, lk;
  int q_blocks, n_work;      // kBM-row query blocks a (b, h); work items q_blocks * B * H
  float scale_log2;  // log2(e) / sqrt(D)
};

// Persistent: block i takes work items i, i + gridDim.x, ...; item w is query block
// w % q_blocks of (b, h) = w / q_blocks, so neighbouring items share K and V in L2. The
// producer runs ahead into the next item (its Q into the other Q buffer, its K/V tiles
// into the ring), so one item's first copies and last products overlap the next one's.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const Params p) {
  using C = Cfg<D>;
  constexpr int kBN = C::kBN, kBM = C::kBM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* qs = smem;  // Q buffer j at qs + j kQBytes; slab c of it: kBM rows at c kBM 128
  uint8_t* ring = smem + 2 * C::kQBytes;  // stage s: K at ring + 2 s kTileBytes, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* qfull = bars;       // [2]: Q buffer landed
  uint64_t* qempty = bars + 2;  // [2]: Q buffer released by the consumers
  uint64_t* kfull = bars + 4;
  uint64_t* vfull = kfull + kStages;
  uint64_t* empty = vfull + kStages;

  const int n_tiles = (p.lk + kBN - 1) / kBN;
  const int warp = warp_uniform_index(), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) {
      mbar_init(&qfull[j], 1);
      mbar_init(&qempty[j], C::kGroups * 128);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], C::kGroups * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= C::kGroups * 4) {
    // ---- producer: each item's Q, then its K/V tiles through the ring ----
    setmaxnreg_dec<kProducerRegs>();
    if (warp == C::kGroups * 4 && lane == 0) {
      int pos = 0;  // ring position of the next K/V tile
      for (int w = blockIdx.x, i = 0; w < p.n_work; w += gridDim.x, ++i) {
        const int bh = w / p.q_blocks, b = bh / p.heads, h = bh % p.heads;
        const int j = i % 2;
        if (i >= 2) mbar_wait(&qempty[j], ((i / 2) - 1) & 1);
        mbar_arrive_expect_tx(&qfull[j], C::kQBytes);
        for (int c = 0; c < C::kSlabs; ++c)
          tma_load_4d(qs + j * C::kQBytes + c * kBM * 128, &qmap, &qfull[j], 64 * c, h,
                      (w % p.q_blocks) * kBM, b);
        for (int t = 0; t < n_tiles; ++t, ++pos) {
          const int s = pos % kStages, round = pos / kStages;
          if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
          uint8_t* kt = ring + 2 * s * C::kTileBytes;
          mbar_arrive_expect_tx(&kfull[s], C::kTileBytes);
          for (int c = 0; c < C::kSlabs; ++c)
            tma_load_4d(kt + c * kBN * 128, &kmap, &kfull[s], 64 * c, h, t * kBN, b);
          mbar_arrive_expect_tx(&vfull[s], C::kTileBytes);
          for (int c = 0; c < C::kSlabs; ++c)
            tma_load_4d(kt + C::kTileBytes + c * kBN * 128, &vmap, &vfull[s], 64 * c, h,
                        t * kBN, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each item's query block ----
  setmaxnreg_inc<C::kConsumerRegs>();
  const int wg = warp / 4;
  int pos = 0;
  for (int w = blockIdx.x, i = 0; w < p.n_work; w += gridDim.x, ++i, pos += n_tiles) {
    const int bh = w / p.q_blocks, b = bh / p.heads, h = bh % p.heads;
    const int j = i % 2, row0 = (w % p.q_blocks) * kBM + 64 * wg;
    float o[D / 2], l[2];
    mbar_wait(&qfull[j], (i / 2) & 1);
    attention_consumer<D, kBN, kStages, C::kGroups>(
        smem_u32(qs + j * C::kQBytes) + wg * 64 * 128, kBM * 128, smem_u32(ring), kfull, vfull,
        empty, p.lk, p.scale_log2, pos, wg, o, l);
    mbar_arrive(&qempty[j]);
    store_rows<D>(o, l, p.o + b * p.o_sb + h * p.o_sh, p.o_sl, row0, p.lq);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int64_t* strides, int batch,
           Params& p, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool attr_set[64] = {};
  static int sms[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[device]) {
    err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[device] = true;
  }
  CUtensorMap qm, km, vm;
  int e = hopper_host::tensor_map(&qm, q, batch, p.lq, p.heads, D, strides[0], strides[1],
                                  strides[2], C::kBM);
  if (e == 0) e = hopper_host::tensor_map(&km, k, batch, p.lk, p.heads, D, strides[3],
                                          strides[4], strides[5], C::kBN);
  if (e == 0) e = hopper_host::tensor_map(&vm, v, batch, p.lk, p.heads, D, strides[6],
                                          strides[7], strides[8], C::kBN);
  if (e != 0) return e;
  p.q_blocks = (p.lq + C::kBM - 1) / C::kBM;
  p.n_work = p.q_blocks * batch * p.heads;
  const int grid = p.n_work < sms[device] ? p.n_work : sms[device];
  flash_attention_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry, bound with ctypes. Pointers are device pointers to bf16 [B, L, H, D] data;
// `strides` holds 12 element strides: (batch, length, head) for q, k, v and o, in that order,
// with a unit stride on D. Every pointer must be 16-byte aligned and every stride a multiple
// of 8 (the wrapper checks). `head_dim` must be 64 or 128 (cudaErrorInvalidValue otherwise).
// Launches on `stream` and returns cudaGetLastError() (0 on success), -1 when the driver
// cannot describe an operand as a tensor map, -2 when its encoder is not reachable.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    const int64_t* strides, int batch, int heads, int lq,
                                    int lk, int head_dim, void* stream) {
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = strides[9]; p.o_sl = strides[10]; p.o_sh = strides[11];
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(head_dim));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(q, k, v, strides, batch, p, s);
  if (head_dim == 128) return launch<128>(q, k, v, strides, batch, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
