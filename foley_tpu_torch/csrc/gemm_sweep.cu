// Chained weight-streaming GEMM sweep for Hopper (sm_90a), bf16 operands, fp32 accumulation.
//
// Replaces the Pallas kernel tools/probe_gemm_pallas.py:93 (main's pallas_call; body
// `kernel` :70-91). What it computes, for b = 0 .. B-1 over stacked weights w [B, K, N],
// N >= K, starting from x [M, K]:
//   x = bf16(tanh(x @ w[b, :, :K]))
// with bf16 operands, fp32 products and sums, tanh in fp32 and one rounding to bf16 at the
// store (the Pallas body's :79 and :83). Only the first K columns of each weight block are
// read, through w's strides; the slice is never copied.
//
// Bound on an H100, at the probe's shape (M 784, K 1536, N 4608, 36 blocks): a sweep does
// 2*36*784*1536^2 = 133.2 GFLOP against 169.9 MB of weights and 4.8 MB of x in and out,
// 762 operations per byte, above the card's ~295: bound by the tensor cores, 134.7 us at
// 989 TFLOP/s (52.1 us for its bytes). A block is 3.70 GFLOP, 3.7 us at peak.
//
// Design, and where the TPU kernel does not carry over.
//  * The chain. The TPU runs the grid (36 blocks x 9 N-tiles) in order on one core and
//    carries x from step to step in VMEM scratch. Hopper runs blocks in parallel, and block
//    b + 1 needs every column of block b's output (its contraction runs over all of K). So
//    the C entry issues one launch per weight block on one stream; stream order is the
//    barrier between blocks. The launches ping-pong between two [M, K] buffers that the
//    wrapper allocates; a launch never writes the buffer it reads.
//  * Residency. x is 784 x 1536 bf16, 2.41 MB, past an SM's 227 KB. It lives in the 50 MB
//    L2: each output tile re-reads its row panel of x from there, while the weights stream
//    from device memory once a sweep.
//  * Dead tiles. The TPU kernel computes all 9 N-tiles of 512 and stores 3; this kernel
//    computes only the K columns that the chain uses, a third of the tool's products.
//  * Tiles and waves. An output tile is 128 rows x 96 columns of 8 warps (4 x 2, each warp
//    32 x 48). At the probe's shape a launch has 7 x 16 = 112 blocks on 132 SMs: one wave,
//    every block resident at once. 128 x 128 tiles would give 84 blocks (48 SMs idle) and
//    64 x 128 tiles 156, more than one wave.
//  * The products run on mma.sync m16n8k16 bf16 tiles with fp32 accumulators. A is loaded
//    with ldmatrix, B (k rows, n contiguous) with ldmatrix.trans. K slabs of 64 go through a
//    3-stage cp.async ring in shared memory, so two slabs are in flight while one is
//    computed.
//  * Ragged edges are masked in the kernel: 784 = 6 * 128 + 16, so rows >= M are zero-filled
//    by the copy and not stored; columns >= K likewise (K must be a multiple of 64).
//  * The epilogue takes tanhf of the fp32 sums and stores bf16 pairs.
// Shared memory: 3 stages of a 128 x 72 A slab and a 64 x 104 B slab (padded rows, no bank
// conflicts for ldmatrix), 95,232 bytes, dynamic.
// wgmma, TMA and a persistent grid are left for a later, faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;           // output rows per block
constexpr int kBN = 96;            // output columns per block
constexpr int kBK = 64;            // contraction depth per slab (the wrapper's K step)
constexpr int kStages = 3;
constexpr int kWarpsM = 4, kWarpsN = 2;
constexpr int kThreads = kWarpsM * kWarpsN * 32;
constexpr int kWM = kBM / kWarpsM;  // 32 rows a warp
constexpr int kWN = kBN / kWarpsN;  // 48 columns a warp
constexpr int kMI = kWM / 16;       // m16 tiles a warp
constexpr int kNI = kWN / 8;        // n8 tiles a warp
constexpr int kLda = kBK + 8;       // shared row strides in bf16 elements (bank-conflict pad)
constexpr int kLdb = kBN + 8;
constexpr int kStageA = kBM * kLda;
constexpr int kStageB = kBK * kLdb;
constexpr int kSmem = kStages * (kStageA + kStageB) * static_cast<int>(sizeof(__nv_bfloat16));

struct Params {
  const __nv_bfloat16* x;  // [M, K], row stride x_ld
  const __nv_bfloat16* w;  // one weight block [K, >= K], row stride w_ld
  __nv_bfloat16* out;      // [M, K], row stride K
  int64_t x_ld, w_ld;
  int m, k;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row (l % 8) of
// matrix (l / 8).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D = A * B + D for one m16n8k16 tile, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start copying K slab `kt` into one stage: A rows [m0, m0 + 128) x columns [k0, k0 + 64)
// of x, B rows [k0, k0 + 64) x columns [n0, n0 + 96) of w. Rows of A past M and columns of
// B past K are zero-filled (their source address stays in bounds).
__device__ __forceinline__ void load_slab(const Params& p, __nv_bfloat16* sa, __nv_bfloat16* sb,
                                          int m0, int n0, int kt) {
  const int k0 = kt * kBK;
  constexpr int kChunksA = kBK / 8;  // 16-byte chunks per A row
  for (int c = threadIdx.x; c < kBM * kChunksA; c += kThreads) {
    const int r = c / kChunksA, col = (c % kChunksA) * 8;
    const bool valid = m0 + r < p.m;
    const __nv_bfloat16* src = p.x + (valid ? (int64_t)(m0 + r) * p.x_ld + k0 + col : 0);
    cp_async_16(smem_addr(sa + r * kLda + col), src, valid ? 16 : 0);
  }
  constexpr int kChunksB = kBN / 8;
  for (int c = threadIdx.x; c < kBK * kChunksB; c += kThreads) {
    const int r = c / kChunksB, col = (c % kChunksB) * 8;
    const bool valid = n0 + col < p.k;
    const __nv_bfloat16* src = p.w + (valid ? (int64_t)(k0 + r) * p.w_ld + n0 + col : 0);
    cp_async_16(smem_addr(sb + r * kLdb + col), src, valid ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
gemm_tanh_kernel(const Params p) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* sa = smem;                       // kStages A slabs
  __nv_bfloat16* sb = smem + kStages * kStageA;   // kStages B slabs

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment coordinates
  const int n_slabs = p.k / kBK;

  // ldmatrix row addresses of this lane: A (16 x 16, non-transposed) and B (16 k x 16 n,
  // transposed) blocks
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int b_row = (lane / 8 % 2) * 8 + lane % 8, b_col = (lane / 16) * 8;

  float acc[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slabs) load_slab(p, sa + s * kStageA, sb + s * kStageB, m0, n0, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_slabs; ++kt) {
    cp_async_wait<kStages - 2>();  // slab kt has landed
    __syncthreads();               // ... for every thread, and slab kt - 1's stage is free
    const int next = kt + kStages - 1;
    if (next < n_slabs) {
      const int s = next % kStages;
      load_slab(p, sa + s * kStageA, sb + s * kStageB, m0, n0, next);
    }
    cp_async_commit();  // an empty group near the end keeps the wait count uniform

    const __nv_bfloat16* a = sa + (kt % kStages) * kStageA;
    const __nv_bfloat16* b = sb + (kt % kStages) * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[kMI][4];
#pragma unroll
      for (int i = 0; i < kMI; ++i)
        ldmatrix_x4(af[i], smem_addr(a + (wm + i * 16 + a_row) * kLda + kk * 16 + a_col));
#pragma unroll
      for (int jp = 0; jp < kNI / 2; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, smem_addr(b + (kk * 16 + b_row) * kLdb + wn + jp * 16 + b_col));
#pragma unroll
        for (int i = 0; i < kMI; ++i) {
          mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: tanh of the fp32 sums, one rounding to bf16, masked store
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wm + i * 16 + g + r * 8;
      if (row >= p.m) continue;
      __nv_bfloat16* orow = p.out + (int64_t)row * p.k;
#pragma unroll
      for (int j = 0; j < kNI; ++j) {
        const int col = n0 + wn + j * 8 + t4 * 2;
        if (col >= p.k) continue;
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(tanhf(acc[i][j][2 * r]), tanhf(acc[i][j][2 * r + 1]));
      }
    }
  }
}

}  // namespace

// Plain C entry, bound with ctypes. x: bf16 [m, k] with row stride x_ld; w: bf16 [blocks, k,
// >= k] with strides (w_sb, w_sk) and a unit last stride; buf0, buf1: bf16 [m, k] contiguous
// (buf1 may be null when blocks is 1). Every pointer must be 16-byte aligned, every stride a
// multiple of 8 and k a multiple of 64 (the wrapper checks). Issues one launch per weight
// block on `stream`: block b reads x (b = 0) or buf[(b - 1) % 2] and writes buf[b % 2], so the
// result is in buf[(blocks - 1) % 2]. Returns the first nonzero cudaGetLastError() (0 on
// success); a launch that fails stops the sweep.
extern "C" int gemm_sweep_bf16(const void* x, const void* w, void* buf0, void* buf1, int m,
                               int k, int blocks, int64_t x_ld, int64_t w_sb, int64_t w_sk,
                               void* stream) {
  if (m < 1 || k < kBK || k % kBK || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(gemm_tanh_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((k + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  __nv_bfloat16* bufs[2] = {static_cast<__nv_bfloat16*>(buf0), static_cast<__nv_bfloat16*>(buf1)};
  Params p;
  p.m = m;
  p.k = k;
  p.w_ld = w_sk;
  for (int b = 0; b < blocks; ++b) {
    p.x = b == 0 ? static_cast<const __nv_bfloat16*>(x) : bufs[(b - 1) % 2];
    p.x_ld = b == 0 ? x_ld : k;
    p.w = static_cast<const __nv_bfloat16*>(w) + b * w_sb;
    p.out = bufs[b % 2];
    gemm_tanh_kernel<<<grid, kThreads, kSmem, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
