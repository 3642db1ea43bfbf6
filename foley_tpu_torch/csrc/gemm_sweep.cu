// Chained weight-streaming GEMM sweep for Hopper (sm_90a): one persistent launch a sweep,
// wgmma on operands that TMA brings into an mbarrier ring, the chain between weight blocks
// carried inside the kernel by a flag per row panel.
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
// 989 TFLOP/s (52.1 us for its bytes). A block is 3.70 GFLOP, 3.7 us at peak. M is small,
// so each weight tile is read from L2 once per row panel and each x panel once per column
// tile: the tile and its cluster are chosen to cut that traffic as well as to fill the SMs.
//
// Design.
//  * One launch a sweep. At most one block an SM (the ring takes most of its shared
//    memory), every block resident at once: the launch is cooperative, so residency is
//    guaranteed and not only likely. Output tiles of 64 rows x 192 columns are grouped in
//    work units of a cluster's 2 x 2 tiles, numbered by pairs of row panels; cluster i owns
//    units i, i + clusters, ... and walks the weight blocks in order, its units in order
//    within each. The TPU runs its grid in order on one core and carries x in VMEM; here
//    the weights stream through the ring regardless of the chain, as the TPU's grid
//    pipeline streams them, and only x waits for the previous weight block.
//  * The chain. Tile (m, n) of weight block b needs rows m of block b - 1's output, every
//    column. A block that finishes a tile stores it (generic stores), fences the async proxy
//    (TMA reads the stores), synchronises its consumer threads, and one thread adds 1 to
//    counters[m] with release semantics at gpu scope. Before it loads the x half of any
//    stage of tile (m, n) of block b > 0, the producer spins with acquire loads until
//    counters[m] >= b * col_tiles, fences the async proxy, then issues the TMA loads. Tile
//    (m, .) of block b adds to counters[m] only after it saw b * col_tiles there, so by
//    induction the count reaches b * col_tiles exactly when every tile of panel m of blocks
//    0 .. b - 1 is done. The C entry zeroes the counters on the stream before every sweep
//    (cudaMemsetAsync, so a CUDA graph of the sweep replays the reset too). A flag per tile,
//    each tile walking its own columns first, was slower: the producer's acquire and fence
//    for every column tile cost more than the wait they saved.
//  * Two buffers suffice (write after read). Block b writes buf[b % 2], which block b - 1
//    read. Tile (m, n) of block b writes rows m only, and starts after counters[m] reached
//    b * col_tiles, that is after every tile of panel m of block b - 1 finished; a tile
//    finishes only after all its TMA loads landed and its products retired, and only the
//    tiles of panel m read rows m.
//  * No deadlock: every block walks its work in (weight block, tile) order and all blocks
//    are resident, so the unfinished tile of the least weight block waits on nothing
//    unfinished. A flag wait that still exceeds 2 s traps (the launch fails) rather than
//    hanging the card.
//  * Warp specialised. One producer thread keeps a ring of 64-deep stages full by TMA. A
//    stage holds the x slab (64 rows x 64 columns, K-major) and the weight slab (64 k-rows x
//    192 columns with N contiguous: wgmma reads it MN-major, transposed by its descriptor,
//    as K2 reads V). At the start of every tile the producer first issues the weight halves
//    of the tile's first stages, into stages the consumers free while they finish the tile
//    before, then waits for the flag and issues the x halves. One consumer warpgroup issues
//    m64n192k16 wgmma on the arrived stages, keeps one stage's products in flight, and
//    releases each stage on its empty mbarrier.
//  * Clusters of 2 x 2 blocks. Multicast cuts the L2 -> SM traffic: the 2 blocks along M
//    share each weight slab and the 2 along N each x slab; each block loads its half of a
//    slab's rows (whole 8-row swizzle groups, so the halves compose into one swizzled slab)
//    into the same offset of both sharing blocks, completing on each one's full barrier. A
//    block's ring is written by the 3 blocks it shares with (itself included), so every
//    consumer warp releases a stage on the empty barrier of each of them, and a producer
//    refills a stage only when all of them have released it. A block whose panel lies past
//    M loads no x (its row peer lies past M too) and stores nothing. Before it exits, a
//    producer waits until its peers have released every stage's last use, so no arrival
//    lands after its shared memory goes.
//  * Ragged edges. TMA zero-fills x rows at or past M; weight slabs wholly past column K
//    are not loaded (K is a multiple of 64); the epilogue stores neither those columns nor
//    rows past M.
//  * Epilogue: tanhf of the fp32 accumulators, one rounding to bf16, bf16 pairs stored.
//  * The tile, at M 784, K 1536: 14 x 8 = 112 blocks of 132; 9.6 MB of x and 33.0 MB of
//    weights from L2 to the SMs a weight block (80.6 MB without the clusters). 64 x 192
//    alone, in clusters of 2 x 1 or 4 x 1, and 128 x 128 were slower at the probe's shape.
// Shared memory: 6 stages of 32 KB and the barriers.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 64;                  // contraction depth of a stage
constexpr int kBM = 64;                  // tile rows: one consumer warpgroup
constexpr int kBN = 192;                 // tile columns: three 64-column weight slabs
constexpr int kCM = 2, kCN = 2;          // cluster: kCM along M share each weight slab,
                                         // kCN along N each x slab, by multicast
constexpr int kCluster = kCM * kCN;
constexpr int kPeers = kCM + kCN - 1;    // blocks that write into a block's ring
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kSlabBytes = 64 * 128;     // 64 rows of 128 bytes: one swizzle slab
constexpr int kWSlabs = kBN / 64;
constexpr int kABytes = kBM * 128;       // x slab: kBM rows of 64 bf16
constexpr int kABoxRows = kBM / kCN;     // this block's share of the x slab
constexpr int kWBoxRows = 64 / kCM;      // ... and of each weight slab
constexpr int kStageBytes = kABytes + kWSlabs * kSlabBytes;
constexpr int kStages = 196608 / kStageBytes;  // 192 KB of stages
constexpr int kBarOffset = kStages * kStageBytes;
constexpr int kSmem = kBarOffset + 2 * kStages * 8 + 1024;  // + alignment
constexpr long long kWaitLimitNs = 2000000000ll;
static_assert(kStages >= 2, "at least two stages");
static_assert(kSmem <= 232448, "more shared memory than a block may have");
static_assert(kABoxRows % 8 == 0 && kWBoxRows % 8 == 0,
              "a share is whole 8-row swizzle groups (1024 bytes)");
// no setmaxnreg: launch bound kThreads x 1 leaves every thread up to 255 registers, more
// than the kBN / 2 accumulators need
static_assert(kBN / 2 + 64 <= 65536 / kThreads, "the accumulators need more registers");

struct Params {
  __nv_bfloat16* out[2];  // the ping-pong buffers, [M, K] contiguous
  int* counters;          // [panels]: tiles of each row panel finished, all blocks so far
  int m, k, blocks, panels, col_tiles, units_n, n_units;
};

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Spins until *count >= target (acquire, gpu scope); traps after kWaitLimitNs.
__device__ __forceinline__ void wait_count(const int* count, int target) {
  if (ld_acquire_gpu(count) >= target) return;
  const long long t0 = global_ns();
  while (ld_acquire_gpu(count) < target)
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}

__global__ void __launch_bounds__(kThreads, 1)
gemm_sweep_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap map0,
                  const __grid_constant__ CUtensorMap map1,
                  const __grid_constant__ CUtensorMap wmap, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kBarOffset);
  uint64_t* empty = full + kStages;
  const int n_k = p.k / kBK;
  const int warp = warp_uniform_index(), lane = threadIdx.x % 32;
  // this block's place in its cluster and the cluster's place in the grid
  const int rank = static_cast<int>(cluster_ctarank());
  const int cm = rank % kCM, cn = rank / kCM;
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kPeers);  // every consumer warp of every peer
    }
    fence_barrier_init();
  }
  cluster_sync();  // peers' barriers are ready before any multicast

  // Work unit u (clusters walk u = cluster, cluster + clusters, ...) is kCM row panels x kCN
  // column tiles; this block's tile in it is (panel, col).
  auto tile_of = [&](int u, int& panel, int& col) {
    panel = (u / p.units_n) * kCM + cm;
    col = (u % p.units_n) * kCN + cn;
  };

  if (warp == 4) {
    // ---- producer: per tile, the weight halves of its first stages, the flag, the rest ----
    if (lane == 0) {
      uint16_t row_mask = 0, col_mask = 0;  // peers sharing this block's x / weight slabs
      for (int j = 0; j < kCN; ++j) row_mask |= static_cast<uint16_t>(1 << (cm + kCM * j));
      for (int i = 0; i < kCM; ++i) col_mask |= static_cast<uint16_t>(1 << (i + kCM * cn));
      int pos = 0;  // ring position of the tile's first stage
      for (int b = 0; b < p.blocks; ++b) {
        // block b reads x (b = 0) or buf[(b - 1) % 2]
        const CUtensorMap* amap = b == 0 ? &xmap : (b % 2 ? &map0 : &map1);
        for (int u = cluster; u < p.n_units; u += clusters, pos += n_k) {
          int panel, col;
          tile_of(u, panel, col);
          const bool rows = panel < p.panels;  // x rows to load (a row group shares it)
          const int n0 = col * kBN;
          const int w_slabs = col < p.col_tiles ? min(kWSlabs, (p.k - n0) / 64) : 0;
          const uint32_t bytes = (rows ? kABytes : 0) + w_slabs * kSlabBytes;
          auto load_w = [&](int j) {
            const int s = (pos + j) % kStages, round = (pos + j) / kStages;
            if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
            mbar_arrive_expect_tx(&full[s], bytes);
            uint8_t* ws = ring + s * kStageBytes + kABytes + cm * kWBoxRows * 128;
            const int k0 = kBK * j + cm * kWBoxRows;
            for (int c = 0; c < w_slabs; ++c)
              tma_load_4d_multicast(ws + c * kSlabBytes, &wmap, &full[s], col_mask,
                                    n0 + 64 * c, 0, k0, b);
          };
          auto load_x = [&](int j) {
            const int s = (pos + j) % kStages;
            uint8_t* xs = ring + s * kStageBytes + cn * kABoxRows * 128;
            const int r0 = panel * kBM + cn * kABoxRows;
            tma_load_4d_multicast(xs, amap, &full[s], row_mask, kBK * j, 0, r0, 0);
          };
          const int ahead = min(kStages, n_k);
          for (int j = 0; j < ahead; ++j) load_w(j);
          if (rows && b > 0) {  // every tile of the panel has finished block b - 1
            wait_count(&p.counters[panel], b * p.col_tiles);
            fence_proxy_async_global();
          }
          for (int j = 0; j < ahead; ++j)
            if (rows) load_x(j);
          for (int j = ahead; j < n_k; ++j) {
            load_w(j);
            if (rows) load_x(j);
          }
        }
      }
      // Stay until every peer has released the last use of every stage: their arrivals on
      // this block's barriers must land before its shared memory goes.
      for (int q = max(0, pos - kStages); q < pos; ++q)
        mbar_wait(&empty[q % kStages], (q / kStages) & 1);
    }
    return;
  }

  // ---- consumers: one warpgroup owns the tile's 64 rows ----
  const int tid = threadIdx.x;
  auto release = [&](int s) {  // this warp is done with stage s, in every peer's ring
    __syncwarp();
    if (lane == 0) {
      for (int j = 0; j < kCN; ++j) mbar_arrive_cluster(&empty[s], cm + kCM * j);
      for (int i = 0; i < kCM; ++i)
        if (i != cm) mbar_arrive_cluster(&empty[s], i + kCM * cn);
    }
  };
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  int pos = 0;
  for (int b = 0; b < p.blocks; ++b) {
    __nv_bfloat16* out = p.out[b % 2];
    for (int u = cluster; u < p.n_units; u += clusters) {
      int panel, col;
      tile_of(u, panel, col);
      const int n0 = col * kBN;
      for (int kt = 0; kt < n_k; ++kt, ++pos) {
        const int s = pos % kStages;
        mbar_wait(&full[s], (pos / kStages) & 1);
        const uint32_t a = smem_u32(ring + s * kStageBytes);
        const uint32_t w = smem_u32(ring + s * kStageBytes + kABytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)  // 32 bytes of x, 16 k-rows of w a k-step
          wgmma_ss_tb<kBN>(acc, desc_sw128(a + 32 * kk, 16, 1024),
                           desc_sw128(w + kk * 16 * 128, kSlabBytes, 1024), kt > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the stage before has retired
        if (kt > 0) release((pos - 1) % kStages);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) fence_regs(acc[i]);
      release((pos - 1) % kStages);
      if (panel >= p.panels || col >= p.col_tiles) continue;  // a tile past M or K

      const int row = panel * kBM + 16 * (tid / 32) + (tid % 32) / 4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row + 8 * r >= p.m) continue;
        __nv_bfloat16* orow = out + static_cast<int64_t>(row + 8 * r) * p.k + n0 + 2 * (tid % 4);
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          if (n0 + 8 * j < p.k)
            *reinterpret_cast<uint32_t*>(orow + 8 * j) =
                pack_bf16(tanhf(acc[4 * j + 2 * r]), tanhf(acc[4 * j + 2 * r + 1]));
        }
      }
      fence_proxy_async_global();
      named_sync(1, kConsumers);
      if (threadIdx.x == 0) red_release_gpu_add(&p.counters[panel], 1);
    }
  }
}

int launch(const void* x, const void* w, void* buf0, void* buf1, int* counters, int m, int k,
           int blocks, int64_t x_ld, int64_t w_sb, int64_t w_sk, cudaStream_t stream) {
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = kCluster;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;

  static bool ready[64] = {};
  static int resident[64] = {};  // clusters the card holds at once
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[device]) {
    err = cudaFuncSetAttribute(gemm_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err == cudaSuccess) {
      cfg.gridDim = dim3(kCluster);
      err = cudaOccupancyMaxActiveClusters(&resident[device], gemm_sweep_kernel, &cfg);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident[device] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    ready[device] = true;
  }
  if (buf1 == nullptr) buf1 = buf0;  // one block: buf1 is never read
  // x and the buffers as [1, M, 1, K] in boxes of a block's share of kBM rows x 64 columns;
  // w as [blocks, K rows, 1, K columns] in boxes of a share of 64 rows x 64 columns: its
  // columns past K are never read
  CUtensorMap xm, m0, m1, wm;
  int e = hopper_host::tensor_map(&xm, x, 1, m, 1, k, m * x_ld, x_ld, k, kABoxRows);
  if (e == 0)
    e = hopper_host::tensor_map(&m0, buf0, 1, m, 1, k, int64_t(m) * k, k, k, kABoxRows);
  if (e == 0)
    e = hopper_host::tensor_map(&m1, buf1, 1, m, 1, k, int64_t(m) * k, k, k, kABoxRows);
  if (e == 0) e = hopper_host::tensor_map(&wm, w, blocks, k, 1, k, w_sb, w_sk, k, kWBoxRows);
  if (e != 0) return e;
  Params p;
  p.out[0] = static_cast<__nv_bfloat16*>(buf0);
  p.out[1] = static_cast<__nv_bfloat16*>(buf1);
  p.counters = counters;
  p.m = m;
  p.k = k;
  p.blocks = blocks;
  p.panels = (m + kBM - 1) / kBM;
  p.col_tiles = (k + kBN - 1) / kBN;
  p.units_n = (p.col_tiles + kCN - 1) / kCN;
  p.n_units = (p.panels + kCM - 1) / kCM * p.units_n;
  err = cudaMemsetAsync(counters, 0, p.panels * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3((p.n_units < resident[device] ? p.n_units : resident[device]) * kCluster);
  err = cudaLaunchKernelEx(&cfg, gemm_sweep_kernel, xm, m0, m1, wm, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry, bound with ctypes. x: bf16 [m, k] with row stride x_ld; w: bf16 [blocks, k,
// >= k] with strides (w_sb, w_sk) and a unit last stride; buf0, buf1: bf16 [m, k] contiguous
// (buf1 may be null when blocks is 1); counters: int32 scratch of ceil(m / 64) entries, which
// the call zeroes on `stream` first. Every pointer must be 16-byte aligned, every stride a
// multiple of 8 and k a multiple of 64 (the wrapper checks). One cooperative launch on
// `stream` computes the whole sweep: block b reads x (b = 0) or buf[(b - 1) % 2] and writes
// buf[b % 2], so the result is in buf[(blocks - 1) % 2]. Returns cudaGetLastError() (0 on
// success), -1 when the driver cannot describe an operand as a tensor map, -2 when its
// encoder is not reachable.
extern "C" int gemm_sweep_bf16(const void* x, const void* w, void* buf0, void* buf1,
                               int* counters, int m, int k, int blocks, int64_t x_ld,
                               int64_t w_sb, int64_t w_sk, void* stream) {
  if (m < 1 || k < kBK || k % kBK || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, w, buf0, buf1, counters, m, k, blocks, x_ld, w_sb, w_sk,
                static_cast<cudaStream_t>(stream));
}
