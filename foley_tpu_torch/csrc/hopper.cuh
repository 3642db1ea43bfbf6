// Hopper (sm_90a) primitives shared by the port's kernels, K1 (fused_qk_attention.cu), K2
// (flash_attention.cu), their fp32 variants (attention_f32.cu) and K3 (gemm_sweep.cu), as raw
// inline PTX:
//  * mbarriers: init, arrive, arrive with an expected transaction count, parity wait;
//  * TMA tile loads (cp.async.bulk.tensor.4d) completing on an mbarrier, and the host-side
//    encoding of a 4-D tensor map over a [B, L, H, D] bf16 or fp16 operand read through its
//    strides, with the 128-byte swizzle that wgmma reads;
//  * wgmma: fence / commit / wait, the shared-memory matrix descriptor for 128-byte swizzled
//    tiles, and mma_async for the shapes and the 16-bit types (bf16, fp16) the kernels issue,
//    and in tf32 (the fp32 kernels' 3xTF32 products) with the rounding of fp32 to tf32;
//  * gpu-scope release / acquire and the global async-proxy fence, for a flag that one block
//    raises after its stores and another waits on before it loads that memory by TMA;
//  * clusters: rank, cluster-wide barrier, remote mbarrier arrival, multicast TMA loads;
//  * fence.proxy.async.shared::cta, for tiles that threads write and wgmma then reads;
//  * setmaxnreg, and named barriers;
//  * the consumer warpgroup of a flash-attention block: its software-pipelined main loop
//    (S = Q K^T and O += P V by wgmma, the online softmax in registers between them) and
//    the store of the normalised output, for bf16 and fp16 operands alike (Elem<T>).
//
// Shared-memory tile layout. A tile of R rows x 64 16-bit columns (128 bytes a row) is what one
// TMA box with CU_TENSOR_MAP_SWIZZLE_128B writes: row r at r * 128, its 16-byte chunk c at
// ((c ^ (r % 8)) * 16) inside the row, the tile 1024-byte aligned. A head of 128 columns is
// two such slabs, one after the other. Read as a wgmma operand:
//  * K-major (the reduction runs along the 64 columns: Q and K in S = Q K^T): SBO 1024 bytes
//    (the stride of 8-row groups), LBO unused; k-step kk of 16 columns starts 32 * kk bytes
//    into the slab;
//  * MN-major (the reduction runs along the rows: V in O += P V, transposed by the
//    descriptor): SBO 1024 bytes (8 keys), LBO the slab stride (the next 64 columns of N); a
//    k-step of 16 keys starts 16 * 128 bytes further.
//
// wgmma accumulator layout (m64nN, fp32): thread t of the warpgroup holds rows
// 16 * (t / 32) + (t % 32) / 4 and that + 8, and for each n8 block j the columns
// 8 j + 2 (t % 4) + {0, 1}: d[4 j + 0, 1] on the first row, d[4 j + 2, 3] on the second. A
// 16-bit A operand from registers (m64k16) has the same layout as two n8 blocks of it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace hopper {

// ---- mbarriers ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and the other threads.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Blocks until the barrier's phase of parity `parity` has completed. The spin stays inside
// the asm block (its labels are local to it), so the compiler sees no divergent loop around
// the wgmma that follow.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The warp's index, as a value the compiler knows to be the same across the warp, so a
// branch on it is not a divergent path (wgmma after a divergent path is serialised).
__device__ __forceinline__ int warp_uniform_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
}

// Orders this thread's generic-proxy shared-memory writes before later async-proxy reads
// (wgmma, TMA) of the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- TMA ----

// Loads the box at coordinates (c0, c1, c2, c3), innermost first, of a 4-D tensor map into
// shared memory at `dst`; its bytes complete a transaction on `bar`. Out-of-bounds elements
// are written as zeros and still count.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- wgmma ----

// Descriptor of a 128-byte swizzled operand in shared memory (layout type 1), with its
// leading and stride byte offsets.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Moves registers between warpgroups: the warpgroup's threads may use up to N registers
// from here on (inc waits until others have released enough).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `n` threads: sync waits until n
// threads have arrived, counting its own warp; arrive counts without waiting.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across a wgmma wait.
__device__ __forceinline__ void fence_regs(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (64 x N fp32, N / 2 registers a thread) = A (64 x 16, K-major in shared memory) *
// B (16 x N: N rows of 16, K-major in shared memory) + (scale_d ? d : 0); A and B of the
// 16-bit type T, bf16 or fp16 (the tensor cores take both at one rate).
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int scale_d);

// d (64 x N fp32) += A (64 x 16 of T from registers, four 32-bit registers a thread) * B
// (16 x N, MN-major in shared memory: read transposed), scaled by scale_d as above.
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_tb(float* d, const uint32_t* a, uint64_t b,
                                            int scale_d);

// The accumulator operands of an m64n64 / m64n128 wgmma and their places in the PTX.
#define HOPPER_ACC64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOPPER_ACC128 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_REGS64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}, "
#define HOPPER_REGS128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63}, "

// wgmma_ss and wgmma_rs_tb for N 64 and 128 and the element type T, whose PTX name is PTX.
#define HOPPER_WGMMA_FOR(T, PTX)                                                            \
  template <>                                                                               \
  __device__ __forceinline__ void wgmma_ss<64, T>(float* d, uint64_t a, uint64_t b,         \
                                                  int scale_d) {                            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                               \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " {"             \
                 HOPPER_REGS64 "%32, %33, p, 1, 1, 0, 0;\n}\n"                              \
                 : HOPPER_ACC64                                                             \
                 : "l"(a), "l"(b), "r"(scale_d));                                           \
  }                                                                                         \
  template <>                                                                               \
  __device__ __forceinline__ void wgmma_ss<128, T>(float* d, uint64_t a, uint64_t b,        \
                                                   int scale_d) {                           \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                               \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " {"            \
                 HOPPER_REGS128 "%64, %65, p, 1, 1, 0, 0;\n}\n"                             \
                 : HOPPER_ACC128                                                            \
                 : "l"(a), "l"(b), "r"(scale_d));                                           \
  }                                                                                         \
  template <>                                                                               \
  __device__ __forceinline__ void wgmma_rs_tb<64, T>(float* d, const uint32_t* a,           \
                                                     uint64_t b, int scale_d) {             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                               \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " {"             \
                 HOPPER_REGS64 "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                \
                 : HOPPER_ACC64                                                             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));       \
  }                                                                                         \
  template <>                                                                               \
  __device__ __forceinline__ void wgmma_rs_tb<128, T>(float* d, const uint32_t* a,          \
                                                      uint64_t b, int scale_d) {            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                               \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " {"            \
                 HOPPER_REGS128 "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"               \
                 : HOPPER_ACC128                                                            \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));       \
  }

HOPPER_WGMMA_FOR(__nv_bfloat16, "bf16")
HOPPER_WGMMA_FOR(__half, "f16")
#undef HOPPER_WGMMA_FOR

// ---- wgmma in tf32 (the fp32 attention kernels' 3xTF32 products) ----
//
// A tf32 operand is an fp32 bit pattern whose low 13 bits are zero (tf32_rna): the tensor
// cores read 1 + 10 bits of mantissa and multiply exactly into fp32. A k-step is 8 elements,
// 32 bytes: the same span as a 16-bit k16 step, so a 128-byte swizzled row holds four k-steps
// and desc_sw128 advances along K by 32 bytes, as for bf16. PTX allows no transpose for tf32:
// both operands are K-major. The A fragment from registers (m64k8, one tf32 a register):
// thread t holds rows r = 16 (t / 32) + (t % 32) / 4 and r + 8, columns c = t % 4 and c + 4,
// as a[0] (r, c), a[1] (r + 8, c), a[2] (r, c + 4), a[3] (r + 8, c + 4).

// x rounded to tf32, to nearest with ties away from zero, as an fp32 bit pattern: what
// cvt.rna.tf32.f32 returns for finite x (half a tf32 step added to the magnitude's bits, the
// low 13 bits cleared; a carry into the exponent is the right result). On sm_90 the cvt
// compiles to a compare-and-select sequence; this is two integer instructions.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// d (64 x N fp32) = A (64 x 8 tf32, K-major in shared memory) * B (8 x N: N rows of 8,
// K-major in shared memory) + (scale_d ? d : 0).
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float* d, uint64_t a, uint64_t b, int scale_d);

// d (64 x N fp32) += A (64 x 8 tf32 from registers, the fragment above) * B (8 x N, K-major
// in shared memory), scaled by scale_d as above.
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float* d, const uint32_t* a, uint64_t b,
                                              int scale_d);

#define HOPPER_ACC32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HOPPER_REGS32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15}, "

template <>
__device__ __forceinline__ void wgmma_ss_tf32<32>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
               HOPPER_REGS32 "%16, %17, p, 1, 1;\n}\n"
               : HOPPER_ACC32
               : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_tf32<64>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
               HOPPER_REGS64 "%32, %33, p, 1, 1;\n}\n"
               : HOPPER_ACC64
               : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<64>(float* d, const uint32_t* a, uint64_t b,
                                                  int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
               HOPPER_REGS64 "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : HOPPER_ACC64
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<128>(float* d, const uint32_t* a, uint64_t b,
                                                   int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
               HOPPER_REGS128 "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
               : HOPPER_ACC128
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x N fp32) = A (64 x 16, K-major in shared memory) * B (16 x N, MN-major in shared
// memory: read transposed, as wgmma_rs_tb reads it) + (scale_d ? d : 0).
template <int N>
__device__ __forceinline__ void wgmma_ss_tb(float* d, uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss_tb<192>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(scale_d));
}

// ---- ordering across blocks (gpu scope) ----

// Orders this thread's generic-proxy global writes before later async-proxy (TMA) accesses
// of the same memory, in this block or, after a release and an acquire, in another.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Adds v to *p with release semantics at gpu scope: writes that precede it (in this thread,
// or in threads that synchronised with it through a barrier) are visible to a thread that
// acquires the new value.
__device__ __forceinline__ void red_release_gpu_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// ---- thread-block clusters ----

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: what each did before (barrier inits included)
// is visible to all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// Arrives on the mbarrier at `bar`'s offset in the shared memory of the cluster's block
// `cta` (this block's own when cta is its rank), with the default release at cta scope: it
// tells a peer's producer that this block's wgmma have retired their reads of a stage.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// tma_load_4d into `dst` of every block of the cluster whose rank is set in `mask`; the bytes
// complete a transaction on the mbarrier at `bar`'s offset in each of them.
__device__ __forceinline__ void tma_load_4d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, uint16_t mask, int c0,
                                                      int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---- the consumer warpgroup of a flash-attention block ----

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 p = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// The 16-bit element types of the attention kernels, bf16 and fp16: the pair type a thread
// reads, and two floats rounded to nearest and packed into 32 bits.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return pack_bf16(lo, hi); }
};

template <>
struct Elem<__half> {
  using Pair = __half2;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return pack_f16(lo, hi); }
};

// 2^x on the special-function unit alone, denormal results flushed to zero (exp2f adds a
// range check and two multiplies around it). The softmax feeds it x <= 0, so p in [0, 1]
// loses only values below 2^-126 of the row's largest.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax update of a 64 x N block of raw fp32 logits `s` (wgmma accumulator
// layout): keys at or past `valid` (counted from the block's first key) get -inf; the
// running max `m` (raw-logit units) and this thread's share of the running sums `l` of its
// two rows are updated; `s` becomes p = exp(s * scale - max); `alpha` is the factor the
// output accumulated so far must be rescaled by. A row whose max is still -inf uses 0 as its
// exponent base, so exp(-inf - -inf) never produces NaN.
template <int N>
__device__ __forceinline__ void softmax_update(float* s, float* m, float* l, float* alpha,
                                               int valid, float scale_log2) {
  const int t4 = threadIdx.x % 4;
  if (valid < N) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int key = 8 * j + 2 * t4;
      if (key >= valid) s[4 * j] = s[4 * j + 2] = -CUDART_INF_F;
      if (key + 1 >= valid) s[4 * j + 1] = s[4 * j + 3] = -CUDART_INF_F;
    }
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    base[r] = (m_new == -CUDART_INF_F) ? 0.f : m_new * scale_log2;
    alpha[r] = exp2_ftz(m[r] * scale_log2 - base[r]);  // 0 while m is -inf
    m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    s[4 * j] = exp2_ftz(s[4 * j] * scale_log2 - base[0]);
    s[4 * j + 1] = exp2_ftz(s[4 * j + 1] * scale_log2 - base[0]);
    s[4 * j + 2] = exp2_ftz(s[4 * j + 2] * scale_log2 - base[1]);
    s[4 * j + 3] = exp2_ftz(s[4 * j + 3] * scale_log2 - base[1]);
    rs[0] += s[4 * j] + s[4 * j + 1];
    rs[1] += s[4 * j + 2] + s[4 * j + 3];
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// p (the 64 x N block `s`) in T as N / 16 wgmma A fragments, one a k-step of 16 keys.
template <int N, typename T>
__device__ __forceinline__ void pack_p(const float* s, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const float* s0 = s + 8 * kk;
    a[kk][0] = Elem<T>::pack(s0[0], s0[1]);
    a[kk][1] = Elem<T>::pack(s0[2], s0[3]);
    a[kk][2] = Elem<T>::pack(s0[4], s0[5]);
    a[kk][3] = Elem<T>::pack(s0[6], s0[7]);
  }
}

// The main loop of one consumer warpgroup of a flash-attention block: 64 query rows of Q
// (swizzled, `q_slab` bytes between its 64-column slabs) against the K/V tiles of a ring of
// STAGES stages of BN keys (stage s: K at ring + s * 2 * tile bytes, V after it, each tile
// D / 64 slabs of BN rows). `pos` is the ring position of the first tile (the tiles the
// ring has carried before); tile t sits at position pos + t, in stage (pos + t) % STAGES.
// It waits on kbar[stage] (K ready to read) and vbar[stage] (V landed), and the
// warpgroup's 128 threads arrive on empty[stage] once both products on it are done. Software-pipelined: S of tile t + 1 is issued before the softmax of tile t, and
// P V of tile t runs while that softmax does, so the tensor cores and the exponentials
// overlap inside the warpgroup. With GROUPS > 1 the warpgroups `wg` 0 .. GROUPS - 1 of a
// block also take turns, in that order, to issue their products (named barrier 1 + wg is
// wg's turn), so that one's softmax runs while another's products do. Q, K, V and p are of
// the 16-bit type T. Returns o (D / 2 registers, unnormalised) and l.
template <int D, int BN, int STAGES, int GROUPS, typename T>
__device__ __forceinline__ void attention_consumer(uint32_t q_addr, uint32_t q_slab,
                                                   uint32_t ring, uint64_t* kbar,
                                                   uint64_t* vbar, uint64_t* empty, int lk,
                                                   float scale_log2, int pos, int wg,
                                                   float* o, float* l) {
  static_assert(GROUPS >= 1 && GROUPS <= 4, "named barriers 1..GROUPS take the turns");
  constexpr uint32_t kTile = BN * D * 2;
  const int n_tiles = (lk + BN - 1) / BN;
  float s[BN / 2];
  uint32_t pa[BN / 16][4];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float alpha[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  l[0] = l[1] = 0.f;

  auto issue_s = [&](int t) {  // S = Q K_t^T, D / 16 k-steps
    const int st = (pos + t) % STAGES;
    const uint32_t k_addr = ring + st * 2 * kTile;
    mbar_wait(&kbar[st], ((pos + t) / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // slab kk / 4, 32 bytes a k-step inside it
      wgmma_ss<BN, T>(s, desc_sw128(q_addr + (kk / 4) * q_slab + off, 16, 1024),
                   desc_sw128(k_addr + (kk / 4) * BN * 128 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int t) {  // O += P V_t, BN / 16 k-steps, V transposed by its descriptor
    const int st = (pos + t) % STAGES;
    const uint32_t v_addr = ring + st * 2 * kTile + kTile;
    mbar_wait(&vbar[st], ((pos + t) / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_tb<D, T>(o, pa[kk], desc_sw128(v_addr + kk * 16 * 128, BN * 128, 1024), 1);
    wgmma_commit();
  };

  auto turn_begin = [&] {
    if (GROUPS > 1) named_sync(1 + wg, 256);
  };
  auto turn_end = [&] {  // hand the turn to the next group
    if (GROUPS > 1) named_arrive(1 + (wg + 1) % GROUPS, 256);
  };
  if (GROUPS > 1 && wg == GROUPS - 1) named_arrive(1, 256);  // group 0 issues first

  turn_begin();
  issue_s(0);
  turn_end();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_regs(s[i]);
  softmax_update<BN>(s, m, l, alpha, lk, scale_log2);
  pack_p<BN, T>(s, pa);
  for (int t = 1; t < n_tiles; ++t) {
    turn_begin();
    issue_s(t);
    issue_pv(t - 1);
    turn_end();
    wgmma_wait<1>();  // S of tile t is done; P V of tile t - 1 may still run
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_regs(s[i]);
    softmax_update<BN>(s, m, l, alpha, lk - t * BN, scale_log2);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_regs(o[i]);
    mbar_arrive(&empty[(pos + t - 1) % STAGES]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    pack_p<BN, T>(s, pa);
  }
  turn_begin();
  issue_pv(n_tiles - 1);
  turn_end();
  if (GROUPS > 1 && wg == 0) named_sync(1, 256);  // the last group's last turn_end
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < D / 2; ++i) fence_regs(o[i]);
  mbar_arrive(&empty[(pos + n_tiles - 1) % STAGES]);
}

// o / l in T to rows [row0, row0 + 64) of `out` (element strides: row `sl`, unit
// columns); rows at or past `len` are not stored.
template <int D, typename T>
__device__ __forceinline__ void store_rows(const float* o, float* l, T* out, int64_t sl,
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
    T* orow = out + static_cast<int64_t>(row) * sl + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          Elem<T>::pack(o[4 * j + 2 * r] * l[r], o[4 * j + 2 * r + 1] * l[r]);
    }
  }
}

}  // namespace hopper

// ---- host: tensor maps ----

namespace hopper_host {

// The tensor-map element type of a 16-bit element type.
template <typename T>
inline CUtensorMapDataType map_type();
template <>
inline CUtensorMapDataType map_type<__nv_bfloat16>() { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }
template <>
inline CUtensorMapDataType map_type<__half>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT16; }

// Error codes the kernels' C entries return beside cudaError values.
constexpr int kErrTensorMap = -1;   // the driver cannot describe an operand as a tensor map
constexpr int kErrNoEncoder = -2;   // cuTensorMapEncodeTiled is not reachable

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's encoder, through the runtime's entry-point query (no link against libcuda).
inline EncodeTiledFn encoder() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A [B, L, H, D] operand of 16-bit elements of `type` (bf16 unless given; fp16) as a 4-D
// tensor map (D, H, L, B innermost first) over its element strides (sb, sl, sh, unit on D),
// with boxes of 64 columns x 1 head x `rows` rows x 1 batch row and the 128-byte swizzle. Maps are cached by everything they encode, so a
// hit is the map the encoder would return; PyTorch's allocator hands the same addresses
// back from step to step. Returns 0, kErrTensorMap or kErrNoEncoder.
inline int tensor_map(CUtensorMap* map, const void* ptr, int64_t batch, int64_t len,
                      int64_t heads, int64_t dim, int64_t sb, int64_t sl, int64_t sh,
                      uint32_t rows,
                      CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  struct Entry {
    int64_t key[10];
    CUtensorMap map;
  };
  constexpr int kSlots = 64;
  static Entry cache[kSlots];
  static bool used[kSlots];
  static std::mutex lock;
  const int64_t key[10] = {reinterpret_cast<int64_t>(ptr), batch, len, heads, dim, sb, sl, sh,
                           rows, static_cast<int64_t>(type)};
  uint64_t h = 1469598103934665603ull;
  for (int64_t k : key) h = (h ^ static_cast<uint64_t>(k)) * 1099511628211ull;
  const int slot = static_cast<int>(h % kSlots);
  {
    std::lock_guard<std::mutex> g(lock);
    if (used[slot] && memcmp(cache[slot].key, key, sizeof(key)) == 0) {
      *map = cache[slot].map;
      return 0;
    }
  }
  EncodeTiledFn enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, type, 4, const_cast<void*>(ptr), dims,
                         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kErrTensorMap;
  std::lock_guard<std::mutex> g(lock);
  memcpy(cache[slot].key, key, sizeof(key));
  cache[slot].map = *map;
  used[slot] = true;
  return 0;
}

}  // namespace hopper_host
