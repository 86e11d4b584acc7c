// Hopper (sm_90a) primitives shared by the port's kernels: mbarriers, TMA
// loads and stores, the 128-byte swizzle, wgmma, and the host-side tensor
// maps. Included by flash_fwd.cu, flash_bwd.cu and ring_fwd.cu; each source
// is its own library, so everything here has internal linkage.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// --- mbarriers, TMA and bulk copies -----------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Adds `bytes` to the transactions the current phase waits for, without
// arriving.
__device__ __forceinline__ void mbar_add_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the phase of the given parity; a wait of more than 5 s is a
// protocol fault and traps (the launch then fails) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint64_t start = 0;
  for (uint32_t spin = 1;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023) == 0) {
      const uint64_t now = global_ns();
      if (start == 0) {
        start = now;
      } else if (now - start > 5000000000ull) {
        __trap();
      }
    }
  }
}

// A box of a 4-D tensor map with coordinates (c0, c1, c2, c3), loaded into
// shared memory (completion on `bar`) or stored from it (a bulk group of
// the issuing thread).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// A tile of one (b, h) from a tensor map over (d, head, seq, batch).
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, int h, int row, int b,
                                         uint64_t* bar) {
  tma_load_4d(dst, map, 0, h, row, b, bar);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The issuing thread's bulk stores: done reading shared memory (`.read`),
// or complete, their writes performed in global memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Orders the generic and async proxies on global memory: after a TMA
// store's wait_group, before releasing it by a flag; after acquiring a
// flag, before a TMA load of what it guards.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// --- wgmma -------------------------------------------------------------------

// Descriptor of a 64 x 64 bf16 tile written with the 128-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B, or st_sw128): rows of 128 bytes, 8-row groups
// 1024 bytes apart. Read K-major (rows are M or N, a 16-deep k step is +32
// bytes) or MN-major (rows are k, a k step is +2048 bytes).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

constexpr uint64_t kKStepKMajor = 32 >> 4;
constexpr uint64_t kKStepMNMajor = (16 * 128) >> 4;

// (row, col), col even, of a 64 x 64 bf16 tile in the 128-byte swizzle.
__device__ __forceinline__ void st_sw128(__nv_bfloat16* tile, int row, int col, uint32_t v) {
  char* p = reinterpret_cast<char*>(tile) + row * 128 + (((col >> 3) ^ (row & 7)) << 4) +
            (col & 7) * 2;
  *reinterpret_cast<uint32_t*>(p) = v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a wait.
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_ACC32                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WGMMA_D32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B, m64 n64 k16, A and B from shared memory; kTA / kTB = 1 reads
// that operand MN-major.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WGMMA_ACC32
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTA), "n"(kTB));
}

// d (+)= A B, m64 n64 k16, A from registers (the m16n8k16 A fragment of
// each warp's 16 rows: a[0] row g, columns 2t, 2t + 1; a[1] row g + 8; a[2]
// and a[3] the same at columns + 8; g = lane / 4, t = lane % 4), B from
// shared memory; kTB = 1 reads B MN-major.
template <int kTB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WGMMA_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTB));
}

// d (+)= A B, m64 n128 k16, both K-major from shared memory (64 keys of
// scores more per instruction than the n64 form).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// --- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The CUDA driver API's cuTensorMapEncodeTiled, reached through the
// runtime, so that the library links against nothing but the CUDA runtime.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
  }
  return fn;
}

// A 4-D bf16 map with the 128-byte swizzle; dims[0] = 64 is the contiguous
// head dim, bytes[] the strides of dims 1..3. Boxes read past a dimension's
// end arrive as zeros; stores past it are dropped.
bool bf16_map(EncodeTiledFn encode, CUtensorMap* map, const void* base, const cuuint64_t dims[4],
              const cuuint64_t bytes[3], const cuuint32_t box[4]) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, bytes,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [B, L, H, 64] bf16 tensor seen as (d, head, seq, batch) through its
// (batch, seq, head) element strides, read in boxes of one head's `rows`
// rows x 64; rows past L read as zeros.
bool seq_map(EncodeTiledFn encode, CUtensorMap* map, const void* base, const int64_t strides[3],
             int batch, int seq_len, int heads, int rows) {
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq_len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return bf16_map(encode, map, base, dims, bytes, box);
}

}  // namespace
