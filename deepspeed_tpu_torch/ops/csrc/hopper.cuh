// Hopper (sm_90a) building blocks shared by the tensor-core kernels of
// grouped_matmul.cu (gmm, gmm^T, tgmm), flash_attention.cu (the forward,
// dK/dV and dQ), blocksparse_attention.cu and paged_attention.cu (the
// last two and the flash forward also through attention_tc.cuh):
// mbarriers, TMA tile loads (2-D to 4-D) into 128-byte-swizzled shared
// memory, wgmma shared-memory descriptors, the wgmma wrappers (fp32 +=
// bf16 x bf16 at n64, n128 and n256; both operands from shared memory, or
// A from registers), the warpgroup register hand-over (setmaxnreg), and
// the host-side tensor-map encoder. Header only; every name lives in
// namespace tc.
//
// Swizzled operand layouts (128-byte swizzle: a row of 64 bf16 is one
// 128-byte swizzle row, eight rows one 1024-byte atom):
//   K-major (the contraction dim contiguous: A of gmm, B of gmm^T, Q and
//     K of the flash forward): rows of 64 k, 8-row groups SBO = 1024
//     bytes apart; the k16 step moves the start address 32 bytes along
//     the row. Descriptor LBO 16 (unused), SBO 1024; transpose 0.
//   MN-major (the output dim contiguous: B of gmm, A and B of tgmm, V of
//     the flash forward): boxes of [k rows][64 columns], 8-row k groups
//     SBO = 1024 bytes apart, 64-column boxes LBO bytes apart; the k16
//     step moves the start address 16 rows (2048 bytes) down. Transpose 1.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (header only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// that lasts ~10 s (a copy that never lands) traps: the launch then fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
}

// a barrier among `threads` threads (whole warps) of the block: the
// consumer warpgroups sync on ids >= 1 while the producer runs on
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// this warp's arrival at named barrier `id` without waiting: a producer
// of the turn that warps waiting in named_barrier(id, threads) take
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Warpgroup register hand-over (sm_90a only, like wgmma): every warp of a
// warpgroup executes it together, on a path that never rejoins the other
// warpgroups'. A producer warpgroup gives registers up (dec) and the
// consumer warpgroups take them (inc); inc waits until the block's pool
// holds enough, so the counts must balance against the launch bound's.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// makes this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma operand reads, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared -> global through a tensor map; out-of-bounds parts of the box
// are not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  // the source shared memory may be reused (and the block exit) once the
  // copies have read it
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1
// (128B swizzle) in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
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

// keeps the compiler from moving accumulator accesses across a wgmma wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TC_F8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TC_F32(d, i) \
  TC_F8(d, i), TC_F8(d, i + 8), TC_F8(d, i + 16), TC_F8(d, i + 24)
#define TC_F64(d, i)                                                  \
  TC_F8(d, i), TC_F8(d, i + 8), TC_F8(d, i + 16), TC_F8(d, i + 24),   \
      TC_F8(d, i + 32), TC_F8(d, i + 40), TC_F8(d, i + 48),           \
      TC_F8(d, i + 56)
#define TC_OPS_0_31                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31"
#define TC_OPS_0_63                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define TC_OPS_64_127                                                 \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "   \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "   \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "      \
  "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, "  \
  "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "  \
  "%124, %125, %126, %127"

// d (64 x N fp32, the m64nNk16 fragment; N = 64, 128 or 256 by the size
// of d) += A (64 x 16) x B (16 x N), both from shared memory; A K-major
// (TRANS_A 0) or M-major (1), B K-major
// (TRANS_B 0) or N-major (1). Fragment: thread (warp w, lane l) of the
// warpgroup holds rows 16 w + l / 4 (+ 8) and, in each 8-column group j,
// columns 8 j + 2 (l % 4) (+ 1): d[4 j + 2 h + e] is row + 8 h, column
// 8 j + 2 (l % 4) + e.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" TC_OPS_0_31
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : TC_F32(d, 0)
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" TC_OPS_0_63
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : TC_F64(d, 0)
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" TC_OPS_0_63
      ", " TC_OPS_64_127 "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : TC_F64(d, 0), TC_F64(d, 64)
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// d (64 x 128 fp32) += A (64 x 16 bf16 from registers) x B (16 x 128 from
// shared memory; K-major, or N-major with TRANS_B = 1). A's fragment, four
// bf16x2 words: a[0] row r, columns 2 (l % 4) (+ 1); a[1] row r + 8, the
// same columns; a[2] and a[3] the same rows 8 columns on (r = 16 w + l /
// 4). The lower half of a word holds the lower column.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" TC_OPS_0_63
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : TC_F64(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TRANS_B));
}

#undef TC_F8
#undef TC_F32
#undef TC_F64
#undef TC_OPS_0_31
#undef TC_OPS_0_63
#undef TC_OPS_64_127

// -- host: tensor maps -------------------------------------------------------

// cuTensorMapEncodeTiled through the runtime's entry-point query, so that
// the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// errors of the tensor-map path, beside cudaError_t's positive codes
constexpr int ERR_NO_ENCODE = -1;   // no cuTensorMapEncodeTiled in CUDA
constexpr int ERR_TENSOR_MAP = -2;  // CUDA refused a tensor map

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor map: dims and box innermost first, strides in bytes of
// every dimension but the innermost; 128-byte swizzle, zeros out of bounds
inline bool encode(EncodeTiled enc, CUtensorMap* map, const void* base,
                   int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline const char* error_string(int code) {
  if (code == ERR_NO_ENCODE) return "CUDA has no cuTensorMapEncodeTiled";
  if (code == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace tc
