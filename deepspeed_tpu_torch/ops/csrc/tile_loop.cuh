// The tile loop shared by the attention kernels of flash_attention.cu
// (forward, dK/dV, dQ) and blocksparse_attention.cu: 64 x 64 tiles held
// in shared memory as fp32 at row stride D + 1 (the 16 threads that read
// 16 rows at one d hit 16 banks), 256 threads as 16 x 16 with thread
// (ty, tx) owning score rows ty + 16 i and columns tx + 16 j, row
// statistics reduced over half warps with shuffles, scalar fp32 FMA on
// the CUDA cores. A tensor-core redesign of this loop serves every
// kernel that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 64;        // q rows and key columns per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int RT = TILE / 16;   // tile rows per thread
constexpr int LDP = TILE + 1;   // row stride of a [TILE][TILE] score tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the TPU kernels' .astype(input dtype) before a
// matmul whose other operand is in the input type (p before p @ V)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Half-warp reductions: the 16 lanes tx = 0..15 that share a row.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [row0, row0 + TILE) of head h of a [B, S, H, D] tensor -> fp32
// dst[TILE][D + 1]; rows at or past S are zero. Neighbouring threads read
// neighbouring d of one row, so the global reads coalesce.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const void* src,
                                          const long long* st, int b, int h,
                                          int row0, int S) {
  const T* base = static_cast<const T*>(src) + b * st[0] + h * st[2];
  for (int e = threadIdx.x; e < TILE * D; e += THREADS) {
    const int r = e / D, d = e % D, s = row0 + r;
    dst[r * (D + 1) + d] = s < S ? to_f32(base[(long long)s * st[1] + d]) : 0.f;
  }
}

// c[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two [TILE][D + 1]
// tiles.
template <int D>
__device__ __forceinline__ void dot_tile(const float* a, const float* b,
                                         float (&c)[RT][RT], int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[RT], bv[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) av[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < RT; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
  }
}

// acc[i][k] += sum_c p[ty + 16 i][c] * m[c][tx + 16 k] with p a
// [TILE][TILE + 1] tile and m a [TILE][D + 1] tile.
template <int D>
__device__ __forceinline__ void mul_tile(const float* p, const float* m,
                                         float (&acc)[RT][D / 16], int ty,
                                         int tx) {
  constexpr int LD = D + 1, DT = D / 16;
#pragma unroll 2
  for (int c = 0; c < TILE; ++c) {
    float pv[RT], mv[DT];
#pragma unroll
    for (int i = 0; i < RT; ++i) pv[i] = p[(ty + 16 * i) * LDP + c];
#pragma unroll
    for (int k = 0; k < DT; ++k) mv[k] = m[c * LD + tx + 16 * k];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int k = 0; k < DT; ++k) acc[i][k] = fmaf(pv[i], mv[k], acc[i][k]);
  }
}

}  // namespace
