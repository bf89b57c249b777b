// Blockwise symmetric quantization, the KV quantize-on-append and the
// dequantize for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/quantization.py:
//   quantize_blockwise_kernel <- _quant_kernel (:72, pallas_call in
//                                quantize_blockwise :106)
//   kv_quantize_append_kernel <- the same quantize at block = head_dim,
//                                reached through kv_quantize (:152) on every
//                                KV append of the serving runner
//                                (inference/model_runner.py :262-275,
//                                :412-427, :498-511), fused with kv_pack and
//                                the scatter into the paged pool
//   dequantize_kernel         <- _dequant_kernel (:82, never launched on the
//                                TPU: dequantize_blockwise runs
//                                _dequantize_ref :60) and kv_dequantize (:175)
//
// What they compute (the JAX functions, to the bit):
//   scale = absmax / qmax (qmax 127 for 8 bits, 7 for 4), or 1.0 when the
//   block is all zero; q = clip(round_half_even(x / scale), -qmax-1, qmax).
//   fp8: scale = absmax / 448 (1.0 for an all-zero vector), q = e4m3 of
//   x / scale, rounded to nearest even (satfinite: |x / scale| never passes
//   448 by more than one rounding of the division, below the 464 where
//   saturation would start to matter).
//   dequantize: float(q) * scale in fp32, rounded once to the output type.
// Each step is one IEEE-rounded operation, in the same order as the plain
// PyTorch versions (ops/quantization.py): rintf (round half to even, as
// jnp.round and torch.round; never roundf), __fdiv_rn for every division
// (never a multiply by a reciprocal), __fmul_rn for the dequantize; the
// absmax is exact whatever the order of the max. So kernel and plain
// version agree bit for bit. Never build this file with --use_fast_math.
//
// Layouts:
//   quantize_blockwise: x [rows, block] (fp32 / bf16 / fp16) -> q [rows,
//     block] int8 (4-bit values stored unpacked in [-8, 7]), scale [rows].
//   KV pool of one layer: payload [nb, bs, 2, nkv, W] with K in plane 0
//     and V in plane 1; W = head_dim (int8, e4m3) or head_dim / 2 (int4:
//     two values per byte, the even index in the low nibble, as pack_int4);
//     scales [nb, bs, 2, nkv] fp32. Token t's K and V land at
//     (page[t], offset[t], 0 / 1, head); the runner routes padding tokens
//     to the scratch page's last row, where duplicate writes race harmlessly
//     (that block is never read).
//   dequantize: payload [rows, W] + scales [rows] -> out [rows, n].
//
// Design: one warp per quantized vector (a block row, or one head's K or V
// of one token), eight per thread block. Lanes read the vector strided by
// 32 (coalesced), hold it in registers, reduce the absmax with warp
// shuffles, and write codes and the scale straight to their destination:
// one pass over the input, no shared memory, no atomics. The dequantize
// gives each warp one row and each lane 4 consecutive values (one 4-byte
// load of int8 / e4m3 codes, 2 bytes of int4, one 8-byte bf16 store) where
// the row length allows, else one value.
//
// Bounds on the H100 (80 GB HBM3 at 3.35 TB/s): all three move bytes and
// do a handful of operations per byte, so bytes bound them.
//   dequantize over the 2048-block layer pool of Llama-3-8B (bs 16, nkv 8,
//     hd 128): int8 codes 67.1 MB + scales 2.1 MB read, bf16 134.2 MB
//     written: 60.7 us; int4 (33.6 MB of codes): 50.7 us.
//   quantize_blockwise on one layer's mlp.wi [4096, 14336] bf16 at block
//     128: 117.4 MB read, 58.7 MB + 1.8 MB written: 53 us.
//   kv_quantize_append at decode (16 tokens x 2 x 8 heads x 128) moves a
//     few tens of KB: well under a microsecond of bytes, so the launch
//     bounds it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // warps (vectors) per thread block
constexpr int THREADS = 32 * WARPS;
constexpr float FP8_MAX = 448.0f;

// payload kinds
constexpr int KIND_INT8 = 0;
constexpr int KIND_INT4 = 1;  // packed, two values per byte
constexpr int KIND_FP8 = 2;   // e4m3

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

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
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the scale of a vector whose absmax is `amax` (exact zero -> 1.0)
__device__ __forceinline__ float int_scale(float amax, float qmax) {
  return amax == 0.0f ? 1.0f : __fdiv_rn(amax, qmax);
}

// one code on the integer grid: clip(rint(x / scale), -qmax - 1, qmax)
__device__ __forceinline__ int int_code(float x, float scale, float qmax) {
  const float r = rintf(__fdiv_rn(x, scale));
  return (int)fminf(fmaxf(r, -qmax - 1.0f), qmax);
}

__device__ __forceinline__ uint8_t fp8_code(float x, float scale) {
  return (uint8_t)__nv_cvt_float_to_fp8(__fdiv_rn(x, scale), __NV_SATFINITE,
                                        __NV_E4M3);
}

// ---------------------------------------------------------------------------
// K1: quantize_blockwise. PER_LANE = values per lane, >= ceil(block / 32).
// ---------------------------------------------------------------------------

template <typename T, int PER_LANE>
__global__ void __launch_bounds__(THREADS)
    quantize_blockwise_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                              float* __restrict__ scale, long long rows,
                              int block, float qmax) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + row * block;
  float v[PER_LANE];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < block ? to_f32(xr[c]) : 0.0f;
    amax = fmaxf(amax, fabsf(v[i]));
  }
  amax = warp_max(amax);
  const float s = int_scale(amax, qmax);
  int8_t* qr = q + row * block;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int c = lane + 32 * i;
    if (c < block) qr[c] = (int8_t)int_code(v[i], s, qmax);
  }
  if (lane == 0) scale[row] = s;
}

// ---------------------------------------------------------------------------
// K2: kv_quantize_append. One warp per (token, plane, kv head); lane l holds
// the value pairs (2p, 2p + 1) for p = l, l + 32, ... (PAIRS of them), so
// the int4 pack needs no exchange between lanes.
// ---------------------------------------------------------------------------

template <typename T, int KIND, int PAIRS>
__global__ void __launch_bounds__(THREADS) kv_quantize_append_kernel(
    const T* __restrict__ k, const T* __restrict__ v,
    const long long* __restrict__ page, const long long* __restrict__ offset,
    uint8_t* __restrict__ kv, float* __restrict__ scales, int ntok, int nkv,
    int hd, int bs, int W) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= (long long)ntok * 2 * nkv) return;
  const int h = (int)(w % nkv);
  const int plane = (int)((w / nkv) & 1);
  const long long t = w / (2 * nkv);
  const T* src = (plane == 0 ? k : v) + (t * nkv + h) * hd;
  float a[PAIRS], b[PAIRS];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int e = 2 * (lane + 32 * j);
    a[j] = e < hd ? to_f32(src[e]) : 0.0f;
    b[j] = e + 1 < hd ? to_f32(src[e + 1]) : 0.0f;
    amax = fmaxf(amax, fmaxf(fabsf(a[j]), fabsf(b[j])));
  }
  amax = warp_max(amax);
  float s;
  if (KIND == KIND_FP8)
    s = amax > 0.0f ? __fdiv_rn(amax, FP8_MAX) : 1.0f;
  else
    s = int_scale(amax, KIND == KIND_INT4 ? 7.0f : 127.0f);
  const long long row = ((page[t] * bs + offset[t]) * 2 + plane) * nkv + h;
  uint8_t* dst = kv + row * W;
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int p = lane + 32 * j, e = 2 * p;
    if (e >= hd) continue;
    if (KIND == KIND_INT4) {
      const int lo = int_code(a[j], s, 7.0f) & 0x0F;
      const int hi = int_code(b[j], s, 7.0f) & 0x0F;
      dst[p] = (uint8_t)(lo | (hi << 4));
    } else if (KIND == KIND_FP8) {
      dst[e] = fp8_code(a[j], s);
      if (e + 1 < hd) dst[e + 1] = fp8_code(b[j], s);
    } else {
      dst[e] = (uint8_t)(int8_t)int_code(a[j], s, 127.0f);
      if (e + 1 < hd) dst[e + 1] = (uint8_t)(int8_t)int_code(b[j], s, 127.0f);
    }
  }
  if (lane == 0) scales[row] = s;
}

// ---------------------------------------------------------------------------
// K3: dequantize. One warp per row of n values; lane l handles VEC
// consecutive values at a time (VEC 4 needs n % 4 == 0 and aligned rows).
// ---------------------------------------------------------------------------

template <int KIND>
__device__ __forceinline__ float code_value(const uint8_t* __restrict__ pr,
                                            int c) {
  if (KIND == KIND_INT4) {
    const int byte = pr[c >> 1];
    const int nib = (c & 1) ? (byte >> 4) : (byte & 0x0F);
    return (float)(nib > 7 ? nib - 16 : nib);
  } else if (KIND == KIND_FP8) {
    const __half_raw hr = __nv_cvt_fp8_to_halfraw(pr[c], __NV_E4M3);
    return __half2float(__half(hr));
  }
  return (float)(int8_t)pr[c];
}

template <int KIND, typename O, int VEC>
__global__ void __launch_bounds__(THREADS)
    dequantize_kernel(const uint8_t* __restrict__ payload,
                      const float* __restrict__ scales, O* __restrict__ out,
                      long long rows, int n, int W) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint8_t* pr = payload + row * W;
  const float s = scales[row];
  O* orow = out + row * n;
  for (int c0 = lane * VEC; c0 < n; c0 += 32 * VEC) {
    if (VEC == 4) {
      float q[4];
      if (KIND == KIND_INT4) {
        const uint16_t two = *reinterpret_cast<const uint16_t*>(pr + c0 / 2);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int nib = (two >> (4 * i)) & 0x0F;
          q[i] = (float)(nib > 7 ? nib - 16 : nib);
        }
      } else {
        const uint32_t four = *reinterpret_cast<const uint32_t*>(pr + c0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint8_t byte = (uint8_t)(four >> (8 * i));
          if (KIND == KIND_FP8) {
            const __half_raw hr = __nv_cvt_fp8_to_halfraw(byte, __NV_E4M3);
            q[i] = __half2float(__half(hr));
          } else {
            q[i] = (float)(int8_t)byte;
          }
        }
      }
      alignas(16) O o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = from_f32<O>(__fmul_rn(q[i], s));
      if (sizeof(O) == 4) {
        *reinterpret_cast<float4*>(orow + c0) =
            *reinterpret_cast<const float4*>(o);
      } else {
        *reinterpret_cast<uint2*>(orow + c0) =
            *reinterpret_cast<const uint2*>(o);
      }
    } else {
      orow[c0] = from_f32<O>(__fmul_rn(code_value<KIND>(pr, c0), s));
    }
  }
}

unsigned int grid_for(long long vectors) {
  return (unsigned int)((vectors + WARPS - 1) / WARPS);
}

template <typename T>
int launch_quantize(const void* x, void* q, void* scale, long long rows,
                    int block, float qmax, cudaStream_t s) {
  const unsigned int g = grid_for(rows);
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scale);
  const int per = (block + 31) / 32;
  if (per <= 1)
    quantize_blockwise_kernel<T, 1><<<g, THREADS, 0, s>>>(xt, qt, st, rows, block, qmax);
  else if (per <= 2)
    quantize_blockwise_kernel<T, 2><<<g, THREADS, 0, s>>>(xt, qt, st, rows, block, qmax);
  else if (per <= 4)
    quantize_blockwise_kernel<T, 4><<<g, THREADS, 0, s>>>(xt, qt, st, rows, block, qmax);
  else if (per <= 8)
    quantize_blockwise_kernel<T, 8><<<g, THREADS, 0, s>>>(xt, qt, st, rows, block, qmax);
  else if (per <= 16)
    quantize_blockwise_kernel<T, 16><<<g, THREADS, 0, s>>>(xt, qt, st, rows, block, qmax);
  else if (per <= 32)
    quantize_blockwise_kernel<T, 32><<<g, THREADS, 0, s>>>(xt, qt, st, rows, block, qmax);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T, int KIND>
int launch_append_kind(const void* k, const void* v, const void* page,
                       const void* offset, void* kv, void* scales, int ntok,
                       int nkv, int hd, int bs, int W, cudaStream_t s) {
  const unsigned int g = grid_for((long long)ntok * 2 * nkv);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const long long* pg = static_cast<const long long*>(page);
  const long long* of = static_cast<const long long*>(offset);
  uint8_t* kvt = static_cast<uint8_t*>(kv);
  float* st = static_cast<float*>(scales);
  const int pairs = (hd + 63) / 64;
  if (pairs <= 1)
    kv_quantize_append_kernel<T, KIND, 1><<<g, THREADS, 0, s>>>(kt, vt, pg, of, kvt, st, ntok, nkv, hd, bs, W);
  else if (pairs <= 2)
    kv_quantize_append_kernel<T, KIND, 2><<<g, THREADS, 0, s>>>(kt, vt, pg, of, kvt, st, ntok, nkv, hd, bs, W);
  else if (pairs <= 4)
    kv_quantize_append_kernel<T, KIND, 4><<<g, THREADS, 0, s>>>(kt, vt, pg, of, kvt, st, ntok, nkv, hd, bs, W);
  else if (pairs <= 8)
    kv_quantize_append_kernel<T, KIND, 8><<<g, THREADS, 0, s>>>(kt, vt, pg, of, kvt, st, ntok, nkv, hd, bs, W);
  else if (pairs <= 16)
    kv_quantize_append_kernel<T, KIND, 16><<<g, THREADS, 0, s>>>(kt, vt, pg, of, kvt, st, ntok, nkv, hd, bs, W);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_append(int kind, const void* k, const void* v, const void* page,
                  const void* offset, void* kv, void* scales, int ntok,
                  int nkv, int hd, int bs, int W, cudaStream_t s) {
  if (kind == KIND_INT8)
    return launch_append_kind<T, KIND_INT8>(k, v, page, offset, kv, scales,
                                            ntok, nkv, hd, bs, W, s);
  if (kind == KIND_INT4)
    return launch_append_kind<T, KIND_INT4>(k, v, page, offset, kv, scales,
                                            ntok, nkv, hd, bs, W, s);
  if (kind == KIND_FP8)
    return launch_append_kind<T, KIND_FP8>(k, v, page, offset, kv, scales,
                                           ntok, nkv, hd, bs, W, s);
  return (int)cudaErrorInvalidValue;
}

template <int KIND, typename O>
int launch_dequant_out(const void* payload, const void* scales, void* out,
                       long long rows, int n, int W, cudaStream_t s) {
  const unsigned int g = grid_for(rows);
  const uint8_t* p = static_cast<const uint8_t*>(payload);
  const float* sc = static_cast<const float*>(scales);
  O* o = static_cast<O*>(out);
  // 4 values per lane: whole groups of 4 per row, and every row start
  // aligned for the 4-byte (int4: 2-byte) code load and the output store
  const uintptr_t in_align = KIND == KIND_INT4 ? 2 : 4;
  const bool vec = n % 4 == 0 && (uintptr_t)payload % in_align == 0 &&
                   (uintptr_t)out % (4 * sizeof(O)) == 0;
  if (vec)
    dequantize_kernel<KIND, O, 4><<<g, THREADS, 0, s>>>(p, sc, o, rows, n, W);
  else
    dequantize_kernel<KIND, O, 1><<<g, THREADS, 0, s>>>(p, sc, o, rows, n, W);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_dequant(int out_dtype, const void* payload, const void* scales,
                   void* out, long long rows, int n, int W, cudaStream_t s) {
  if (out_dtype == 0)
    return launch_dequant_out<KIND, float>(payload, scales, out, rows, n, W, s);
  if (out_dtype == 1)
    return launch_dequant_out<KIND, __nv_bfloat16>(payload, scales, out, rows,
                                                   n, W, s);
  if (out_dtype == 2)
    return launch_dequant_out<KIND, __half>(payload, scales, out, rows, n, W,
                                            s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16. kind: 0 = int8,
// 1 = packed int4, 2 = fp8 e4m3. Each returns a cudaError_t (0 = launched).

extern "C" int dstpu_quantize_blockwise(int dtype, const void* x, void* q,
                                        void* scale, long long rows,
                                        int block, int bits, void* stream) {
  if (rows <= 0) return 0;
  if (bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  const float qmax = bits == 8 ? 127.0f : 7.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_quantize<float>(x, q, scale, rows, block, qmax, s);
  if (dtype == 1)
    return launch_quantize<__nv_bfloat16>(x, q, scale, rows, block, qmax, s);
  if (dtype == 2)
    return launch_quantize<__half>(x, q, scale, rows, block, qmax, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dstpu_kv_quantize_append(int dtype, int kind, const void* k,
                                        const void* v, const void* page,
                                        const void* offset, void* kv,
                                        void* scales, int ntok, int nkv,
                                        int hd, int bs, int W, void* stream) {
  if (ntok <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_append<float>(kind, k, v, page, offset, kv, scales, ntok,
                                nkv, hd, bs, W, s);
  if (dtype == 1)
    return launch_append<__nv_bfloat16>(kind, k, v, page, offset, kv, scales,
                                        ntok, nkv, hd, bs, W, s);
  if (dtype == 2)
    return launch_append<__half>(kind, k, v, page, offset, kv, scales, ntok,
                                 nkv, hd, bs, W, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dstpu_dequantize(int kind, int out_dtype, const void* payload,
                                const void* scales, void* out, long long rows,
                                int n, int W, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == KIND_INT8)
    return launch_dequant<KIND_INT8>(out_dtype, payload, scales, out, rows, n,
                                     W, s);
  if (kind == KIND_INT4)
    return launch_dequant<KIND_INT4>(out_dtype, payload, scales, out, rows, n,
                                     W, s);
  if (kind == KIND_FP8)
    return launch_dequant<KIND_FP8>(out_dtype, payload, scales, out, rows, n,
                                    W, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dstpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
