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
//   kv_append_dequantize_kernel <- kv_append_dequantize's two in one launch:
//                                the serving runner's KV append and the
//                                layer's kv_dequantize right after it
//                                (model_runner.py :262-282, :418-429,
//                                :505-513), so the append costs no launch
//                                of its own on the KV-rung serve path
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
//     bounds it. Hence kv_append_dequantize: the append rides in the
//     dequantize launch that each quantized layer runs anyway, whose
//     bytes (the pool's codes and scales read, the bf16 pool written)
//     bound the two together.

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

// quantize vector w = (token t, plane, head h) of the step into the pool
template <typename T, int KIND, int PAIRS>
__device__ __forceinline__ void append_vector(
    const T* __restrict__ k, const T* __restrict__ v,
    const long long* __restrict__ page, const long long* __restrict__ offset,
    uint8_t* __restrict__ kv, float* __restrict__ scales, long long w,
    int nkv, int hd, int bs, int W, int lane) {
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

template <typename T, int KIND, int PAIRS>
__global__ void __launch_bounds__(THREADS) kv_quantize_append_kernel(
    const T* __restrict__ k, const T* __restrict__ v,
    const long long* __restrict__ page, const long long* __restrict__ offset,
    uint8_t* __restrict__ kv, float* __restrict__ scales, int ntok, int nkv,
    int hd, int bs, int W) {
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= (long long)ntok * 2 * nkv) return;
  append_vector<T, KIND, PAIRS>(k, v, page, offset, kv, scales, w, nkv, hd,
                                bs, W, threadIdx.x & 31);
}

// ---------------------------------------------------------------------------
// K3: dequantize. One warp per row of n values; lane l handles VEC
// consecutive values at a time (VEC 4 needs n % 4 == 0 and aligned rows).
// ---------------------------------------------------------------------------

// four consecutive codes (one 4-byte load of int8 / e4m3, 2 bytes of
// int4); L2 only (ld.global.cg) where other blocks of the same launch
// wrote them
template <int KIND, bool L2_ONLY = false>
__device__ __forceinline__ uint32_t load_codes4(const uint8_t* pr, int c0) {
  if (KIND == KIND_INT4) {
    const unsigned short* p =
        reinterpret_cast<const unsigned short*>(pr + c0 / 2);
    return L2_ONLY ? __ldcg(p) : *p;
  }
  const unsigned int* p = reinterpret_cast<const unsigned int*>(pr + c0);
  return L2_ONLY ? __ldcg(p) : *p;
}

// code i of a packed word (int4: nibble i; int8 / e4m3: byte i)
template <int KIND>
__device__ __forceinline__ float code_of(uint32_t raw, int i) {
  if (KIND == KIND_INT4) {
    const int nib = (raw >> (4 * i)) & 0x0F;
    return (float)(nib > 7 ? nib - 16 : nib);
  }
  const uint8_t byte = (uint8_t)(raw >> (8 * i));
  if (KIND == KIND_FP8) {
    const __half_raw hr = __nv_cvt_fp8_to_halfraw(byte, __NV_E4M3);
    return __half2float(__half(hr));
  }
  return (float)(int8_t)byte;
}

// code c of a row
template <int KIND>
__device__ __forceinline__ float code_value(const uint8_t* __restrict__ pr,
                                            int c) {
  return KIND == KIND_INT4 ? code_of<KIND>(pr[c >> 1], c & 1)
                           : code_of<KIND>(pr[c], 0);
}

// their values times the scale, one rounding, one vector store
template <int KIND, typename O>
__device__ __forceinline__ void store_values4(uint32_t raw, float s,
                                              O* __restrict__ dst) {
  alignas(16) O o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = from_f32<O>(__fmul_rn(code_of<KIND>(raw, i), s));
  if (sizeof(O) == 4)
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(o);
  else
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
}

// eight codes (int8 / e4m3: lo then hi; int4: all in lo) the same way
template <int KIND, typename O>
__device__ __forceinline__ void store_values8(uint32_t lo, uint32_t hi,
                                              float s, O* __restrict__ dst) {
  alignas(16) O o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float q = KIND == KIND_INT4 ? code_of<KIND>(lo, i)
                                      : code_of<KIND>(i < 4 ? lo : hi, i & 3);
    o[i] = from_f32<O>(__fmul_rn(q, s));
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* src = reinterpret_cast<const uint4*>(o);
  d[0] = src[0];
  if (sizeof(O) == 4) d[1] = src[1];
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
    if (VEC == 4)
      store_values4<KIND, O>(load_codes4<KIND>(pr, c0), s, orow + c0);
    else
      orow[c0] = from_f32<O>(__fmul_rn(code_value<KIND>(pr, c0), s));
  }
}

// ---------------------------------------------------------------------------
// K4: kv_append_dequantize. K2's append of the step's K and V, then K3's
// dequantize of the layer pool (or of a block table's pages) into `out`,
// in one launch. The dequantize must not read a row the append is still
// writing, nor write a row's output from codes older than the append's.
// A persistent grid (as many blocks as the SMs hold): every warp appends
// (grid-stride over the step's vectors, so the appenders are the lowest
// blocks); each appender block then releases a 64-bit counter and every
// block acquires it (thread 0 spins) before it dequantizes. The counter
// only grows: the host passes the value it must reach, so no launch
// resets it. A spinning block never holds back an appender: blocks are
// dispatched in index order (as CUB's decoupled look-back relies on), so
// every appender is resident before any block that waits for it. The
// dequantize strides over the output, two loads in flight a lane, reading
// codes and scales from L2 (other blocks of this launch wrote some of
// them): 4 values a lane over the whole pool (K3's loads and stores), 8
// through a table (16-byte stores), the faster of the two in each mode.
//
// Measured (chip_smoke.py phase 2d, H100 80GB HBM3, 700 W; 2048 x 16
// int8 pool, bf16 out, L2 flushed): 82.0 us with the 16 tokens of a
// decode step, 84.2 with 256, against K3 alone 82.9 and K2 then K3 86.8
// / 87.0. A cooperative grid that syncs took 89-92 us, and K3's grid with
// the appenders in front, each dequantize block acquiring the counter
// itself, 153-158: the wait lengthens every block.
// ---------------------------------------------------------------------------

struct FusedArgs {
  const void* k;
  const void* v;
  const long long* page;
  const long long* offset;
  uint8_t* kv;
  float* scales;
  void* out;
  const long long* table;  // null: the whole pool
  long long rows;          // output rows (of n values)
  long long per_page;      // rows of one page (bs * 2 * nkv)
  int ntok, nkv, hd, bs, W, n;
  unsigned long long* released;  // appender blocks released, ever
  unsigned long long target;     // its value once this launch's have
  unsigned int append_blocks;    // blocks with a vector to append
};

// output row r's source row in the pool: itself, or through the table
__device__ __forceinline__ long long source_row(const long long* table,
                                                unsigned int per_page,
                                                unsigned int r) {
  if (table == nullptr) return r;
  return table[r / per_page] * per_page + r % per_page;
}

// the codes and scale of the VEC output values from value e (a multiple
// of VEC; a row holds n)
template <int KIND, int VEC>
__device__ __forceinline__ void load_chunk(const uint8_t* kv,
                                           const float* scales,
                                           const long long* table,
                                           unsigned int per_page,
                                           unsigned int n, int W,
                                           unsigned int e, uint32_t& lo,
                                           uint32_t& hi, float& s) {
  const unsigned int r = e / n;
  const int c = (int)(e - r * n);
  const long long src = source_row(table, per_page, r);
  const uint8_t* pr = kv + src * W;
  s = __ldcg(scales + src);
  hi = 0;
  if (VEC == 4) {
    lo = load_codes4<KIND, true>(pr, c);
  } else if (KIND == KIND_INT4) {
    lo = __ldcg(reinterpret_cast<const unsigned int*>(pr + c / 2));
  } else {
    const uint2 two = __ldcg(reinterpret_cast<const uint2*>(pr + c));
    lo = two.x;
    hi = two.y;
  }
}

template <typename T, int KIND, int PAIRS, int VEC>
__global__ void __launch_bounds__(THREADS)
    kv_append_dequantize_kernel(const FusedArgs a) {
  const int lane = threadIdx.x & 31;
  const long long nw = (long long)gridDim.x * WARPS;
  const long long gw = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long nvec = (long long)a.ntok * 2 * a.nkv;
  for (long long w = gw; w < nvec; w += nw)
    append_vector<T, KIND, PAIRS>(static_cast<const T*>(a.k),
                                  static_cast<const T*>(a.v), a.page,
                                  a.offset, a.kv, a.scales, w, a.nkv, a.hd,
                                  a.bs, a.W, lane);
  if (blockIdx.x < a.append_blocks) {  // release
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(a.released, 1ull);
  }
  if (threadIdx.x == 0) {  // acquire
    const volatile unsigned long long* released = a.released;
    while (*released < a.target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  // 32-bit offsets: the host checks that the output has fewer than 2^31
  // values
  const unsigned int total = (unsigned int)(a.rows * a.n);
  const unsigned int nt = gridDim.x * THREADS * VEC;
  for (unsigned int e = (blockIdx.x * THREADS + threadIdx.x) * VEC;
       e < total; e += 2 * nt) {
    const unsigned int e2 = e + nt;
    uint32_t lo, hi, lo2 = 0, hi2 = 0;
    float s, s2 = 0.0f;
    load_chunk<KIND, VEC>(a.kv, a.scales, a.table, a.per_page, a.n, a.W, e,
                          lo, hi, s);
    if (e2 < total)
      load_chunk<KIND, VEC>(a.kv, a.scales, a.table, a.per_page, a.n, a.W,
                            e2, lo2, hi2, s2);
    if (VEC == 8) {
      store_values8<KIND, T>(lo, hi, s, out + e);
      if (e2 < total) store_values8<KIND, T>(lo2, hi2, s2, out + e2);
    } else {
      store_values4<KIND, T>(lo, s, out + e);
      if (e2 < total) store_values4<KIND, T>(lo2, s2, out + e2);
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

template <typename T, int KIND, int PAIRS, int VEC>
int launch_fused_vec(FusedArgs& a, cudaStream_t s) {
  auto kernel = kv_append_dequantize_kernel<T, KIND, PAIRS, VEC>;
  static int per_sm = 0;  // co-resident blocks an SM, asked once
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const long long nvec = (long long)a.ntok * 2 * a.nkv;
  // two chunks of VEC values a thread a pass
  const long long chunk_blocks =
      (a.rows * a.n / VEC + 2 * THREADS - 1) / (2 * THREADS);
  const long long want = grid_for(nvec) > chunk_blocks ? grid_for(nvec)
                                                       : chunk_blocks;
  const long long most = (long long)per_sm * sms;
  const unsigned int g = (unsigned int)(want < most ? want : most);
  a.append_blocks = grid_for(nvec) < g ? grid_for(nvec) : g;
  a.target += a.append_blocks;
  kernel<<<g, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int KIND, int PAIRS>
int launch_fused_pairs(FusedArgs& a, cudaStream_t s) {
  if (a.table == nullptr) return launch_fused_vec<T, KIND, PAIRS, 4>(a, s);
  return launch_fused_vec<T, KIND, PAIRS, 8>(a, s);
}

template <typename T, int KIND>
int launch_fused_kind(FusedArgs& a, cudaStream_t s) {
  const int pairs = (a.hd + 63) / 64;
  if (pairs <= 1) return launch_fused_pairs<T, KIND, 1>(a, s);
  if (pairs <= 2) return launch_fused_pairs<T, KIND, 2>(a, s);
  if (pairs <= 4) return launch_fused_pairs<T, KIND, 4>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_fused(int kind, FusedArgs& a, cudaStream_t s) {
  if (kind == KIND_INT8) return launch_fused_kind<T, KIND_INT8>(a, s);
  if (kind == KIND_INT4) return launch_fused_kind<T, KIND_INT4>(a, s);
  if (kind == KIND_FP8) return launch_fused_kind<T, KIND_FP8>(a, s);
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

// K4: page / offset [ntok] int64, k / v [ntok, nkv, hd] and out in one
// float type (0 / 1 / 2), table [rows / per_page] int64 or null (out is
// then the pool's shape); hd a multiple of 8, at most 256. `released` is
// a uint64 counter that only this stream's launches touch and *target
// the value the last of them made it reach (updated here).
extern "C" int dstpu_kv_append_dequantize(
    int dtype, int kind, const void* k, const void* v, const void* page,
    const void* offset, void* kv, void* scales, void* out, const void* table,
    long long rows, int ntok, int nkv, int hd, int bs, int W,
    void* released, unsigned long long* target, void* stream) {
  if (hd % 8 != 0 || hd > 256) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || rows * hd >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  FusedArgs a{k, v, static_cast<const long long*>(page),
              static_cast<const long long*>(offset),
              static_cast<uint8_t*>(kv), static_cast<float*>(scales), out,
              static_cast<const long long*>(table), rows,
              (long long)bs * 2 * nkv, ntok, nkv, hd, bs, W, hd,
              static_cast<unsigned long long*>(released), *target, 0u};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaErrorInvalidValue;
  if (dtype == 0) rc = launch_fused<float>(kind, a, s);
  if (dtype == 1) rc = launch_fused<__nv_bfloat16>(kind, a, s);
  if (dtype == 2) rc = launch_fused<__half>(kind, a, s);
  if (rc == 0) *target = a.target;
  return rc;
}

extern "C" const char* dstpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
