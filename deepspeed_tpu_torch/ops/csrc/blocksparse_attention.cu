// Block-sparse attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// deepspeed_tpu/ops/pallas/blocksparse_attention.py:
//   blocksparse_fwd_kernel <- _sparse_fwd_kernel (:247, pallas_call in
//                             blocksparse_attention_pallas :317)
//
// What it computes (the TPU kernel's function, not its grid): flash
// attention over the (query, key) pairs that a static block layout lets
// through. s = q.k * scale in fp32, NEG_INF = -1e30 where a column is
// hidden (by the layout, by causality, or at or past S); fp32 online
// softmax over key tiles (running max m, denominator l, accumulator acc);
// p is rounded to the input type before p @ V and l sums the fp32 p;
// O = acc / l in the input type, and 0 where l == 0 (a row that sees no
// column: the TPU kernel's l_safe, :296). Hidden columns get an exact-zero
// probability. GQA: q head h reads kv head h / (Hq / Hkv), which is
// repeat_kv_heads followed by the TPU kernel's MHA function.
//
// Layouts: q [B, S, Hq, D] and k, v [B, S, Hkv, D] at any (batch, seq,
// head) strides with unit stride over D; O is written [B, S, Hq, D],
// contiguous. The block layout is uint8 [nb, nb] (nb = padded S / block).
// The work list is CSR over 64-row query tiles: tiles[offsets[i] ..
// offsets[i + 1]) are the 64-column key tiles, ascending, that hold a
// visible pair for query tile i; order[] lists the query tiles longest
// list first. The host builds it once per (layout, S, causal).
//
// Design. The TPU kernel visits every (q-block, k-block) grid step in
// order and skips both products of an absent pair with pl.when, carrying
// m/l/acc in VMEM across the sequential key axis. Here one thread block
// owns one (b, q head, 64-row query tile) and walks only its tile's work
// list, so the work scales with the layout's density and no block visits
// an absent pair; nothing is carried between blocks and no atomics are
// used (two launches give the same bits). The layout block may be any
// size: when it is a multiple of the 64-wide tile, a live tile lies
// inside one live block and only causality and S mask it; otherwise each
// (row, column) looks its block up in the layout (cached in L1/L2). The
// tile loop is flash_fwd_kernel's, shared through tile_loop.cuh: tiles in
// shared memory as fp32 with row stride D + 1, 256 threads as 16 x 16,
// thread (ty, tx) owning score rows ty + 16 i and columns tx + 16 j, row
// statistics reduced over half warps with shuffles, scalar fp32 FMA on
// the CUDA cores (no tensor cores, no TMA): the simple first version.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * D flops per
// visible (row, column) pair and head. Fixed layout (block 128, 4 local
// blocks, 1 global), causal, B 1, S 4096, 32 q heads of 128: 2.88 M
// visible pairs a head, 47 GFLOP, 48 us at the tensor-core rate, against
// ~84 MB of Q, K, V and O in bf16 (Q and O at 32 heads, K and V at 8),
// 25 us: bound by operations. Scalar FMAs peak at 67 TFLOP/s, so expect tens of times the
// bound until the loop moves to the tensor cores (mma.sync, then wgmma +
// TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_loop.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* offsets;            // [nt + 1]
  const int* tiles;              // live key tiles, CSR by query tile
  const int* order;              // [nt] query tiles, longest list first
  const unsigned char* layout;   // [nb, nb]
  long long qst[3], kst[3], vst[3];  // (batch, seq, head) strides
  int B, S, Hq, Hkv, causal, block, nb;
  float scale;
};

// Is key column col visible to query row row. The layout is read only
// for in-range positions, and only when a tile may span several layout
// blocks (a live tile of a block that is a multiple of TILE lies inside
// one live block).
__device__ __forceinline__ bool visible(const Params& p, int row, int col,
                                        bool per_element) {
  if (row >= p.S || col >= p.S || (p.causal && col > row)) return false;
  return !per_element ||
         p.layout[(long long)(row / p.block) * p.nb + col / p.block] != 0;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) blocksparse_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DT = D / 16;
  float* qs = smem;              // [TILE][LD]
  float* ks = qs + TILE * LD;    // [TILE][LD]; the P tile reuses it
  float* vs = ks + TILE * LD;    // [TILE][LD]
  float* ps = ks;                // [TILE][LDP]

  const int iq = p.order[blockIdx.x];  // the longest lists first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = iq * TILE;
  const int t_begin = p.offsets[iq], t_end = p.offsets[iq + 1];
  const bool per_element = p.block % TILE != 0;

  load_tile<T, D>(qs, p.q, p.qst, b, h, row0, p.S);
  float acc[RT][DT], m[RT], l[RT];
  int row[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    row[i] = row0 + ty + 16 * i;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DT; ++k) acc[i][k] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = p.tiles[t] * TILE;
    __syncthreads();  // the previous tile's P and V reads are done
    load_tile<T, D>(ks, p.k, p.kst, b, hk, col0, p.S);
    load_tile<T, D>(vs, p.v, p.vst, b, hk, col0, p.S);
    int col[RT];
#pragma unroll
    for (int j = 0; j < RT; ++j) col[j] = col0 + tx + 16 * j;
    __syncthreads();
    float s[RT][RT];
    dot_tile<D>(qs, ks, s, ty, tx);
    __syncthreads();  // every thread is done with K: P overwrites it
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      bool vis[RT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        vis[j] = visible(p, row[i], col[j], per_element);
        s[i][j] = vis[j] ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        // an exact 0 for hidden columns: while every score so far is
        // NEG_INF, exp(s - mn) would be exp(0)
        const float pv = vis[j] ? expf(s[i][j] - mn) : 0.f;
        sum += pv;
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = round_to<T>(pv);
      }
      l[i] = alpha * l[i] + row_sum16(sum);
      m[i] = mn;
#pragma unroll
      for (int k = 0; k < DT; ++k) acc[i][k] *= alpha;
    }
    __syncthreads();
    mul_tile<D>(ps, vs, acc, ty, tx);
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    if (row[i] >= p.S) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    const long long o = (((long long)b * p.S + row[i]) * p.Hq + h) * D;
#pragma unroll
    for (int k = 0; k < DT; ++k)
      out[o + tx + 16 * k] = from_f32<T>(acc[i][k] / ls);
  }
}

template <typename T, int D>
int launch(const Params& p, void* stream) {
  const int nt = (p.S + TILE - 1) / TILE;
  if (nt == 0 || p.Hq == 0 || p.B == 0) return 0;
  const size_t smem = 3 * (size_t)TILE * (D + 1) * sizeof(float);
  auto kernel = blocksparse_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(nt, p.Hq, p.B), THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd: 64 or 128. strides: 9 int64, the
// (batch, seq, head) element strides of q, k and v. block: the layout
// block; nb: the layout's side. Returns a cudaError_t
// (0 = launched).
extern "C" int dstpu_blocksparse_fwd(int dtype, int hd, const void* q,
                                     const void* k, const void* v, void* out,
                                     const void* offsets, const void* tiles,
                                     const void* order, const void* layout,
                                     const long long* strides, int B, int S,
                                     int Hq, int Hkv, int causal, int block,
                                     int nb, float scale, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.offsets = static_cast<const int*>(offsets);
  p.tiles = static_cast<const int*>(tiles);
  p.order = static_cast<const int*>(order);
  p.layout = static_cast<const unsigned char*>(layout);
  for (int i = 0; i < 3; ++i) {
    p.qst[i] = strides[i];
    p.kst[i] = strides[3 + i];
    p.vst[i] = strides[6 + i];
  }
  p.B = B;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.block = block;
  p.nb = nb;
  p.scale = scale;
  if (dtype == 0 && hd == 64) return launch<float, 64>(p, stream);
  if (dtype == 0 && hd == 128) return launch<float, 128>(p, stream);
  if (dtype == 1 && hd == 64) return launch<__nv_bfloat16, 64>(p, stream);
  if (dtype == 1 && hd == 128) return launch<__nv_bfloat16, 128>(p, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dstpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
