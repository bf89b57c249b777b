// Block-sparse attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// deepspeed_tpu/ops/pallas/blocksparse_attention.py:
//   blocksparse_fwd_wgmma_kernel <- _sparse_fwd_kernel (:247, pallas_call
//                                   in blocksparse_attention_pallas :317),
//                                   bf16 with head dim 128 and a layout
//                                   block that is a multiple of 128
//   blocksparse_fwd_kernel       <- the same, for fp32, head dim 64, other
//                                   layout blocks and strides TMA cannot
//                                   take
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
// The work list is CSR over query tiles of the kernel's width (64 for the
// scalar kernel, 128 for the tensor-core one): tiles[offsets[i] ..
// offsets[i + 1]) are the key tiles, ascending, that hold a visible pair
// for query tile i; order[] lists the query tiles longest list first. The
// host builds it once per (layout, S, causal, tile).
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
// 25 us: bound by operations. Scalar FMAs peak at 67 TFLOP/s, so the
// scalar kernel runs at tens of times the bound.
//
// The tensor-core forward (blocksparse_fwd_wgmma_kernel; bf16, D 128, a
// layout block that is a multiple of 128, 16-byte aligned data and
// strides) is flash_fwd_wgmma_kernel with its key loop driven by the work
// list: one block per (q head, batch, 128-row q tile), the tiles with the
// longest lists first over every head; two consumer warpgroups of 64 rows
// and a producer warp; TMA brings Q once and the listed 128-key tiles of K
// and V through a 2-stage ring, from 4-D maps over q, k and v as they lie
// (rows >= S zero-filled); the consumer step (S = Q K^T on wgmma, the fp32
// softmax in log2 units, p rounded to bf16 as the register A operand of
// O += P V, the turns) is attention_tc.cuh's. The work list is built at
// tile 128, which is also the TPU kernel's fold at its default block
// (block_q = block_k = 128). A live tile lies inside one live layout
// block, so the mask is needed only on the causal diagonal and the tail
// past S; other layout blocks take the scalar kernel. A query tile with
// an empty list writes zeros. Same function as the scalar kernel, with
// key tiles of 128 rather than 64 (the running max, and so p's bf16
// rounding, moves at other columns): blocksparse_fwd_plain at the work
// list's tile repeats either fold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "hopper.cuh"
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

// ---------------------------------------------------------------------------
// the forward on the tensor cores (bf16, D 128, layout block % 128 == 0)
// ---------------------------------------------------------------------------

namespace bs_tc {

using attn_tc::BKV;
using attn_tc::D;
using attn_tc::HALF;
using attn_tc::KV_BYTES;
constexpr int BQ = 128;   // q rows a block: two consumer warpgroups of 64
constexpr int THREADS = 2 * 128 + 32;  // + one producer warp
constexpr int Q_BYTES = 2 * HALF;
constexpr int STAGE_BYTES = 2 * KV_BYTES;
constexpr int STAGES = 2;
// 1 KB to align to the swizzle atom, Q, the ring, the barriers
constexpr int SMEM =
    1024 + Q_BYTES + STAGES * STAGE_BYTES + 8 * (1 + 3 * STAGES);

struct Args {
  __nv_bfloat16* out;
  const int* offsets;  // [nt + 1], CSR over 128-row query tiles
  const int* tiles;    // live 128-column key tiles
  const int* order;    // [nt] query tiles, longest list first
  int S, Hq, Hkv, causal;
  float scale;
  int pos_q, pos_k, pos_v;  // as flash_fwd_wgmma_kernel's
};

}  // namespace bs_tc

__global__ void __launch_bounds__(bs_tc::THREADS, 1)
    blocksparse_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const bs_tc::Args a) {
  using namespace bs_tc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = qs + Q_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int iq = a.order[blockIdx.z];  // the longest lists first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (a.Hq / a.Hkv);
  const int row0 = iq * BQ;
  const int* tiles = a.tiles + a.offsets[iq];
  const int nk = a.offsets[iq + 1] - a.offsets[iq];

  if (threadIdx.x == 0) {
    tc::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      tc::mbar_init(&k_full[s], 1);
      tc::mbar_init(&v_full[s], 1);
      tc::mbar_init(&empty[s], 2);
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warp
    if (threadIdx.x == 256 && nk > 0) {
      tc::mbar_arrive_expect_tx(q_full, Q_BYTES);
      attn_tc::load_rows(qs, &q_map, q_full, a.pos_q, h, row0, b);
      for (int it = 0; it < nk; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) tc::mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        const int col0 = tiles[it] * BKV;
        uint8_t* ks = ring + s * STAGE_BYTES;
        tc::mbar_arrive_expect_tx(&k_full[s], KV_BYTES);
        attn_tc::load_rows(ks, &k_map, &k_full[s], a.pos_k, hk, col0, b);
        tc::mbar_arrive_expect_tx(&v_full[s], KV_BYTES);
        attn_tc::load_rows(ks + KV_BYTES, &v_map, &v_full[s], a.pos_v, hk,
                           col0, b);
      }
    }
    return;
  }

  // the m64n128k16 fragment (attention_tc.cuh): rows r_lo and r_lo + 8
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const int q4 = lane % 4;
  const int row_first = row0 + 64 * wg;
  const int r_lo = row_first + (tid / 32) * 16 + lane / 4;
  const float scale2 = a.scale * attn_tc::LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  const uint8_t* qw = qs + wg * 64 * 128;  // this warpgroup's rows
  if (nk > 0) {
    tc::mbar_wait(q_full, 0);
    // 0 goes first
    if (wg == 1) tc::named_barrier_arrive(attn_tc::BAR_TURN, 256);
  }

  for (int it = 0; it < nk; ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const int col0 = tiles[it] * BKV;
    const uint8_t* ks = ring + s * STAGE_BYTES;
    const uint8_t* vs = ks + KV_BYTES;

    float sc[64];
    tc::mbar_wait(&k_full[s], parity);
    attn_tc::qk_scores<2>(sc, qw, HALF, ks, wg);
    // a live tile lies inside one live layout block: only causality and S
    // mask it, on the diagonal tile and the tail
    uint32_t vis[2] = {~0u, ~0u};
    if ((a.causal && col0 + BKV - 1 > row_first) || col0 + BKV > a.S) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * j + 2 * q4 + e;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            if (!(col < a.S && (!a.causal || col <= r_lo + 8 * hh)))
              vis[hh] &= ~(1u << (2 * j + e));
        }
    }
    attn_tc::online_softmax(sc, vis, scale2, m, l, o);
    uint32_t pa[1][8][4];
    attn_tc::pack_p(sc, pa);  // p rounded to bf16, as the TPU kernel does
    tc::mbar_wait(&v_full[s], parity);
    attn_tc::pv_product<2, 1>(o, pa, vs, wg, !(wg == 1 && it == nk - 1));
    if (tid == 0) tc::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_lo + 8 * hh;
    if (r < a.S)
      attn_tc::store_row(a.out + ((long long)b * a.S + r) * a.Hq * D + h * D,
                         o, hh, l[hh], q4);
  }
}

int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 const void* offsets, const void* tiles, const void* order,
                 const long long* strides, int B, int S, int Hq, int Hkv,
                 int causal, float scale, cudaStream_t stream) {
  const int nt = (S + bs_tc::BQ - 1) / bs_tc::BQ;
  if (nt == 0 || Hq == 0 || B == 0) return 0;
  const tc::EncodeTiled enc = tc::encode_tiled();
  if (enc == nullptr) return tc::ERR_NO_ENCODE;
  CUtensorMap q_map, k_map, v_map;
  bs_tc::Args a{};
  using attn_tc::encode_bshd;
  if (!encode_bshd(enc, &q_map, q, B, S, Hq, strides, bs_tc::BQ, &a.pos_q) ||
      !encode_bshd(enc, &k_map, k, B, S, Hkv, strides + 3, bs_tc::BKV,
                   &a.pos_k) ||
      !encode_bshd(enc, &v_map, v, B, S, Hkv, strides + 6, bs_tc::BKV,
                   &a.pos_v))
    return tc::ERR_TENSOR_MAP;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.offsets = static_cast<const int*>(offsets);
  a.tiles = static_cast<const int*>(tiles);
  a.order = static_cast<const int*>(order);
  a.S = S;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.causal = causal;
  a.scale = scale;
  const cudaError_t e = cudaFuncSetAttribute(
      blocksparse_fwd_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bs_tc::SMEM);
  if (e != cudaSuccess) return (int)e;
  blocksparse_fwd_wgmma_kernel<<<dim3(Hq, B, nt), bs_tc::THREADS,
                                 bs_tc::SMEM, stream>>>(q_map, k_map, v_map,
                                                        a);
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

// The tensor-core forward: bf16 q, k, v of head dim 128 with 16-byte
// aligned data and (batch, seq, head) strides that are positive multiples
// of 8 elements; the work list at tile 128 of a layout whose block is a
// multiple of 128 (the wrapper checks all of it). Returns a cudaError_t or
// one of hopper.cuh's negative tensor-map codes (0 = launched).
extern "C" int dstpu_blocksparse_fwd_wgmma(const void* q, const void* k,
                                           const void* v, void* out,
                                           const void* offsets,
                                           const void* tiles,
                                           const void* order,
                                           const long long* strides, int B,
                                           int S, int Hq, int Hkv, int causal,
                                           float scale, void* stream) {
  return launch_wgmma(q, k, v, out, offsets, tiles, order, strides, B, S, Hq,
                      Hkv, causal, scale, static_cast<cudaStream_t>(stream));
}

extern "C" const char* dstpu_cuda_error_string(int code) {
  return tc::error_string(code);
}
