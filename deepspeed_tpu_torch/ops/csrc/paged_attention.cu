// Paged decode and paged (chunked) prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/paged_attention.py:
//   paged_decode_split_kernel <- _kernel (:77, pallas_call in
//                           paged_decode_attention :312), bf16 with head
//                           dim 128, contiguous and 16-byte aligned
//   paged_decode_kernel  <- the same, for fp32 and the rest
//   paged_prefill_wgmma_kernel <- _prefill_kernel (:117, pallas_call in
//                           paged_prefill_attention :238), bf16 with head
//                           dim 128, block sizes of 8 to 128 that divide
//                           128, a group that divides 128, 16-byte
//                           aligned data
//   paged_prefill_kernel <- the same, for fp32 and the rest
//
// What they compute (the TPU kernels' function, not their block structure):
// each (sequence, kv head) walks its block-table pages in ascending order
// and folds each page into an fp32 online softmax (running max m, running
// denominator l, weighted-value accumulator acc), with NEG_INF = -1e30 for
// masked scores and an exact 0 for masked probabilities (_fold_page :38-63).
// Column col is visible to a query row at absolute position qpos when
// col <= qpos and col < ctx. Rows that saw nothing (l == 0) give 0.
// Decode is the one-query case: qpos = ctx - 1, so ctx == 0 is a dead slot.
//
// Layouts (the JAX package's, unchanged):
//   pool  [nb, bs, 2, nkv, hd]: K in plane 0, V in plane 1. Consecutive
//         tokens' K rows are 2*nkv*hd elements apart, and a token's V row
//         lies nkv*hd elements after its K row.
//   decode  q/out [S, nh, hd];      prefill q/out [S, Tq, nh, hd]
//   block_table [S, Bm] int32; ctx [S] int32; pos0 [S] int32 (prefill)
// Query rows of one kv head are laid out query-major, group-minor
// (row r -> query r / g, head kvh * g + r % g, g = nh / nkv), as the TPU
// wrapper's transpose does (:202-206).
//
// Design. One thread block per (sequence, kv head[, tile of 64 query
// rows]). The block holds its rows' q (pre-scaled, fp32) and acc in shared
// memory and reads K/V in chunks of whole pages (64 tokens for decode, 32
// for prefill) with 16-byte loads, converting to fp32 once. Inside a chunk
// the pages fold one at a time in ascending order, in the same order of
// operations as the plain PyTorch version (ops/paged_attention.py): scores
// for all columns of the chunk (prefill: 4 x 2 register tiles of
// (row, column) per thread; decode: one pair per thread), then per row (a
// warp per row, lanes over the page's columns) and per page
// m_new = max(m, max_t s), alpha = exp(m - m_new), p = exp(s - m_new) or 0,
// l = alpha * l + sum p, acc = acc * alpha + p @ V. Pages past the last
// column a tile can see are not read at all; folding a fully masked page
// leaves (m, l, acc) unchanged, so skipping it is exact.
// All arithmetic is scalar fp32 FMA on the CUDA cores; no tensor cores,
// no TMA, no split over pages. That is the simple first version; every
// decode and prefill the split and tensor-core kernels do not take still
// run it.
//
// The split decode (paged_decode_split_kernel): decode reads each K/V
// byte once and does ~1 flop a byte, so bytes bound it; the scalar
// kernel's one block per (sequence, kv head) walking its whole context
// alone gives 128 blocks at S 16 x 8 kv heads and 8 at S 1, and loads
// nothing while it computes. Here:
//   Split over pages (flash-decoding). One block per (span of pages, kv
//     head [x group of 8 query heads where g > 8], sequence) takes the
//     span's K/V once for all (up to 8) query rows of its kv head. The
//     span (a whole number of pages) comes from the host and depends on
//     shapes only (S, heads, Bm * bs, bs, the SM count), never on ctx,
//     so a sequence's bits do not depend on its neighbours'. Blocks whose span starts at or past
//     lim = min(ctx, Bm * bs) exit at once; a dead slot's first block
//     writes its zeros.
//   Pipelined page loads. Each of the 4 warps walks its own 16-token
//     chunks of the span (chunks w, w + 4, ...) through its own ring of 3
//     stages in shared memory, filled by cp.async 16-byte copies (token
//     rows found through the block table, page ids clamped to
//     [0, nb - 1]; tokens past the span or lim zero-filled): two chunks
//     stay in flight while one is folded, ~128 KB a SM at 2 blocks an SM.
//     No block-wide barrier inside the walk. K/V stay bf16 in shared
//     memory (rows padded to 272 bytes: ldmatrix without bank conflicts).
//   Compute, on mma.sync m16n8k16 (wgmma's 64-row minimum would waste 60
//     of 64 rows at g 4): S = Q K^T with the block's 8 query rows padded
//     to 16 (q unscaled bf16 in registers, K^T by ldmatrix), scaled in
//     fp32; each chunk folds into the warp's fp32 online softmax (m, l,
//     acc) with the TPU kernel's formulas and sentinels (NEG_INF, p
//     exactly 0 where masked); O^T += V^T P^T takes V^T by ldmatrix.trans
//     and P^T straight from the score fragment, p kept fp32 as bf16
//     hi + lo through two products (as the tensor-core prefill): ~150
//     instructions a 16-token chunk, so the copies, not the fold, set
//     the time. At the span's end the 4 warps' states merge (below) into
//     the block's.
//   One launch a layer. A span that is the sequence's only live one
//     writes bf16 out directly. Otherwise each block writes its (m, l,
//     acc) to fp32 scratch, fences, and takes a ticket from a counter of
//     its (sequence, kv head, group); the last to arrive merges the live
//     spans in ascending order and resets the counter to 0, so that the
//     host keeps one zeroed counter buffer and never clears it.
//   Merge (warps, then spans; fixed order, so two launches give the same
//     bits): M = max_i m_i, w_i = exp(m_i - M), L = sum_i w_i l_i,
//     A = sum_i w_i acc_i, out = A / L. One span is the plain fold itself.
//   The plain twin, paged_decode_attention_split_plain, folds each span's
//     pages in ascending order (the kernel folds 16-token chunks per
//     warp, an fp32-rounding-level difference) and merges the spans with
//     these formulas.
//
// The tensor-core prefill (paged_prefill_wgmma_kernel): one block per
// (tile of 128 query rows, kv head, segment), two consumer warpgroups of
// 64 rows and one producer warp; where a segment's Tq * g rows fit in 64
// (decode-sized chunks), a 64-row block of one consumer warpgroup, so
// that half the block does not idle. The consumer step is
// attention_tc.cuh's (the flash forward's): S = Q K^T on wgmma, the fp32
// online softmax in log2 units on the fragment, O += P V from registers.
//   Q by TMA through a map over q [S, Tq, nh, hd] as (d, head, query,
//     segment) with box (64 d, g heads, rows / g queries, 1): the box
//     lands the tile's rows in the kernel's row order (query-major,
//     group-minor); queries past Tq are zero-filled.
//   K and V by TMA one page at a time, through a map over the layer pool
//     as (d, kv head, plane, token = nb * bs) with box (64, 1, 1, bs):
//     the producer reads the block table (page ids clamped to [0, nb - 1]
//     as above) and loads token row page * bs, 128 / bs pages x 2 d
//     halves for a 128-key tile. The 128-byte swizzle is a function of
//     the shared-memory address, and each page box starts on a
//     1024-byte swizzle atom (bs % 8 == 0), so the stacked page boxes are
//     byte for byte one [128][64] swizzled box and the forward's wgmma
//     descriptors apply unchanged. Slots of a tile past the last page any
//     row sees reload that page: its columns are masked, with p exactly 0
//     (pool entries are finite: the pool starts zeroed).
//   Key tiles run up to min(ctx, pos0 + the tile's last query + 1,
//     Bm * bs); the mask (col <= qpos, col < min(ctx, Bm * bs)) is applied
//     only on the tiles that reach past the first row's qpos or that
//     limit.
//   p stays fp32, as in the TPU kernel (it does not round p before p @ V,
//     unlike the flash and block-sparse kernels): p = hi + lo with both
//     parts bf16, and O += hi V + lo V, two register-A products against
//     the same V tile. hi + lo carries ~16 of p's 24 bits (relative error
//     ~2^-17), beyond fp32 rounding but far inside the bf16 output's
//     rounding; the cost is twice the P V products in a kernel bound by
//     bytes and latency, not operations.
//   O / l is written from the fragment in bf16 pairs, rows past Tq * g
//     skipped, 0 where l == 0.
//
// Bound on the H100 (80 GB HBM3 at 3.35 TB/s; 989 TFLOP/s bf16 dense):
//   decode reads sum(ctx) * 2 * nkv * hd elements of K/V per layer and does
//   4 * nh * hd flops per visible column: about one flop per byte, so it is
//   memory-bound.
//   prefill reads each segment's q and K/V and writes its output once, and
//   does 4 * nh * hd flops per visible (query, column) pair: at Tq 128 and
//   contexts of a few hundred tokens that is ~190 flops per byte, under
//   the card's ~295 ridge, so bytes bound it; long contexts cross into
//   operations. Scalar fp32 FMAs reach a small share of either bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

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

struct Params {
  const void* q;
  const void* kv;
  const int* block_table;
  const int* pos0;  // null for decode
  const int* ctx;
  void* out;
  int S, tq, nh, nkv, hd, nb, bs, Bm;
  int rows;         // query rows per thread block
  int chunk_pages;  // pages read per chunk
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < VEC; ++i) dst[i] = to_f32(h[i]);
}

// Attend query rows [row0, row0 + p.rows) of sequence s, kv head kvh.
// Each thread computes TR x TC scores and TR x TD accumulator entries at
// a time (register tiles); p.rows % TR, the chunk % TC and hd % TD must
// be 0 (the host picks the tiles).
template <typename T, int TR, int TC, int TD>
__device__ void attend_rows(const Params& p, int s, int kvh, int row0,
                            int pos0, int ctx) {
  // Shared memory, in floats: q, acc, K (rows padded by one float so that
  // threads reading different K rows hit different banks), V, scores,
  // per-page alpha, m, l; then qpos as ints. smem_bytes() sizes it.
  extern __shared__ float smem[];
  const int R = p.rows, hd = p.hd, bs = p.bs;
  const int g = p.nh / p.nkv;
  const int CH = p.chunk_pages * bs;
  const int kstride = hd + 1;
  float* qs = smem;                        // [R][hd]
  float* acc = qs + (size_t)R * hd;        // [R][hd]
  float* ks = acc + (size_t)R * hd;        // [CH][hd + 1]
  float* vs = ks + (size_t)CH * kstride;   // [CH][hd]
  float* sc = vs + (size_t)CH * hd;        // [R][CH]
  float* alpha = sc + (size_t)R * CH;      // [chunk_pages][R]
  float* m = alpha + (size_t)p.chunk_pages * R;  // [R]
  float* l = m + R;                        // [R]
  int* qpos = reinterpret_cast<int*>(l + R);     // [R]

  const T* q = static_cast<const T*>(p.q);
  const T* kv = static_cast<const T*>(p.kv);
  T* out = static_cast<T*>(p.out);
  const int* bt = p.block_table + (size_t)s * p.Bm;
  const int total_rows = p.tq * g;
  const size_t tok_stride = (size_t)2 * p.nkv * hd;
  const size_t v_off = (size_t)p.nkv * hd;

  for (int e = threadIdx.x; e < R * hd; e += blockDim.x) {
    const int r = e / hd, d = e % hd, gr = row0 + r;
    float v = 0.f;
    if (gr < total_rows) {
      const size_t off =
          (((size_t)s * p.tq + gr / g) * p.nh + kvh * g + gr % g) * hd + d;
      v = to_f32(q[off]) * p.scale;
    }
    qs[e] = v;
    acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int gr = row0 + r;
    qpos[r] = gr < total_rows ? pos0 + gr / g : -1;  // -1: sees nothing
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  // the last column any row of this tile can see; columns past the
  // block table's Bm pages are never visited (as in the TPU kernel's grid)
  const int last_row = min(row0 + R, total_rows) - 1;
  const int col_end =
      last_row < row0 ? 0
                      : min(min(ctx, pos0 + last_row / g + 1), p.Bm * bs);
  __syncthreads();

  constexpr int VEC = 16 / sizeof(T);
  const bool vec_ok =
      hd % VEC == 0 && reinterpret_cast<uintptr_t>(kv) % 16 == 0;
  for (int c0 = 0; c0 < col_end; c0 += CH) {
    const int ncols = min(CH, col_end - c0);
    // 1. K/V of this chunk's columns -> fp32 shared memory (zeros past
    //    the last visible column, so that 0 * V stays 0)
    if (vec_ok) {
      const int vpr = hd / VEC;
      for (int e = threadIdx.x; e < CH * vpr; e += blockDim.x) {
        const int c = e / vpr, d0 = (e % vpr) * VEC;
        float kf[VEC], vf[VEC];
        if (c < ncols) {
          const int col = c0 + c;
          const int page = min(max(bt[col / bs], 0), p.nb - 1);
          const size_t base = ((size_t)page * bs + col % bs) * tok_stride +
                              (size_t)kvh * hd + d0;
          load_vec<T>(kv + base, kf);
          load_vec<T>(kv + base + v_off, vf);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          ks[c * kstride + d0 + i] = kf[i];
          vs[c * hd + d0 + i] = vf[i];
        }
      }
    } else {
      for (int e = threadIdx.x; e < CH * hd; e += blockDim.x) {
        const int c = e / hd, d = e % hd;
        float kf = 0.f, vf = 0.f;
        if (c < ncols) {
          const int col = c0 + c;
          const int page = min(max(bt[col / bs], 0), p.nb - 1);
          const size_t base = ((size_t)page * bs + col % bs) * tok_stride +
                              (size_t)kvh * hd + d;
          kf = to_f32(kv[base]);
          vf = to_f32(kv[base + v_off]);
        }
        ks[c * kstride + d] = kf;
        vs[c * hd + d] = vf;
      }
    }
    __syncthreads();

    // 2. scores q . k for every (row, column) of the chunk, NEG_INF where
    //    the column is not visible; each thread a TR x TC tile of them
    //    (TC adjacent columns, so a warp's K reads hit distinct banks)
    const int ctiles = CH / TC;
    for (int tile = threadIdx.x; tile < (R / TR) * ctiles;
         tile += blockDim.x) {
      const int r0 = (tile / ctiles) * TR, cc0 = (tile % ctiles) * TC;
      float a[TR][TC];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) a[i][j] = 0.f;
      for (int d = 0; d < hd; ++d) {
        float qv[TR], kc[TC];
#pragma unroll
        for (int i = 0; i < TR; ++i) qv[i] = qs[(size_t)(r0 + i) * hd + d];
#pragma unroll
        for (int j = 0; j < TC; ++j)
          kc[j] = ks[(size_t)(cc0 + j) * kstride + d];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) a[i][j] = fmaf(qv[i], kc[j], a[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int r = r0 + i, col = c0 + cc0 + j;
          sc[(size_t)r * CH + cc0 + j] =
              (col < ctx && col <= qpos[r]) ? a[i][j] : NEG_INF;
        }
    }
    __syncthreads();

    // 3. online softmax, one warp per row (lanes over the page's
    //    columns), pages in ascending order; the scores are overwritten
    //    with the probabilities
    const int npages = (ncols + bs - 1) / bs;
    const int lane = threadIdx.x % 32;
    for (int r = threadIdx.x / 32; r < R; r += blockDim.x / 32) {
      float mr = m[r], lr = l[r];
      for (int pg = 0; pg < npages; ++pg) {
        float* srow = sc + (size_t)r * CH + pg * bs;
        float mc = NEG_INF;
        for (int t = lane; t < bs; t += 32) mc = fmaxf(mc, srow[t]);
        mc = warp_max(mc);
        const float mn = fmaxf(mr, mc);
        const float a = expf(mr - mn);
        float sum = 0.f;
        for (int t = lane; t < bs; t += 32) {
          const int col = c0 + pg * bs + t;
          const float pv =
              (col < ctx && col <= qpos[r]) ? expf(srow[t] - mn) : 0.f;
          srow[t] = pv;
          sum += pv;
        }
        lr = a * lr + warp_sum(sum);
        mr = mn;
        if (lane == 0) alpha[pg * R + r] = a;
      }
      if (lane == 0) {
        m[r] = mr;
        l[r] = lr;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + p @ V, page by page; each thread a TR x TD
    //    tile of (row, d), V read TD floats at a time
    const int dtiles = hd / TD;
    for (int tile = threadIdx.x; tile < (R / TR) * dtiles;
         tile += blockDim.x) {
      const int r0 = (tile / dtiles) * TR, d0 = (tile % dtiles) * TD;
      float a[TR][TD];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) a[i][j] = acc[(size_t)(r0 + i) * hd + d0 + j];
      for (int pg = 0; pg < npages; ++pg) {
        float pv[TR][TD];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TD; ++j) pv[i][j] = 0.f;
        for (int t = 0; t < bs; ++t) {
          const int c = pg * bs + t;
          float vv[TD];
          if constexpr (TD == 4) {
            const float4 v4 =
                *reinterpret_cast<const float4*>(vs + (size_t)c * hd + d0);
            vv[0] = v4.x;
            vv[1] = v4.y;
            vv[2] = v4.z;
            vv[3] = v4.w;
          } else {
#pragma unroll
            for (int j = 0; j < TD; ++j) vv[j] = vs[(size_t)c * hd + d0 + j];
          }
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float pr = sc[(size_t)(r0 + i) * CH + c];
#pragma unroll
            for (int j = 0; j < TD; ++j) pv[i][j] = fmaf(pr, vv[j], pv[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float al = alpha[pg * R + r0 + i];
#pragma unroll
          for (int j = 0; j < TD; ++j) a[i][j] = a[i][j] * al + pv[i][j];
        }
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j)
          acc[(size_t)(r0 + i) * hd + d0 + j] = a[i][j];
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < R * hd; e += blockDim.x) {
    const int r = e / hd, d = e % hd, gr = row0 + r;
    if (gr < total_rows) {
      float lr = l[r];
      if (lr == 0.f) lr = 1.f;  // rows that saw nothing: acc is 0
      const size_t off =
          (((size_t)s * p.tq + gr / g) * p.nh + kvh * g + gr % g) * hd + d;
      out[off] = from_f32<T>(acc[e] / lr);
    }
  }
}

template <typename T>
__global__ void paged_decode_kernel(Params p) {
  const int kvh = blockIdx.x, s = blockIdx.y;
  const int ctx = p.ctx[s];
  attend_rows<T, 1, 1, 1>(p, s, kvh, 0, ctx - 1, ctx);
}

template <typename T, int TR, int TC, int TD>
__global__ void paged_prefill_kernel(Params p) {
  const int tile = blockIdx.x, kvh = blockIdx.y, s = blockIdx.z;
  attend_rows<T, TR, TC, TD>(p, s, kvh, tile * p.rows, p.pos0[s], p.ctx[s]);
}

size_t smem_bytes(const Params& p) {
  const size_t R = p.rows, hd = p.hd, CH = (size_t)p.chunk_pages * p.bs;
  const size_t floats = 2 * R * hd + CH * (hd + 1) + CH * hd + R * CH +
                        (size_t)p.chunk_pages * R + 2 * R;
  return floats * sizeof(float) + R * sizeof(int);
}

int launch(void (*kernel)(Params), dim3 grid, int threads, const Params& p,
           void* stream) {
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;
  const size_t smem = smem_bytes(p);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the split decode (bf16, hd 128): spans of pages, a cp.async ring a warp
// ---------------------------------------------------------------------------

namespace pd_split {

constexpr int D = 128;                 // head dim
constexpr int R = 8;                   // query rows of a block (mma n)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;    // == D: the merges give a thread a d
constexpr int CT = 16;                 // tokens of a chunk (mma k)
constexpr int STAGES = 3;              // chunks in a warp's ring
constexpr int ROW = 2 * D + 16;        // bytes of a K or V row (16 padding)
constexpr int STAGE_BYTES = 2 * CT * ROW;
constexpr int RING_BYTES = WARPS * STAGES * STAGE_BYTES;

struct Args {
  const __nv_bfloat16* q;  // [S, nh, D]
  const uint8_t* kv;       // [nb, bs, 2, nkv, D] bf16
  const int* block_table;  // [S, Bm]
  const int* ctx;          // [S]
  __nv_bfloat16* out;      // [S, nh, D]
  float* part_acc;         // [S * nkv * groups, nsplit, R, D]
  float* part_ml;          // [S * nkv * groups, nsplit, R, 2]: m, l
  int* counters;           // [S * nkv * groups], 0 between launches
  int nh, nkv, nb, bs, Bm, span_pages, nsplit, groups;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8, and register j gets matrix j's (row lane / 4, columns
// 2 (lane % 4), + 1), or with .trans its transpose's
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(tc::smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(tc::smem_addr(p)));
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row-major) b (16 x 8 bf16). With
// gr = lane / 4, tq = lane % 4: a[0] (row gr, columns 2 tq, + 1), a[1]
// row gr + 8, a[2] and a[3] the same 8 columns on; b0 (rows 2 tq, + 1,
// column gr), b1 8 rows on; d[0], d[1] (row gr, columns 2 tq, + 1), d[2],
// d[3] row gr + 8. The lower half of a word holds the lower index.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Lane j (and j + 16) of the warp: the pool row of token c0 + j, or 0
// past `end`. The block-table read is issued a chunk ahead of its use
// (the copies' "memory" clobber would otherwise hold it back until the
// chunk before is issued, and the warp would wait on it every chunk).
__device__ __forceinline__ int chunk_row(const int* bt, int nb, int bs,
                                         int c0, int end, int lane) {
  const int col = c0 + lane % CT;
  return col < end ? min(max(__ldg(bt + col / bs), 0), nb - 1) * bs + col % bs
                   : 0;
}

// the warp's copies of chunk c0 (tokens c0 .. c0 + CT - 1 at the pool rows
// `row` of chunk_row, those at or past `end` zero-filled) into stage `st`
// (K rows, then V rows): lanes 0-15 bring 16-byte piece t of each token's
// K row, lanes 16-31 piece t of its V row. Token rows of the pool are
// tok_bytes apart; piece_off is the lane's piece within one.
__device__ __forceinline__ void load_chunk(const uint8_t* kv, int row,
                                           size_t tok_bytes, uint8_t* st,
                                           int c0, int end, size_t piece_off,
                                           int lane) {
  const int t = lane % CT, h = lane / CT;
  uint8_t* dst = st + h * CT * ROW + 16 * t;
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const int rj = __shfl_sync(0xffffffffu, row, j);
    const bool ok = c0 + j < end;
    cp_async16(dst + j * ROW, kv + (ok ? rj * tok_bytes + piece_off : 0), ok);
  }
}

// Fold the chunk in stage `st` into the warp's state. S = Q K^T on
// mma.sync with the R = 8 query rows padded to 16 (qa: row lane / 4's
// A fragments, unscaled bf16; rows 8-15 are 0) and the chunk's 16 tokens
// as two n8 tiles; O^T += V^T P^T with V^T from ldmatrix.trans and P^T
// the score fragment itself (lane holds row lane / 4, tokens 2 tq, + 1,
// 8 + 2 tq, + 1), p carried in fp32 as bf16 hi + lo through two products.
// m, l: row lane / 4's; o[mt]: d 16 mt + lane / 4 (+ 8) of rows 2 tq and
// 2 tq + 1.
__device__ __forceinline__ void fold_chunk(const uint8_t* st,
                                           const uint32_t (&qa)[8][2],
                                           float scale, int c0, int end,
                                           int lane, float& m, float& l,
                                           float (&o)[8][4]) {
  const int tq = lane % 4;
  // this lane's ldmatrix row: matrix mi = lane / 8 is tokens 8 (mi / 2)..
  // and d 8 (mi % 2).. of a 16-d step
  const int mi = lane / 8;
  const int off = ((mi / 2) * 8 + lane % 8) * ROW + (mi % 2) * 16;
  const uint8_t* krow = st + off;
  const uint8_t* vrow = st + CT * ROW + off;
  float sc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    uint32_t kb[4];
    ldmatrix_x4(kb, krow + 32 * k);
    mma_bf16(sc[0], qa[k][0], 0u, qa[k][1], 0u, kb[0], kb[1]);
    mma_bf16(sc[1], qa[k][0], 0u, qa[k][1], 0u, kb[2], kb[3]);
  }
  // the online softmax over the chunk's 16 columns of row lane / 4 (the
  // four lanes of a row hold four columns each)
  float s[4] = {sc[0][0] * scale, sc[0][1] * scale, sc[1][0] * scale,
                sc[1][1] * scale};
  bool vis[4];
  float mc = NEG_INF;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    vis[e] = c0 + (e / 2) * 8 + 2 * tq + e % 2 < end;
    if (!vis[e]) s[e] = NEG_INF;
    mc = fmaxf(mc, s[e]);
  }
  mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
  mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
  const float mn = fmaxf(m, mc);
  const float alpha = expf(m - mn);
  float p[4], sum = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // explicit zero for masked columns (as the TPU kernel)
    p[e] = vis[e] ? expf(s[e] - mn) : 0.f;
    sum += p[e];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  l = alpha * l + sum;
  m = mn;
  // P^T as the B operand, hi + lo
  uint32_t ph[2], pl[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(p[2 * j]);
    const __nv_bfloat16 h1 = __float2bfloat16_rn(p[2 * j + 1]);
    ph[j] = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
    pl[j] = pack_bf16(p[2 * j] - __bfloat162float(h0),
                      p[2 * j + 1] - __bfloat162float(h1));
  }
  // the accumulator's rows 2 tq and 2 tq + 1: their alphas sit in lanes
  // 8 tq and 8 tq + 4
  const float a0 = __shfl_sync(0xffffffffu, alpha, 8 * tq);
  const float a1 = __shfl_sync(0xffffffffu, alpha, 8 * tq + 4);
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) {
    o[mt][0] *= a0;
    o[mt][1] *= a1;
    o[mt][2] *= a0;
    o[mt][3] *= a1;
    uint32_t va[4];
    ldmatrix_x4_trans(va, vrow + 32 * mt);
    mma_bf16(o[mt], va[0], va[1], va[2], va[3], ph[0], ph[1]);
    mma_bf16(o[mt], va[0], va[1], va[2], va[3], pl[0], pl[1]);
  }
}

}  // namespace pd_split

__global__ void __launch_bounds__(pd_split::THREADS, 2)
    paged_decode_split_kernel(const pd_split::Args a) {
  using namespace pd_split;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int is_last;
  __shared__ float merged_l[R];

  const int split = blockIdx.x, kvg = blockIdx.y, s = blockIdx.z;
  const int kvh = kvg / a.groups, grp = kvg % a.groups;
  const int g = a.nh / a.nkv;
  const int head0 = kvh * g + grp * R;  // the block's first query head
  const int nr = min(R, g - grp * R);   // its real rows
  const int seq = s * a.nkv * a.groups + kvg;
  const int span = a.span_pages * a.bs;
  // columns past the block table's Bm pages are never visited
  const int lim = max(0, min(a.ctx[s], a.Bm * a.bs));
  const int n_live = (lim + span - 1) / span;
  const int start = split * span;
  __nv_bfloat16* out = a.out + ((size_t)s * a.nh + head0) * D;
  if (start >= lim) {
    if (lim == 0 && split == 0)  // a dead slot gives 0
      for (int e = threadIdx.x; e < nr * D; e += THREADS)
        out[e] = __float2bfloat16_rn(0.f);
    return;
  }
  const int end = min(start + span, lim);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nchunks = (end - start + CT - 1) / CT;
  const int mine = warp < nchunks ? (nchunks - warp + WARPS - 1) / WARPS : 0;
  uint8_t* ring = smem_raw;
  uint8_t* wring = ring + warp * STAGES * STAGE_BYTES;
  const int* bt = a.block_table + (size_t)s * a.Bm;
  const uint8_t* kv = a.kv;
  const int nb = a.nb, bs = a.bs;
  const size_t tok_bytes = (size_t)2 * a.nkv * D * 2;
  // this lane's 16-byte piece of a token: K (lanes 0-15) or V, at d 8 t
  const size_t piece_off = (size_t)kvh * D * 2 +
                           (lane / CT ? (size_t)a.nkv * D * 2 : 0) +
                           16 * (lane % CT);
  // chunk i of this warp starts at column c0_of(i); the page rows of the
  // first STAGES chunks are read together, then each a chunk ahead
  const auto c0_of = [=](int i) { return start + (warp + i * WARPS) * CT; };
  int rows[STAGES];
#pragma unroll
  for (int i = 0; i < STAGES; ++i)
    rows[i] = i < mine ? chunk_row(bt, nb, bs, c0_of(i), end, lane) : 0;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < mine)
      load_chunk(kv, rows[i], tok_bytes, wring + i * STAGE_BYTES, c0_of(i),
                 end, piece_off, lane);
    cp_async_commit();
  }
  int row_next = rows[STAGES - 1];
  // q row lane / 4 as A fragments (unscaled bf16 pairs), while the first
  // chunks load
  const int gr = lane / 4, tq = lane % 4;
  uint32_t qa[8][2];
  const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
      a.q + ((size_t)s * a.nh + head0 + gr) * D);
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    qa[k][0] = gr < nr ? qrow[8 * k + tq] : 0u;
    qa[k][1] = gr < nr ? qrow[8 * k + 4 + tq] : 0u;
  }

  float m = NEG_INF, l = 0.f, o[8][4];
#pragma unroll
  for (int mt = 0; mt < 8; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  for (int i = 0; i < mine; ++i) {
    // the stage chunk i - 1 left: every lane is past it (the __syncwarp
    // that ends each iteration)
    const int nxt = i + STAGES - 1;
    if (nxt < mine)
      load_chunk(kv, row_next, tok_bytes,
                 wring + (nxt % STAGES) * STAGE_BYTES, c0_of(nxt), end,
                 piece_off, lane);
    cp_async_commit();
    if (nxt + 1 < mine)
      row_next = chunk_row(bt, nb, bs, c0_of(nxt + 1), end, lane);
    cp_async_wait<STAGES - 1>();  // this lane's copies of chunk i landed
    __syncwarp();                 // and every lane's
    fold_chunk(wring + (i % STAGES) * STAGE_BYTES, qa, a.scale, c0_of(i),
               end, lane, m, l, o);
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the merges from here on

  // merge the warps' states (a warp with no chunk holds m = NEG_INF,
  // l = 0, acc = 0 and weighs exactly 0; warp 0 always has the span's
  // first, visible, column)
  float* wm = reinterpret_cast<float*>(ring);  // [W][R]
  float* wl = wm + WARPS * R;                  // [W][R]
  float* wacc = wl + WARPS * R;                // [W][R][D]
  if (tq == 0) {
    wm[warp * R + gr] = m;
    wl[warp * R + gr] = l;
  }
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) {
    float* r0 = wacc + (warp * R + 2 * tq) * D + 16 * mt + gr;
    r0[0] = o[mt][0];
    r0[D] = o[mt][1];
    r0[8] = o[mt][2];
    r0[D + 8] = o[mt][3];
  }
  __syncthreads();
  const int d = threadIdx.x;
  float bm[R], bl[R], ba[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float M = wm[r];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) M = fmaxf(M, wm[w * R + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(wm[w * R + r] - M);
      L += wt * wl[w * R + r];
      A += wt * wacc[(w * R + r) * D + d];
    }
    bm[r] = M;
    bl[r] = L;
    ba[r] = A;
  }
  if (n_live == 1) {  // the sequence's only live span: write out
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nr) out[r * D + d] = __float2bfloat16_rn(ba[r] / bl[r]);
    return;
  }

  // write this span's state, then take a ticket; the last span to arrive
  // merges them all
  const size_t pb = (size_t)seq * a.nsplit;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= nr) break;
    a.part_acc[((pb + split) * R + r) * D + d] = ba[r];
    if (d == 0) {
      a.part_ml[((pb + split) * R + r) * 2] = bm[r];
      a.part_ml[((pb + split) * R + r) * 2 + 1] = bl[r];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int ticket = atomicAdd(a.counters + seq, 1);
    is_last = ticket == n_live - 1;
    if (is_last) a.counters[seq] = 0;  // zero again for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // spans 0 .. n_live - 1 in ascending order: weights and L per row
  float* sm = reinterpret_cast<float*>(ring);  // [n_live][R]: m, then w
  float* sl = sm + n_live * R;                 // [n_live][R]
  const float* pml = a.part_ml + pb * R * 2;
  for (int e = threadIdx.x; e < n_live * R; e += THREADS) {
    if (e % R >= nr) continue;
    sm[e] = __ldcg(pml + 2 * e);
    sl[e] = __ldcg(pml + 2 * e + 1);
  }
  __syncthreads();
  if (threadIdx.x < nr) {
    const int r = threadIdx.x;
    float M = sm[r];
    for (int i = 1; i < n_live; ++i) M = fmaxf(M, sm[i * R + r]);
    float L = 0.f;
    for (int i = 0; i < n_live; ++i) {
      const float wt = expf(sm[i * R + r] - M);
      sm[i * R + r] = wt;
      L += wt * sl[i * R + r];
    }
    merged_l[r] = L;
  }
  __syncthreads();
  // a warp a row (rows r, r + 4), a lane 4 d; 8 spans' loads in flight
  const int d4 = 4 * lane;
  for (int r = warp; r < nr; r += WARPS) {
    const float* pacc = a.part_acc + (pb * R + r) * D + d4;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int i = 0; i < n_live; ++i) {
      const float4 x = __ldcg(
          reinterpret_cast<const float4*>(pacc + (size_t)i * R * D));
      const float wt = sm[i * R + r];
      A.x += wt * x.x;
      A.y += wt * x.y;
      A.z += wt * x.z;
      A.w += wt * x.w;
    }
    const float L = merged_l[r];
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + r * D + d4);
    o2[0] = __floats2bfloat162_rn(A.x / L, A.y / L);
    o2[1] = __floats2bfloat162_rn(A.z / L, A.w / L);
  }
}

int launch_decode_split(const pd_split::Args& a, int S, cudaStream_t stream) {
  constexpr int smem = pd_split::RING_BYTES;
  // the span merge keeps two floats a (span, row) in the ring
  if (2 * a.nsplit * pd_split::R * 4 > pd_split::RING_BYTES)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      paged_decode_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.nsplit, a.nkv * a.groups, S);
  paged_decode_split_kernel<<<grid, pd_split::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the prefill on the tensor cores (bf16, hd 128): wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace pp_tc {

using attn_tc::BKV;
using attn_tc::D;
using attn_tc::HALF;
using attn_tc::KV_BYTES;
constexpr int STAGES = 2;

// NWG consumer warpgroups of 64 query rows and one producer warp
template <int NWG>
struct Shape {
  static constexpr int BQ = 64 * NWG;
  static constexpr int THREADS = 128 * NWG + 32;
  static constexpr int Q_HALF = BQ * 128;  // bytes of a [BQ][64 d] box
  static constexpr int Q_BYTES = 2 * Q_HALF;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // 1 KB to align to the swizzle atom, Q, the ring, the barriers
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * STAGE_BYTES + 8 * (1 + 3 * STAGES);
};

struct Args {
  const int* block_table;  // [S, Bm]
  const int* pos0;         // [S]
  const int* ctx;          // [S]
  __nv_bfloat16* out;      // [S, Tq, nh, hd]
  int tq, nh, nkv, nb, bs, Bm;
  float scale;
};

}  // namespace pp_tc

template <int NWG>
__global__ void __launch_bounds__(pp_tc::Shape<NWG>::THREADS, 1)
    paged_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap kv_map,
                               const pp_tc::Args a) {
  using namespace pp_tc;
  using Sh = Shape<NWG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = qs + Sh::Q_BYTES;
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(ring + STAGES * Sh::STAGE_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int kvh = blockIdx.y, s = blockIdx.z;
  const int g = a.nh / a.nkv, rows = a.tq * g;
  const int row0 = blockIdx.x * Sh::BQ;
  const int pos0 = a.pos0[s], ctx = a.ctx[s];
  // columns past the block table's Bm pages are never visited (as in the
  // TPU kernel's grid); the tile's last row sees up to pos0 + its query
  const int lim = min(ctx, a.Bm * a.bs);
  const int last_row = min(row0 + Sh::BQ, rows) - 1;
  const int col_end = max(0, min(lim, pos0 + last_row / g + 1));
  const int nk = (col_end + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    tc::mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      tc::mbar_init(&k_full[st], 1);
      tc::mbar_init(&v_full[st], 1);
      tc::mbar_init(&empty[st], NWG);
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NWG) {  // producer warp
    const int lane = threadIdx.x % 32;
    if (nk == 0) return;
    if (lane == 0) {
      tc::mbar_arrive_expect_tx(q_full, Sh::Q_BYTES);
      tc::tma_load_4d(qs, &q_map, q_full, 0, kvh * g, row0 / g, s);
      tc::tma_load_4d(qs + Sh::Q_HALF, &q_map, q_full, 64, kvh * g,
                      row0 / g, s);
    }
    const int ppt = BKV / a.bs;                     // pages a tile
    const int last_page = (col_end - 1) / a.bs;     // the last one seen
    const int* bt = a.block_table + (long long)s * a.Bm;
    for (int it = 0; it < nk; ++it) {
      const int st = it % STAGES;
      if (it >= STAGES) tc::mbar_wait(&empty[st], (it / STAGES - 1) & 1);
      uint8_t* ks = ring + st * Sh::STAGE_BYTES;
      uint8_t* vs = ks + KV_BYTES;
      if (lane == 0) {
        tc::mbar_arrive_expect_tx(&k_full[st], KV_BYTES);
        tc::mbar_arrive_expect_tx(&v_full[st], KV_BYTES);
      }
      __syncwarp();
      // lane p loads page slot p of the tile: 128 / bs slots of bs rows
      for (int p = lane; p < ppt; p += 32) {
        const int j = min(it * ppt + p, last_page);
        const int tok = min(max(bt[j], 0), a.nb - 1) * a.bs;
        const int off = p * a.bs * 128;
        tc::tma_load_4d(ks + off, &kv_map, &k_full[st], 0, kvh, 0, tok);
        tc::tma_load_4d(ks + HALF + off, &kv_map, &k_full[st], 64, kvh, 0,
                        tok);
        tc::tma_load_4d(vs + off, &kv_map, &v_full[st], 0, kvh, 1, tok);
        tc::tma_load_4d(vs + HALF + off, &kv_map, &v_full[st], 64, kvh, 1,
                        tok);
      }
    }
    return;
  }

  // the m64n128k16 fragment (attention_tc.cuh): rows r_lo and r_lo + 8 of
  // the segment's query-major, group-minor rows; row r is query r / g
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const int q4 = lane % 4;
  const int row_first = row0 + 64 * wg;
  const int r_lo = row_first + (tid / 32) * 16 + lane / 4;
  // the absolute position of each row's query; rows past Tq * g see
  // nothing
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_lo + 8 * hh;
    qpos[hh] = r < rows ? pos0 + r / g : -1;
  }
  const int qpos_first = row_first < rows ? pos0 + row_first / g : -1;
  const float scale2 = a.scale * attn_tc::LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  const uint8_t* qw = qs + wg * 64 * 128;  // this warpgroup's rows
  if (nk > 0) {
    tc::mbar_wait(q_full, 0);
    // 0 goes first
    if (NWG == 2 && wg == 1)
      tc::named_barrier_arrive(attn_tc::BAR_TURN, 256);
  }

  for (int it = 0; it < nk; ++it) {
    const int st = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const int col0 = it * BKV;
    const uint8_t* ks = ring + st * Sh::STAGE_BYTES;
    const uint8_t* vs = ks + KV_BYTES;

    float sc[64];
    tc::mbar_wait(&k_full[st], parity);
    attn_tc::qk_scores<NWG>(sc, qw, Sh::Q_HALF, ks, wg);
    // visibility on the tiles that reach past the first row's position
    // or the context
    uint32_t vis[2] = {~0u, ~0u};
    if (col0 + BKV - 1 > qpos_first || col0 + BKV > lim) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * j + 2 * q4 + e;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            if (!(col < lim && col <= qpos[hh]))
              vis[hh] &= ~(1u << (2 * j + e));
        }
    }
    attn_tc::online_softmax(sc, vis, scale2, m, l, o);
    uint32_t pa[2][8][4];
    attn_tc::pack_p_split(sc, pa);  // p stays fp32 as hi + lo
    tc::mbar_wait(&v_full[st], parity);
    attn_tc::pv_product<NWG, 2>(o, pa, vs, wg, !(wg == 1 && it == nk - 1));
    if (tid == 0) tc::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_lo + 8 * hh;
    if (r < rows)
      attn_tc::store_row(
          a.out + (((long long)s * a.tq + r / g) * a.nh + kvh * g + r % g) * D,
          o, hh, l[hh], q4);
  }
}

template <int NWG>
int launch_prefill_wgmma(const CUtensorMap& q_map, const CUtensorMap& kv_map,
                         const pp_tc::Args& a, int S, cudaStream_t stream) {
  using Sh = pp_tc::Shape<NWG>;
  const int rows = a.tq * (a.nh / a.nkv);
  const cudaError_t e = cudaFuncSetAttribute(
      paged_prefill_wgmma_kernel<NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((rows + Sh::BQ - 1) / Sh::BQ, a.nkv, S);
  paged_prefill_wgmma_kernel<NWG><<<grid, Sh::THREADS, Sh::SMEM, stream>>>(
      q_map, kv_map, a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int dstpu_paged_decode(int dtype, const void* q, const void* kv,
                                  const void* block_table, const void* ctx,
                                  void* out, int S, int nh, int nkv, int hd,
                                  int nb, int bs, int Bm, int chunk_pages,
                                  float scale, void* stream) {
  const Params p{q, kv, static_cast<const int*>(block_table), nullptr,
                 static_cast<const int*>(ctx), out, S, 1, nh, nkv, hd, nb,
                 bs, Bm, nh / nkv, chunk_pages, scale};
  const dim3 grid(nkv, S);
  if (dtype == 0) return launch(paged_decode_kernel<float>, grid, 256, p, stream);
  if (dtype == 1)
    return launch(paged_decode_kernel<__nv_bfloat16>, grid, 256, p, stream);
  return (int)cudaErrorInvalidValue;
}

// The split decode: bf16 q [S, nh, 128] and pool [nb, bs, 2, nkv, 128],
// both contiguous and 16-byte aligned, nb * bs < 2^31 (the wrapper checks
// all of it). span_pages comes from the host (shapes only); `part` holds
// S * nkv * groups * nsplit * 8 * 130 floats (acc, then m and l) and
// `counters` S * nkv * groups ints that are 0 (the kernel leaves them 0),
// with groups = ceil(g / 8) blocks of 8 query rows a kv head and
// nsplit = ceil(Bm / span_pages). Returns a cudaError_t (0 = launched).
extern "C" int dstpu_paged_decode_split(const void* q, const void* kv,
                                        const void* block_table,
                                        const void* ctx, void* out,
                                        void* part, void* counters, int S,
                                        int nh, int nkv, int nb, int bs,
                                        int Bm, int span_pages, float scale,
                                        void* stream) {
  if (S == 0) return 0;
  if (span_pages < 1 || nkv < 1 || nh % nkv != 0)
    return (int)cudaErrorInvalidValue;
  const int groups = (nh / nkv + pd_split::R - 1) / pd_split::R;
  const int nsplit = Bm > 0 ? (Bm + span_pages - 1) / span_pages : 1;
  float* part_acc = static_cast<float*>(part);
  float* part_ml = part_acc + (size_t)S * nkv * groups * nsplit *
                                  pd_split::R * pd_split::D;
  const pd_split::Args a{static_cast<const __nv_bfloat16*>(q),
                         static_cast<const uint8_t*>(kv),
                         static_cast<const int*>(block_table),
                         static_cast<const int*>(ctx),
                         static_cast<__nv_bfloat16*>(out),
                         part_acc,
                         part_ml,
                         static_cast<int*>(counters),
                         nh, nkv, nb, bs, Bm, span_pages, nsplit, groups,
                         scale};
  return launch_decode_split(a, S, static_cast<cudaStream_t>(stream));
}

extern "C" int dstpu_paged_prefill(int dtype, const void* q, const void* kv,
                                   const void* block_table, const void* pos0,
                                   const void* ctx, void* out, int S, int tq,
                                   int nh, int nkv, int hd, int nb, int bs,
                                   int Bm, int rows, int chunk_pages,
                                   float scale, void* stream) {
  const Params p{q, kv, static_cast<const int*>(block_table),
                 static_cast<const int*>(pos0), static_cast<const int*>(ctx),
                 out, S, tq, nh, nkv, hd, nb, bs, Bm, rows, chunk_pages,
                 scale};
  const int tiles = (tq * (nh / nkv) + rows - 1) / rows;
  const dim3 grid(tiles, nkv, S);
  // 4 x 2 score tiles and 4 x 4 accumulator tiles where the shapes allow
  // (the float4 V reads need hd and the chunk to be multiples of 4)
  const bool tiled =
      rows % 4 == 0 && (chunk_pages * bs) % 4 == 0 && hd % 4 == 0;
  if (dtype == 0)
    return launch(tiled ? paged_prefill_kernel<float, 4, 2, 4>
                        : paged_prefill_kernel<float, 1, 1, 1>,
                  grid, 256, p, stream);
  if (dtype == 1)
    return launch(tiled ? paged_prefill_kernel<__nv_bfloat16, 4, 2, 4>
                        : paged_prefill_kernel<__nv_bfloat16, 1, 1, 1>,
                  grid, 256, p, stream);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core prefill: bf16 q [S, Tq, nh, 128] and pool
// [nb, bs, 2, nkv, 128], both contiguous and 16-byte aligned, bs in
// {8, 16, 32, 64, 128}, g = nh / nkv dividing 128 (the wrapper checks all
// of it). Returns a cudaError_t or one of hopper.cuh's negative
// tensor-map codes (0 = launched).
extern "C" int dstpu_paged_prefill_wgmma(const void* q, const void* kv,
                                         const void* block_table,
                                         const void* pos0, const void* ctx,
                                         void* out, int S, int tq, int nh,
                                         int nkv, int nb, int bs, int Bm,
                                         float scale, void* stream) {
  if (S == 0 || tq == 0) return 0;
  const tc::EncodeTiled enc = tc::encode_tiled();
  if (enc == nullptr) return tc::ERR_NO_ENCODE;
  const int g = nh / nkv;
  // 128-row tiles, or one 64-row tile where the segment's rows fit in it
  const int nwg = tq * g <= 64 ? 1 : 2;
  const cuuint64_t row = (cuuint64_t)pp_tc::D * 2;  // bytes of a head row
  CUtensorMap q_map, kv_map;
  const cuuint64_t q_dims[4] = {pp_tc::D, (cuuint64_t)nh, (cuuint64_t)tq,
                                (cuuint64_t)S};
  const cuuint64_t q_strides[3] = {row, row * nh, row * nh * tq};
  const cuuint32_t q_box[4] = {64, (cuuint32_t)g, (cuuint32_t)(64 * nwg / g),
                               1};
  const cuuint64_t kv_dims[4] = {pp_tc::D, (cuuint64_t)nkv, 2,
                                 (cuuint64_t)nb * bs};
  const cuuint64_t kv_strides[3] = {row, row * nkv, row * nkv * 2};
  const cuuint32_t kv_box[4] = {64, 1, 1, (cuuint32_t)bs};
  if (!tc::encode(enc, &q_map, q, 4, q_dims, q_strides, q_box) ||
      !tc::encode(enc, &kv_map, kv, 4, kv_dims, kv_strides, kv_box))
    return tc::ERR_TENSOR_MAP;
  pp_tc::Args a{static_cast<const int*>(block_table),
                static_cast<const int*>(pos0), static_cast<const int*>(ctx),
                static_cast<__nv_bfloat16*>(out), tq, nh, nkv, nb, bs, Bm,
                scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return nwg == 1 ? launch_prefill_wgmma<1>(q_map, kv_map, a, S, st)
                  : launch_prefill_wgmma<2>(q_map, kv_map, a, S, st);
}

extern "C" const char* dstpu_cuda_error_string(int code) {
  return tc::error_string(code);
}
