// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_wgmma_kernel <- _fwd_kernel     (:150, pallas_call in _flash_fwd
//                             :238), bf16 with head dim 128
//   flash_fwd_kernel      <- the same, for fp32, head dim 64 and strides TMA
//                            cannot take
//   flash_bwd_dkdv_wgmma_kernel <- _bwd_dkdv_kernel (:268, pallas_call in
//                                  _flash_bwd :414), bf16 with head dim 128
//   flash_bwd_dq_wgmma_kernel   <- _bwd_dq_kernel   (:326, pallas_call in
//                                  _flash_bwd :466), bf16 with head dim 128
//   flash_bwd_dkdv_kernel, flash_bwd_dq_kernel <- the same two, for fp32,
//                            head dim 64 and strides TMA cannot take
//
// What they compute (the TPU kernels' function, not their block structure):
//   forward   s = q.k * scale, masked to NEG_INF = -1e30 where a column is not
//             visible; fp32 online softmax over key tiles (running max m,
//             denominator l, accumulator acc); p is rounded to the input type
//             before p @ V, l sums the fp32 p. O = acc / l (l == 0 gives 0)
//             in the input type, lse = m + log(l) in fp32.
//   dK / dV   p = exp(s - lse), dV += p^T dO, ds = p * (dO.V - delta),
//             dK += ds^T Q * scale, summed over the kv head's whole q-head
//             group and every q row that sees the key.
//   dQ        dQ = sum over key tiles of ds K * scale.
//   p is rounded to the input type before dV, ds before dK and dQ; every
//   sum is fp32. delta = rowsum(dO * O) comes in from the caller (the JAX
//   wrapper computes it outside the kernels too, :377).
// Visibility of key column c to query row r: c < S, r < S, c <= r when
// causal, and seg[r] == seg[c] when segment ids are given. GQA: q head h
// reads kv head h / (Hq / Hkv) (_kv_row :123).
//
// Layouts (the JAX wrapper's public ones, read in place): q, dO
// [B, S, Hq, D] and k, v [B, S, Hkv, D] at any (batch, seq, head) strides
// with unit stride over D; seg [B, S] int32; lse and delta [B, Hq, S]
// fp32; O and dQ are written [B, S, Hq, D], dK and dV [B, S, Hkv, D],
// contiguous.
//
// Design. The TPU kernels walk a packed lower-triangle work list in a
// sequential grid and carry m/l/acc (or dK/dV, dQ) in VMEM from one grid
// step to the next, on S padded to a block multiple and transposed to
// [B*H, S, D]. Here every thread block owns its output tile and loops over
// the tiles it needs itself, so nothing is carried between blocks and no
// atomics are used (the results are deterministic):
//   forward: one block per (b, q head, 64-row q tile), key tiles 0 up to
//            the diagonal (all tiles when not causal);
//   dK/dV:   one block per (b, kv head, 64-column key tile), looping the
//            group's q heads x q tiles from the diagonal to the end;
//   dQ:      one block per (b, q head, 64-row q tile), key tiles up to the
//            diagonal.
// Blocks with the most tiles launch first. Columns and rows at or past S
// are masked here (their shared-memory rows are zero-filled), so S needs
// no padding. Tiles live in shared memory as fp32, row-major with one
// float of padding per row (row stride D + 1) so that the 16 threads that
// read 16 different rows at one d hit 16 different banks. 256 threads as
// 16 x 16: thread (ty, tx) owns score rows ty + 16 i and columns tx + 16 j
// (i, j < 4) and output columns tx + 16 k; a row's max and sum reduce over
// the 16 lanes of a half warp with shuffles. All arithmetic is scalar
// fp32 FMA on the CUDA cores: no tensor cores, no TMA, no warp
// specialisation. That is the simple first version; every fp32 or
// head-dim-64 call still runs it.
//
// The tensor-core forward (flash_fwd_wgmma_kernel; bf16, D 128, 16-byte
// aligned data and strides). One block per (q head, batch, 128-row q
// tile), the longest causal tiles first over every head: two consumer
// warpgroups of 64 q rows and one producer warp. TMA brings Q once and K
// and V tiles of 128 keys through a 2-stage ring (full and empty
// mbarriers), from 4-D tensor maps over the tensors as they lie (d, then
// head, seq and batch ordered by stride; rows >= S zero-filled), each as
// two [128][64] boxes in 128-byte swizzle. S = Q K^T is wgmma m64n128k16
// with both operands K-major in shared memory (gmm^T's B layout); the
// softmax runs on the fp32 fragment in registers (a row's max and sum over
// the 4 lanes of a quad), with the visibility mask applied only on the
// tiles that need it (the causal diagonal, the tail past S, every tile
// with segment ids, read per tile from global memory); p rounded to bf16
// and packed pairwise is the register A fragment of O += P V (the
// FlashAttention-3 layout identity), with V N-major in shared memory
// (gmm's B layout, the transpose immediate). The two warpgroups take
// turns to issue their products (named barriers: one's softmax overlaps
// the other's products); within a warpgroup softmax and products do not
// overlap yet. The softmax works in log2 units (scores times scale *
// log2 e, exp2), one FFMA and one MUFU op a probability. Same function as
// the scalar forward, with key tiles of 128 rather than 64 (the running
// max, and so p's bf16 rounding, moves at other columns).
// The consumer step (S = Q K^T, the softmax, P from registers, O += P V,
// the turns) lives in attention_tc.cuh, shared with the block-sparse
// forward and paged prefill.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): causal forward
// does 4 * B * Hq * D * S(S+1)/2 flops, dK/dV twice that, dQ 1.5 times.
// At B 2, S 2048, Hq 32, Hkv 8, D 128 that is 68.8 GFLOP forward (70 us at
// the tensor-core rate) against ~67 MB moved (20 us): bound by operations.
// Scalar fp32 FMAs peak at 67 TFLOP/s and shared-memory loads hold the
// scalar version well below that, so expect tens of times the bound. The
// two tensor-core backward kernels recompute S and dP each (14 D flops a
// visible pair in all, against 10 for one fused kernel whose dQ would
// need atomics or a second pass).

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
  const void* dout;   // backward only
  const int* seg;     // [B, S] or null
  const float* lse;   // backward input [B, Hq, S]
  const float* delta; // backward input [B, Hq, S]
  void* out;          // forward O, or dQ
  float* lse_out;     // forward output [B, Hq, S]
  void* dk;
  void* dv;
  long long qst[3], kst[3], vst[3], dost[3];  // (batch, seq, head) strides
  int B, S, Hq, Hkv, causal;
  float scale;
};

__device__ __forceinline__ bool visible(const Params& p, int row, int col,
                                        int seg_row, int seg_col) {
  return row < p.S && col < p.S && (!p.causal || col <= row) &&
         seg_row == seg_col;
}

// segment id of position s of batch b; without segment ids every
// position shares one segment
__device__ __forceinline__ int seg_at(const Params& p, int b, int s) {
  return (p.seg != nullptr && s < p.S) ? p.seg[(long long)b * p.S + s] : 0;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DT = D / 16;
  float* qs = smem;              // [TILE][LD]
  float* ks = qs + TILE * LD;    // [TILE][LD]; the P tile reuses it
  float* vs = ks + TILE * LD;    // [TILE][LD]
  float* ps = ks;                // [TILE][LDP]

  const int nq = (p.S + TILE - 1) / TILE;
  const int iq = nq - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = iq * TILE;

  load_tile<T, D>(qs, p.q, p.qst, b, h, row0, p.S);
  float acc[RT][DT], m[RT], l[RT];
  int row[RT], segr[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    row[i] = row0 + ty + 16 * i;
    segr[i] = seg_at(p, b, row[i]);
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DT; ++k) acc[i][k] = 0.f;
  }

  const int nk_all = nq;  // square tiles
  const int nk = p.causal ? min(iq + 1, nk_all) : nk_all;
  for (int ik = 0; ik < nk; ++ik) {
    const int col0 = ik * TILE;
    __syncthreads();  // the previous tile's P and V reads are done
    load_tile<T, D>(ks, p.k, p.kst, b, hk, col0, p.S);
    load_tile<T, D>(vs, p.v, p.vst, b, hk, col0, p.S);
    int col[RT], segc[RT];
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      col[j] = col0 + tx + 16 * j;
      segc[j] = seg_at(p, b, col[j]);
    }
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
        vis[j] = visible(p, row[i], col[j], segr[i], segc[j]);
        s[i][j] = vis[j] ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        // an exact 0 for masked columns: while every score so far is
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
    for (int k = 0; k < DT; ++k) out[o + tx + 16 * k] = from_f32<T>(acc[i][k] / ls);
    if (tx == 0)
      p.lse_out[((long long)b * p.Hq + h) * p.S + row[i]] = m[i] + logf(ls);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DT = D / 16;
  float* ks = smem;               // [TILE][LD] this block's keys
  float* vs = ks + TILE * LD;     // [TILE][LD]
  float* qs = vs + TILE * LD;     // [TILE][LD] the current q tile
  float* dos = qs + TILE * LD;    // [TILE][LD]
  float* pt = dos + TILE * LD;    // [TILE][LDP] p^T: rows keys, columns q
  float* dst = pt + TILE * LDP;   // [TILE][LDP] ds^T

  const int ik = blockIdx.x;  // the keys seen by the most rows first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = p.Hq / p.Hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int col0 = ik * TILE;
  const int nq = (p.S + TILE - 1) / TILE;

  load_tile<T, D>(ks, p.k, p.kst, b, hk, col0, p.S);
  load_tile<T, D>(vs, p.v, p.vst, b, hk, col0, p.S);
  float dk[RT][DT], dv[RT][DT];
  int col[RT], segc[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    col[i] = col0 + ty + 16 * i;
    segc[i] = seg_at(p, b, col[i]);
#pragma unroll
    for (int k = 0; k < DT; ++k) dk[i][k] = dv[i][k] = 0.f;
  }

  for (int mem = 0; mem < g; ++mem) {
    const int h = hk * g + mem;
    const float* lse = p.lse + ((long long)b * p.Hq + h) * p.S;
    const float* delta = p.delta + ((long long)b * p.Hq + h) * p.S;
    for (int iq = p.causal ? ik : 0; iq < nq; ++iq) {
      const int row0 = iq * TILE;
      __syncthreads();  // the previous q tile's reads are done
      load_tile<T, D>(qs, p.q, p.qst, b, h, row0, p.S);
      load_tile<T, D>(dos, p.dout, p.dost, b, h, row0, p.S);
      int row[RT], segr[RT];
      float lr[RT], dr[RT];
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        row[j] = row0 + tx + 16 * j;
        segr[j] = seg_at(p, b, row[j]);
        lr[j] = row[j] < p.S ? lse[row[j]] : 0.f;
        dr[j] = row[j] < p.S ? delta[row[j]] : 0.f;
      }
      __syncthreads();
      float s[RT][RT], dp[RT][RT];
      dot_tile<D>(ks, qs, s, ty, tx);   // s[i][j] = k_col(i) . q_row(j)
      dot_tile<D>(vs, dos, dp, ty, tx); // dp[i][j] = v_col(i) . dO_row(j)
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const bool vis = visible(p, row[j], col[i], segr[j], segc[i]);
          const float pv = vis ? expf(s[i][j] * p.scale - lr[j]) : 0.f;
          const float ds = pv * (dp[i][j] - dr[j]);
          pt[(ty + 16 * i) * LDP + tx + 16 * j] = round_to<T>(pv);
          dst[(ty + 16 * i) * LDP + tx + 16 * j] = round_to<T>(ds);
        }
      __syncthreads();
      mul_tile<D>(pt, dos, dv, ty, tx);  // dV[c] += sum_r p[r][c] dO[r]
      mul_tile<D>(dst, qs, dk, ty, tx);  // dK[c] += sum_r ds[r][c] Q[r]
    }
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    if (col[i] >= p.S) continue;
    const long long o = (((long long)b * p.S + col[i]) * p.Hkv + hk) * D;
#pragma unroll
    for (int k = 0; k < DT; ++k) {
      dk_out[o + tx + 16 * k] = from_f32<T>(dk[i][k] * p.scale);
      dv_out[o + tx + 16 * k] = from_f32<T>(dv[i][k]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DT = D / 16;
  float* qs = smem;               // [TILE][LD] this block's q rows
  float* dos = qs + TILE * LD;    // [TILE][LD]
  float* ks = dos + TILE * LD;    // [TILE][LD] the current key tile
  float* vs = ks + TILE * LD;     // [TILE][LD]
  float* dss = vs + TILE * LD;    // [TILE][LDP] ds: rows q, columns keys

  const int nq = (p.S + TILE - 1) / TILE;
  const int iq = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = iq * TILE;
  const float* lse = p.lse + ((long long)b * p.Hq + h) * p.S;
  const float* delta = p.delta + ((long long)b * p.Hq + h) * p.S;

  load_tile<T, D>(qs, p.q, p.qst, b, h, row0, p.S);
  load_tile<T, D>(dos, p.dout, p.dost, b, h, row0, p.S);
  float dq[RT][DT], lr[RT], dr[RT];
  int row[RT], segr[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    row[i] = row0 + ty + 16 * i;
    segr[i] = seg_at(p, b, row[i]);
    lr[i] = row[i] < p.S ? lse[row[i]] : 0.f;
    dr[i] = row[i] < p.S ? delta[row[i]] : 0.f;
#pragma unroll
    for (int k = 0; k < DT; ++k) dq[i][k] = 0.f;
  }

  const int nk = p.causal ? min(iq + 1, nq) : nq;
  for (int ik = 0; ik < nk; ++ik) {
    const int col0 = ik * TILE;
    __syncthreads();  // the previous tile's ds and K reads are done
    load_tile<T, D>(ks, p.k, p.kst, b, hk, col0, p.S);
    load_tile<T, D>(vs, p.v, p.vst, b, hk, col0, p.S);
    int col[RT], segc[RT];
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      col[j] = col0 + tx + 16 * j;
      segc[j] = seg_at(p, b, col[j]);
    }
    __syncthreads();
    float s[RT][RT], dp[RT][RT];
    dot_tile<D>(qs, ks, s, ty, tx);    // s[i][j] = q_row(i) . k_col(j)
    dot_tile<D>(dos, vs, dp, ty, tx);  // dp[i][j] = dO_row(i) . v_col(j)
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const bool vis = visible(p, row[i], col[j], segr[i], segc[j]);
        const float pv = vis ? expf(s[i][j] * p.scale - lr[i]) : 0.f;
        dss[(ty + 16 * i) * LDP + tx + 16 * j] =
            round_to<T>(pv * (dp[i][j] - dr[i]));
      }
    __syncthreads();
    mul_tile<D>(dss, ks, dq, ty, tx);  // dQ[r] += sum_c ds[r][c] K[c]
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    if (row[i] >= p.S) continue;
    const long long o = (((long long)b * p.S + row[i]) * p.Hq + h) * D;
#pragma unroll
    for (int k = 0; k < DT; ++k) out[o + tx + 16 * k] = from_f32<T>(dq[i][k] * p.scale);
  }
}

template <int D>
constexpr size_t tile_bytes() {
  return (size_t)TILE * (D + 1) * sizeof(float);
}
constexpr size_t score_bytes = (size_t)TILE * LDP * sizeof(float);

int launch(void (*kernel)(Params), dim3 grid, size_t smem, const Params& p,
           void* stream) {
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_kind(int kind, const Params& p, void* stream) {
  const int n = (p.S + TILE - 1) / TILE;
  switch (kind) {
    case 0:  // forward
      return launch(flash_fwd_kernel<T, D>, dim3(n, p.Hq, p.B),
                    3 * tile_bytes<D>(), p, stream);
    case 1:  // dK / dV
      return launch(flash_bwd_dkdv_kernel<T, D>, dim3(n, p.Hkv, p.B),
                    4 * tile_bytes<D>() + 2 * score_bytes, p, stream);
    case 2:  // dQ
      return launch(flash_bwd_dq_kernel<T, D>, dim3(n, p.Hq, p.B),
                    4 * tile_bytes<D>() + score_bytes, p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(int kind, int dtype, int hd, const Params& p, void* stream) {
  if (dtype == 0 && hd == 64) return launch_kind<float, 64>(kind, p, stream);
  if (dtype == 0 && hd == 128) return launch_kind<float, 128>(kind, p, stream);
  if (dtype == 1 && hd == 64)
    return launch_kind<__nv_bfloat16, 64>(kind, p, stream);
  if (dtype == 1 && hd == 128)
    return launch_kind<__nv_bfloat16, 128>(kind, p, stream);
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* seg, const void* lse,
                   const void* delta, void* out, void* lse_out, void* dk,
                   void* dv, const long long* strides, int B, int S, int Hq,
                   int Hkv, int causal, float scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.seg = static_cast<const int*>(seg);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = out;
  p.lse_out = static_cast<float*>(lse_out);
  p.dk = dk;
  p.dv = dv;
  for (int i = 0; i < 3; ++i) {
    p.qst[i] = strides[i];
    p.kst[i] = strides[3 + i];
    p.vst[i] = strides[6 + i];
    p.dost[i] = strides[9 + i];
  }
  p.B = B;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.scale = scale;
  return p;
}


// ---------------------------------------------------------------------------
// the forward on the tensor cores (bf16, D 128): wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace fwd_tc {

using attn_tc::BAR_TURN;
using attn_tc::BKV;
using attn_tc::D;
using attn_tc::HALF;
using attn_tc::KV_BYTES;
using attn_tc::LN2;
using attn_tc::LOG2E;
constexpr int BQ = 128;   // q rows a block: two consumer warpgroups of 64
constexpr int THREADS = 2 * 128 + 32;  // + one producer warp
constexpr int Q_BYTES = 2 * HALF;
constexpr int STAGE_BYTES = 2 * KV_BYTES;
// 3 stages spill registers (ptxas) and ran slower in a development check
constexpr int STAGES = 2;
// 1 KB to align to the swizzle atom, Q, the ring, the barriers
constexpr int SMEM =
    1024 + Q_BYTES + STAGES * STAGE_BYTES + 8 * (1 + 3 * STAGES);

struct Args {
  const int* seg;  // [B, S] or null
  __nv_bfloat16* out;
  float* lse;
  int B, S, Hq, Hkv, causal;
  float scale;
  // the tensor-map dimension (1..3) of head, seq and batch of q, k and v,
  // two bits each (the maps order them by stride)
  int pos_q, pos_k, pos_v;
};

}  // namespace fwd_tc

// One block: (q head h, batch b, 128-row q tile). Warpgroups 0 and 1 own 64
// q rows each; warp 8 is the TMA producer (Q once, then K and V tiles of
// 128 keys through a ring of STAGES). The two warpgroups take turns to
// issue their products (named barriers), so that one's softmax runs while
// the other's products do.
__global__ void __launch_bounds__(fwd_tc::THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const fwd_tc::Args a) {
  using namespace fwd_tc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = qs + Q_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int nq = (a.S + BQ - 1) / BQ;
  const int iq = nq - 1 - blockIdx.z;  // the longest rows first, all heads
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (a.Hq / a.Hkv);
  const int row0 = iq * BQ;
  const int nk = a.causal ? iq + 1 : nq;  // square tiles

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
    if (threadIdx.x == 256) {
      // rows >= S zero-fill; their scores are masked as columns below
      tc::mbar_arrive_expect_tx(q_full, Q_BYTES);
      attn_tc::load_rows(qs, &q_map, q_full, a.pos_q, h, row0, b);
      for (int it = 0; it < nk; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) tc::mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        uint8_t* ks = ring + s * STAGE_BYTES;
        tc::mbar_arrive_expect_tx(&k_full[s], KV_BYTES);
        attn_tc::load_rows(ks, &k_map, &k_full[s], a.pos_k, hk, it * BKV, b);
        tc::mbar_arrive_expect_tx(&v_full[s], KV_BYTES);
        attn_tc::load_rows(ks + KV_BYTES, &v_map, &v_full[s], a.pos_v, hk,
                           it * BKV, b);
      }
    }
    return;
  }

  // fragment of m64n128k16: thread (warp w, lane l) of warpgroup wg holds
  // rows r_lo = row0 + 64 wg + 16 w + l / 4 and r_lo + 8, and in each
  // 8-column group j the columns 8 j + 2 (l % 4) (+ 1): x[4 j + 2 hh + e]
  // is row r_lo + 8 hh, column 8 j + 2 (l % 4) + e. A row's max and sum
  // reduce over the 4 lanes of a quad.
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const int q4 = lane % 4;
  const int row_first = row0 + 64 * wg;
  const int r_lo = row_first + (tid / 32) * 16 + lane / 4;
  const int* seg = a.seg == nullptr ? nullptr : a.seg + (long long)b * a.S;
  int segr[2] = {0, 0};
  if (seg != nullptr) {
    segr[0] = r_lo < a.S ? seg[r_lo] : 0;
    segr[1] = r_lo + 8 < a.S ? seg[r_lo + 8] : 0;
  }
  // the running max m in log2 units (scores times scale * log2 e, so that
  // exp(s - m) is exp2 of a difference), the denominator l
  const float scale2 = a.scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  const uint8_t* qw = qs + wg * 64 * 128;  // this warpgroup's rows
  tc::mbar_wait(q_full, 0);
  if (wg == 1) tc::named_barrier_arrive(BAR_TURN, 256);  // 0 goes first

  for (int it = 0; it < nk; ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const int col0 = it * BKV;
    const uint8_t* ks = ring + s * STAGE_BYTES;
    const uint8_t* vs = ks + KV_BYTES;

    // S = Q K^T: A = Q, B = K, both K-major (d contiguous), d in two
    // 64-wide boxes of 4 k16 steps
    float sc[64];
    tc::mbar_wait(&k_full[s], parity);
    attn_tc::qk_scores<2>(sc, qw, HALF, ks, wg);

    // visibility, on the tiles that need it: the causal diagonal, the
    // tail past S, every tile with segment ids
    const bool masked = (a.causal && col0 + BKV - 1 > row_first) ||
                        col0 + BKV > a.S || seg != nullptr;
    uint32_t vis[2] = {~0u, ~0u};
    if (masked) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * j + 2 * q4 + e;
          const int segc = (seg != nullptr && col < a.S) ? seg[col] : 0;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const bool ok = col < a.S && (!a.causal || col <= r_lo + 8 * hh) &&
                            segc == segr[hh];
            if (!ok) vis[hh] &= ~(1u << (2 * j + e));
          }
        }
    }
    // fp32 online softmax, P rounded to bf16 as A registers, O += P V
    attn_tc::online_softmax(sc, vis, scale2, m, l, o);
    uint32_t pa[1][8][4];
    attn_tc::pack_p(sc, pa);
    tc::mbar_wait(&v_full[s], parity);
    // the turns balance: warpgroup 1's last hand-over has no taker
    attn_tc::pv_product<2, 1>(o, pa, vs, wg, !(wg == 1 && it == nk - 1));
    if (tid == 0) tc::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_lo + 8 * hh;
    if (r >= a.S) continue;
    attn_tc::store_row(a.out + (((long long)b * a.S + r) * a.Hq + h) * D, o,
                       hh, l[hh], q4);
    // lse = m + log(l) in natural units; a row that sees no column keeps
    // NEG_INF + log(1), as the scalar kernel does
    if (q4 == 0)
      a.lse[((long long)b * a.Hq + h) * a.S + r] =
          l[hh] == 0.f ? NEG_INF : m[hh] * LN2 + logf(l[hh]);
  }
}

int launch_fwd_wgmma(const void* q, const void* k, const void* v,
                     const void* seg, void* out, void* lse,
                     const long long* strides, int B, int S, int Hq, int Hkv,
                     int causal, float scale, cudaStream_t stream) {
  const tc::EncodeTiled enc = tc::encode_tiled();
  if (enc == nullptr) return tc::ERR_NO_ENCODE;
  CUtensorMap q_map, k_map, v_map;
  fwd_tc::Args a{};
  using attn_tc::encode_bshd;
  if (!encode_bshd(enc, &q_map, q, B, S, Hq, strides, fwd_tc::BQ,
                   &a.pos_q) ||
      !encode_bshd(enc, &k_map, k, B, S, Hkv, strides + 3, fwd_tc::BKV,
                   &a.pos_k) ||
      !encode_bshd(enc, &v_map, v, B, S, Hkv, strides + 6, fwd_tc::BKV,
                   &a.pos_v))
    return tc::ERR_TENSOR_MAP;
  a.seg = static_cast<const int*>(seg);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.S = S;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.causal = causal;
  a.scale = scale;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fwd_tc::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, B, (S + fwd_tc::BQ - 1) / fwd_tc::BQ);
  flash_fwd_wgmma_kernel<<<grid, fwd_tc::THREADS, fwd_tc::SMEM, stream>>>(
      q_map, k_map, v_map, a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the backward on the tensor cores (bf16, D 128): wgmma fed by TMA
// ---------------------------------------------------------------------------
//
// dK/dV (flash_bwd_dkdv_wgmma_kernel). One block per (kv head, batch,
// 128-key tile), the keys seen by the most q rows first: two consumer
// warpgroups of 64 keys each and one producer warpgroup. TMA brings the
// block's K and V once (two [128][64] boxes each), then for every q head
// of the group and every 64-row q tile from the diagonal on, the Q and dO
// tile through a ring of STAGES; a second producer warp copies the tile's
// lse (times log2 e), delta and segment ids beside it in the stage. Per
// q tile a warpgroup computes the transposed scores, so that the
// probabilities are already the register A operand of the products with
// Q and dO (the forward's P V identity, turned around):
//   S^T  = K Q^T    m64n64k16, A = K, B = Q, both K-major
//   dP^T = V dO^T   m64n64k16, A = V, B = dO, both K-major
//   P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T - delta)
//   in fp32 registers, each packed pairwise to bf16;
//   dV += P^T dO    m64n128k16, A from registers, B = dO N-major
//   dK += dS^T Q    m64n128k16, A from registers, B = Q N-major
// In 128-byte swizzle a [rows][64 d] box is the same bytes read K-major or
// N-major, so each Q and dO tile is loaded once and read both ways. The
// 64 + 64 accumulators, two 32-float score fragments and the packed
// operands need ~210 registers a thread: the producer warpgroup gives its
// registers to the consumers (setmaxnreg 24 / 240, FlashAttention-3's
// layout). dK is scaled once at the end; dK and dV are stored from
// registers, rows at or past S skipped.
//
// dQ (flash_bwd_dq_wgmma_kernel). The forward's structure: one block per
// (q head, batch, 128-row q tile), the longest causal tiles first; two
// consumer warpgroups of 64 rows and a producer warp. TMA brings Q and dO
// once and K and V tiles of 64 keys through the ring; each thread reads
// the lse and delta of its two rows once. Per key tile:
//   S = Q K^T, dP = dO V^T   m64n64k16, both operands K-major
//   dS = exp2(S scale log2 e - lse log2 e) (dP - delta) in registers,
//   packed to bf16 as the register A fragment of
//   dQ += dS K               m64n128k16, K read N-major from the tile
//   that served S
// and dQ is scaled once at the end.
//
// Both: masks only on the tiles that need them (the causal diagonal, the
// tail past S, every tile with segment ids); a masked probability is an
// exact 0, so its dS is 0 too. Rows past S come zero-filled by TMA. A
// warpgroup skips the products of a causal tile none of whose pairs it
// can see. Each block owns its output tile, no atomics: the results are
// deterministic. The same function as the scalar kernels and the plain
// versions (p rounded to bf16 before dV, ds before dK and dQ, every sum
// fp32); the backward has no running max, so the tiling moves only the
// order of the fp32 sums.

namespace bwd_tc {

constexpr int D = 128;
constexpr int BOX64 = 64 * 128;    // bytes of a [64 rows][64 d] box
constexpr int BOX128 = 128 * 128;  // bytes of a [128 rows][64 d] box
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;  // q rows of a dK/dV stage, keys of a dQ stage

// dK/dV: 128 keys a block; a stage is a Q and a dO tile of 64 rows and
// their lse, delta and segment ids (rounded up to keep the 1024-byte
// swizzle alignment of the next stage)
constexpr int KV_THREADS = 3 * 128;
constexpr int KV_BK = 128;
constexpr int KV_KEYS_BYTES = 2 * BOX128;  // K or V of the block
constexpr int KV_TILE_BYTES = 2 * BOX64;   // a Q or dO tile
constexpr int KV_STAGE_BYTES = 2 * KV_TILE_BYTES + 1024;
constexpr int KV_STAGES = 3;
constexpr int KV_SMEM = 1024 + 2 * KV_KEYS_BYTES +
                        KV_STAGES * KV_STAGE_BYTES + 8 * (1 + 2 * KV_STAGES);
// registers: the producer warpgroup's 24 and the consumers' 240 balance
// the launch bound's 168 a thread (65536 / 384, rounded down to 8)
constexpr int KV_PRODUCER_REGS = 24, KV_CONSUMER_REGS = 240;

// dQ: 128 q rows a block; a stage is a K and a V tile of 64 keys
constexpr int Q_THREADS = 2 * 128 + 32;
constexpr int Q_BQ = 128;
constexpr int Q_ROWS_BYTES = 2 * BOX128;  // Q or dO of the block
constexpr int Q_STAGE_BYTES = 4 * BOX64;
constexpr int Q_STAGES = 3;
constexpr int Q_SMEM = 1024 + 2 * Q_ROWS_BYTES + Q_STAGES * Q_STAGE_BYTES +
                       8 * (1 + 2 * Q_STAGES);

struct Args {
  const int* seg;      // [B, S] or null
  const float* lse;    // [B, Hq, S]
  const float* delta;  // [B, Hq, S]
  __nv_bfloat16* out0;  // dK, or dQ
  __nv_bfloat16* out1;  // dV
  int B, S, Hq, Hkv, causal;
  float scale;
  int pos_q, pos_k, pos_v, pos_do;  // as fwd_tc::Args
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// the K-major descriptor of a [rows][64] box, and the N-major one of two
// boxes `box` bytes apart (both 64-wide halves of d)
__device__ __forceinline__ uint64_t kmajor(const uint8_t* p) {
  return tc::smem_desc(p, 16, 1024);
}
__device__ __forceinline__ uint64_t nmajor(const uint8_t* p, int box) {
  return tc::smem_desc(p, box, 1024);
}

// the two m64n64 products of a tile, issued and committed (not waited
// for): s = A_s B_s^T and dp = A_dp B_dp^T, every operand K-major with d
// in two 64-wide boxes of 4 k16 steps; the A sides (this warpgroup's 64
// rows of a 128-row block) BOX128 apart, the B sides (a 64-row tile)
// BOX64 apart
__device__ __forceinline__ void scores_and_dp(float (&s)[32], float (&dp)[32],
                                              const uint8_t* a_s,
                                              const uint8_t* b_s,
                                              const uint8_t* a_dp,
                                              const uint8_t* b_dp) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  tc::wgmma_fence();
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma<0, 0>(s, kmajor(a_s + half * BOX128 + kk * 32),
                      kmajor(b_s + half * BOX64 + kk * 32));
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma<0, 0>(dp, kmajor(a_dp + half * BOX128 + kk * 32),
                      kmajor(b_dp + half * BOX64 + kk * 32));
  tc::wgmma_commit();
}

// which pairs of an m64n64 fragment the mask lets through, bit
// 4 j + 2 hh + e for fragment row lo + 8 hh and column
// col0 + 8 j + 2 q4 + e; the keys are the rows (ROWS_ARE_KEYS, S^T in
// dK/dV) or the columns (S in dQ). seg_row holds the rows' segment ids,
// seg_col(c) gives column col0 + c's
template <bool ROWS_ARE_KEYS, typename SegCol>
__device__ __forceinline__ uint32_t visible_bits(int lo, int col0, int q4,
                                                 int S, int causal,
                                                 const int (&seg_row)[2],
                                                 SegCol seg_col) {
  uint32_t vis = ~0u;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * q4 + e, col = col0 + c;
      const int segc = seg_col(c);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = lo + 8 * hh;
        const int key = ROWS_ARE_KEYS ? row : col;
        const int qrow = ROWS_ARE_KEYS ? col : row;
        const bool ok = col < S && row < S && (!causal || key <= qrow) &&
                        segc == seg_row[hh];
        if (!ok) vis &= ~(1u << (4 * j + 2 * hh + e));
      }
    }
  return vis;
}

}  // namespace bwd_tc

__global__ void __launch_bounds__(bwd_tc::KV_THREADS, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap do_map,
                                const bwd_tc::Args a) {
  using namespace bwd_tc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + KV_KEYS_BYTES;
  uint8_t* ring = vs + KV_KEYS_BYTES;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ring +
                                                  KV_STAGES * KV_STAGE_BYTES);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + KV_STAGES;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int ik = blockIdx.z;  // the keys seen by the most rows first
  const int g = a.Hq / a.Hkv;
  const int col0 = ik * KV_BK;
  const int nq = (a.S + BQ - 1) / BQ;
  const int iq0 = a.causal ? col0 / BQ : 0;  // the diagonal's q tile
  const int per_head = nq - iq0;
  const int tiles = g * per_head;  // (q head, q tile) pairs, head-major

  if (threadIdx.x == 0) {
    tc::mbar_init(kv_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      tc::mbar_init(&full[s], 1 + 32);  // the TMA thread and the stats warp
      tc::mbar_init(&empty[s], 2);
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warpgroup
    tc::setmaxnreg_dec<KV_PRODUCER_REGS>();
    const int warp = (threadIdx.x - 256) / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      // rows >= S zero-fill; their pairs are masked below
      tc::mbar_arrive_expect_tx(kv_full, 2 * KV_KEYS_BYTES);
      attn_tc::load_rows(ks, &k_map, kv_full, a.pos_k, hk, col0, b, BOX128);
      attn_tc::load_rows(vs, &v_map, kv_full, a.pos_v, hk, col0, b, BOX128);
      for (int it = 0; it < tiles; ++it) {
        const int s = it % KV_STAGES;
        if (it >= KV_STAGES) tc::mbar_wait(&empty[s], (it / KV_STAGES - 1) & 1);
        const int h = hk * g + it / per_head;
        const int row0 = (iq0 + it % per_head) * BQ;
        uint8_t* qs = ring + s * KV_STAGE_BYTES;
        tc::mbar_arrive_expect_tx(&full[s], 2 * KV_TILE_BYTES);
        attn_tc::load_rows(qs, &q_map, &full[s], a.pos_q, h, row0, b, BOX64);
        attn_tc::load_rows(qs + KV_TILE_BYTES, &do_map, &full[s], a.pos_do, h,
                          row0, b, BOX64);
      }
    } else if (warp == 1) {
      // the tile's lse in log2 units, delta and segment ids, never read
      // at or past S
      for (int it = 0; it < tiles; ++it) {
        const int s = it % KV_STAGES;
        if (it >= KV_STAGES) tc::mbar_wait(&empty[s], (it / KV_STAGES - 1) & 1);
        const int h = hk * g + it / per_head;
        const int row0 = (iq0 + it % per_head) * BQ;
        float* st = reinterpret_cast<float*>(ring + s * KV_STAGE_BYTES +
                                             2 * KV_TILE_BYTES);
        const long long base = ((long long)b * a.Hq + h) * a.S;
        for (int i = lane; i < BQ; i += 32) {
          const int r = row0 + i;
          const bool in = r < a.S;
          st[i] = in ? a.lse[base + r] * LOG2E : 0.f;
          st[BQ + i] = in ? a.delta[base + r] : 0.f;
          reinterpret_cast<int*>(st)[2 * BQ + i] =
              (in && a.seg != nullptr) ? a.seg[(long long)b * a.S + r] : 0;
        }
        tc::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  tc::setmaxnreg_inc<KV_CONSUMER_REGS>();
  // fragment of m64nNk16: thread (warp w, lane l) of warpgroup wg holds
  // key rows k_lo = col0 + 64 wg + 16 w + l / 4 and k_lo + 8, and in each
  // 8-column group j the columns 8 j + 2 (l % 4) (+ 1): x[4 j + 2 hh + e]
  // is key k_lo + 8 hh, column 8 j + 2 (l % 4) + e (a q row of the tile
  // in S^T, a d of the head in dK and dV)
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const int q4 = lane % 4;
  const int key_first = col0 + 64 * wg;
  const int k_lo = key_first + (tid / 32) * 16 + lane / 4;
  int segk[2] = {0, 0};
  if (a.seg != nullptr) {
    segk[0] = k_lo < a.S ? a.seg[(long long)b * a.S + k_lo] : 0;
    segk[1] = k_lo + 8 < a.S ? a.seg[(long long)b * a.S + k_lo + 8] : 0;
  }
  const float scale2 = a.scale * LOG2E;
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  const uint8_t* kw = ks + wg * 64 * 128;  // this warpgroup's keys
  const uint8_t* vw = vs + wg * 64 * 128;
  tc::mbar_wait(kv_full, 0);

  for (int it = 0; it < tiles; ++it) {
    const int s = it % KV_STAGES;
    const int row0 = (iq0 + it % per_head) * BQ;
    const uint8_t* qs = ring + s * KV_STAGE_BYTES;
    const uint8_t* dos = qs + KV_TILE_BYTES;
    const float* lse2 = reinterpret_cast<const float*>(dos + KV_TILE_BYTES);
    const float* dlt = lse2 + BQ;
    const int* segq = reinterpret_cast<const int*>(dlt + BQ);
    tc::mbar_wait(&full[s], (it / KV_STAGES) & 1);
    if (a.causal && row0 + BQ - 1 < key_first) {
      // every q row of the tile precedes every key of this warpgroup
      if (tid == 0) tc::mbar_arrive(&empty[s]);
      continue;
    }

    // S^T = K Q^T and dP^T = V dO^T
    float st[32], dpt[32];
    scores_and_dp(st, dpt, kw, qs, vw, dos);

    // visibility, on the tiles that need it
    const bool masked = (a.causal && key_first + 63 > row0) ||
                        row0 + BQ > a.S || key_first + 64 > a.S ||
                        a.seg != nullptr;
    const uint32_t vis =
        masked ? visible_bits<true>(k_lo, row0, q4, a.S, a.causal, segk,
                                    [segq](int c) { return segq[c]; })
               : ~0u;
    tc::wgmma_wait<0>();
    tc::fence_regs(st);
    tc::fence_regs(dpt);

    // P^T and dS^T in fp32, packed pairwise to bf16: the fragment's
    // columns 16 kk .. 16 kk + 15 (groups 2 kk and 2 kk + 1) are the A
    // fragment of the k16 step kk
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 2 * kk + jj, c = 8 * j + 2 * q4 + e;
          const float l2 = lse2[c], dl = dlt[c];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * j + 2 * hh + e;
            const float p =
                (vis >> i & 1u) ? exp2f(fmaf(st[i], scale2, -l2)) : 0.f;
            dpt[i] = p * (dpt[i] - dl);
            st[i] = p;
          }
        }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        pa[kk][w] = attn_tc::pack_bf16(st[8 * kk + 2 * w],
                                      st[8 * kk + 2 * w + 1]);
        da[kk][w] = attn_tc::pack_bf16(dpt[8 * kk + 2 * w],
                                      dpt[8 * kk + 2 * w + 1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: B N-major, the two 64-d boxes BOX64
    // apart, the k16 step 16 q rows down
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_rs<1>(dv, pa[kk], nmajor(dos + kk * 16 * 128, BOX64));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_rs<1>(dk, da[kk], nmajor(qs + kk * 16 * 128, BOX64));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(dv);
    tc::fence_regs(dk);
    if (tid == 0) tc::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k_lo + 8 * hh;
    if (key >= a.S) continue;
    const long long o = (((long long)b * a.S + key) * a.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * q4;
      *reinterpret_cast<__nv_bfloat162*>(a.out0 + o + c) =
          __floats2bfloat162_rn(dk[4 * j + 2 * hh] * a.scale,
                                dk[4 * j + 2 * hh + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(a.out1 + o + c) =
          __floats2bfloat162_rn(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
    }
  }
}

__global__ void __launch_bounds__(bwd_tc::Q_THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const bwd_tc::Args a) {
  using namespace bwd_tc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* dos = qs + Q_ROWS_BYTES;
  uint8_t* ring = dos + Q_ROWS_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring +
                                                 Q_STAGES * Q_STAGE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + Q_STAGES;

  const int nq = (a.S + Q_BQ - 1) / Q_BQ;
  const int iq = nq - 1 - blockIdx.z;  // the longest rows first, all heads
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (a.Hq / a.Hkv);
  const int row0 = iq * Q_BQ;
  const int nk_all = (a.S + BQ - 1) / BQ;
  const int nk = a.causal ? min(nk_all, (row0 + Q_BQ) / BQ) : nk_all;

  if (threadIdx.x == 0) {
    tc::mbar_init(q_full, 1);
    for (int s = 0; s < Q_STAGES; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 2);
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warp
    if (threadIdx.x == 256) {
      // rows >= S zero-fill; their pairs are masked below
      tc::mbar_arrive_expect_tx(q_full, 2 * Q_ROWS_BYTES);
      attn_tc::load_rows(qs, &q_map, q_full, a.pos_q, h, row0, b, BOX128);
      attn_tc::load_rows(dos, &do_map, q_full, a.pos_do, h, row0, b, BOX128);
      for (int it = 0; it < nk; ++it) {
        const int s = it % Q_STAGES;
        if (it >= Q_STAGES) tc::mbar_wait(&empty[s], (it / Q_STAGES - 1) & 1);
        uint8_t* kst = ring + s * Q_STAGE_BYTES;
        tc::mbar_arrive_expect_tx(&full[s], Q_STAGE_BYTES);
        attn_tc::load_rows(kst, &k_map, &full[s], a.pos_k, hk, it * BQ, b,
                          BOX64);
        attn_tc::load_rows(kst + 2 * BOX64, &v_map, &full[s], a.pos_v, hk,
                          it * BQ, b, BOX64);
      }
    }
    return;
  }

  // fragment of m64nNk16 as in the forward: thread (warp w, lane l) of
  // warpgroup wg holds q rows r_lo = row0 + 64 wg + 16 w + l / 4 and
  // r_lo + 8; x[4 j + 2 hh + e] is row r_lo + 8 hh, column 8 j + 2 (l % 4)
  // + e (a key of the tile in S and dP, a d of the head in dQ)
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const int q4 = lane % 4;
  const int row_first = row0 + 64 * wg;
  const int r_lo = row_first + (tid / 32) * 16 + lane / 4;
  const int* seg = a.seg == nullptr ? nullptr : a.seg + (long long)b * a.S;
  const long long base = ((long long)b * a.Hq + h) * a.S;
  float lse2[2], dlt[2];
  int segr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_lo + 8 * hh;
    lse2[hh] = r < a.S ? a.lse[base + r] * LOG2E : 0.f;
    dlt[hh] = r < a.S ? a.delta[base + r] : 0.f;
    segr[hh] = (seg != nullptr && r < a.S) ? seg[r] : 0;
  }
  const float scale2 = a.scale * LOG2E;
  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  const uint8_t* qw = qs + wg * 64 * 128;  // this warpgroup's rows
  const uint8_t* dow = dos + wg * 64 * 128;
  tc::mbar_wait(q_full, 0);

  for (int it = 0; it < nk; ++it) {
    const int s = it % Q_STAGES;
    const int col0 = it * BQ;
    const uint8_t* kst = ring + s * Q_STAGE_BYTES;
    const uint8_t* vst = kst + 2 * BOX64;
    tc::mbar_wait(&full[s], (it / Q_STAGES) & 1);
    if (a.causal && col0 > row_first + 63) {
      // every key of the tile follows every row of this warpgroup
      if (tid == 0) tc::mbar_arrive(&empty[s]);
      continue;
    }

    // S = Q K^T and dP = dO V^T
    float sc[32], dp[32];
    scores_and_dp(sc, dp, qw, kst, dow, vst);

    // visibility, on the tiles that need it
    const bool masked = (a.causal && col0 + 63 > row_first) ||
                        col0 + BQ > a.S || seg != nullptr;
    const uint32_t vis =
        masked ? visible_bits<false>(
                     r_lo, col0, q4, a.S, a.causal, segr,
                     [seg, col0, S = a.S](int c) {
                       const int col = col0 + c;
                       return (seg != nullptr && col < S) ? seg[col] : 0;
                     })
               : ~0u;
    tc::wgmma_wait<0>();
    tc::fence_regs(sc);
    tc::fence_regs(dp);

    // dS in fp32, packed pairwise to bf16 as the A fragment of the k16
    // step kk (the fragment's columns 16 kk .. 16 kk + 15)
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * (2 * kk + jj) + 2 * hh + e;
            const float p = (vis >> i & 1u)
                                ? exp2f(fmaf(sc[i], scale2, -lse2[hh]))
                                : 0.f;
            dp[i] = p * (dp[i] - dlt[hh]);
          }
#pragma unroll
      for (int w = 0; w < 4; ++w)
        da[kk][w] = attn_tc::pack_bf16(dp[8 * kk + 2 * w],
                                      dp[8 * kk + 2 * w + 1]);
    }

    // dQ += dS K: B = K N-major, the two 64-d boxes BOX64 apart, the k16
    // step 16 keys down
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_rs<1>(dq, da[kk], nmajor(kst + kk * 16 * 128, BOX64));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(dq);
    if (tid == 0) tc::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_lo + 8 * hh;
    if (r >= a.S) continue;
    __nv_bfloat16* out = a.out0 + (((long long)b * a.S + r) * a.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * q4) =
          __floats2bfloat162_rn(dq[4 * j + 2 * hh] * a.scale,
                                dq[4 * j + 2 * hh + 1] * a.scale);
  }
}

// kind 1: dK/dV, 2: dQ (launch_kind's numbering); strides as
// dstpu_flash_bwd_*'s (12 read)
int launch_bwd_wgmma(int kind, const void* q, const void* k, const void* v,
                     const void* dout, const void* seg, const void* lse,
                     const void* delta, void* out0, void* out1,
                     const long long* strides, int B, int S, int Hq, int Hkv,
                     int causal, float scale, cudaStream_t stream) {
  using namespace bwd_tc;
  const tc::EncodeTiled enc = tc::encode_tiled();
  if (enc == nullptr) return tc::ERR_NO_ENCODE;
  // dK/dV: keys 128 a block, q and dO 64 a stage; dQ: the other way
  const int q_rows = kind == 1 ? BQ : Q_BQ, kv_rows = kind == 1 ? KV_BK : BQ;
  CUtensorMap q_map, k_map, v_map, do_map;
  Args a{};
  using attn_tc::encode_bshd;
  if (!encode_bshd(enc, &q_map, q, B, S, Hq, strides, q_rows, &a.pos_q) ||
      !encode_bshd(enc, &k_map, k, B, S, Hkv, strides + 3, kv_rows,
                   &a.pos_k) ||
      !encode_bshd(enc, &v_map, v, B, S, Hkv, strides + 6, kv_rows,
                   &a.pos_v) ||
      !encode_bshd(enc, &do_map, dout, B, S, Hq, strides + 9, q_rows,
                   &a.pos_do))
    return tc::ERR_TENSOR_MAP;
  a.seg = static_cast<const int*>(seg);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out0 = static_cast<__nv_bfloat16*>(out0);
  a.out1 = static_cast<__nv_bfloat16*>(out1);
  a.B = B;
  a.S = S;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.causal = causal;
  a.scale = scale;
  auto kernel = kind == 1 ? flash_bwd_dkdv_wgmma_kernel
                          : flash_bwd_dq_wgmma_kernel;
  const int smem = kind == 1 ? KV_SMEM : Q_SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (kind == 1)
    kernel<<<dim3(Hkv, B, (S + KV_BK - 1) / KV_BK), KV_THREADS, smem,
             stream>>>(q_map, k_map, v_map, do_map, a);
  else
    kernel<<<dim3(Hq, B, (S + Q_BQ - 1) / Q_BQ), Q_THREADS, smem, stream>>>(
        q_map, k_map, v_map, do_map, a);
  return (int)cudaGetLastError();
}

// 0 when the tensor-core backward takes these operands, else the error the
// entry point returns
int bwd_wgmma_refuses(const void* q, const void* k, const void* v,
                      const void* dout, const void* out0, const void* out1,
                      const long long* strides, int Hq, int Hkv) {
  if (Hkv <= 0 || Hq % Hkv ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)out0 | (uintptr_t)out1) % 16)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] <= 0 || strides[i] % 8) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd: 64 or 128. strides: 12 int64,
// the (batch, seq, head) element strides of q, k, v and dout (dout's are
// read by the backward only). seg may be null. Each returns a cudaError_t
// (0 = launched).
extern "C" int dstpu_flash_fwd(int dtype, int hd, const void* q,
                               const void* k, const void* v, const void* seg,
                               void* out, void* lse_out,
                               const long long* strides, int B, int S, int Hq,
                               int Hkv, int causal, float scale,
                               void* stream) {
  const Params p = make_params(q, k, v, nullptr, seg, nullptr, nullptr, out,
                               lse_out, nullptr, nullptr, strides, B, S, Hq,
                               Hkv, causal, scale);
  return dispatch(0, dtype, hd, p, stream);
}

extern "C" int dstpu_flash_bwd_dkdv(int dtype, int hd, const void* q,
                                    const void* k, const void* v,
                                    const void* dout, const void* seg,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv,
                                    const long long* strides, int B, int S,
                                    int Hq, int Hkv, int causal, float scale,
                                    void* stream) {
  const Params p = make_params(q, k, v, dout, seg, lse, delta, nullptr,
                               nullptr, dk, dv, strides, B, S, Hq, Hkv,
                               causal, scale);
  return dispatch(1, dtype, hd, p, stream);
}

extern "C" int dstpu_flash_bwd_dq(int dtype, int hd, const void* q,
                                  const void* k, const void* v,
                                  const void* dout, const void* seg,
                                  const void* lse, const void* delta,
                                  void* dq, const long long* strides, int B,
                                  int S, int Hq, int Hkv, int causal,
                                  float scale, void* stream) {
  const Params p = make_params(q, k, v, dout, seg, lse, delta, dq, nullptr,
                               nullptr, nullptr, strides, B, S, Hq, Hkv,
                               causal, scale);
  return dispatch(2, dtype, hd, p, stream);
}

// The tensor-core forward: bf16 q, k, v of head dim 128 with 16-byte
// aligned data and (batch, seq, head) strides that are positive multiples
// of 8 (TMA's rules; the caller checks: ops/flash_attention.py
// flash_variant); strides as dstpu_flash_fwd's (9 read). Returns a
// cudaError_t, or a negative code of the tensor-map path.
extern "C" int dstpu_flash_fwd_wgmma(const void* q, const void* k,
                                     const void* v, const void* seg,
                                     void* out, void* lse_out,
                                     const long long* strides, int B, int S,
                                     int Hq, int Hkv, int causal, float scale,
                                     void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (strides[i] <= 0 || strides[i] % 8) return (int)cudaErrorInvalidValue;
  return launch_fwd_wgmma(q, k, v, seg, out, lse_out, strides, B, S, Hq, Hkv,
                          causal, scale, static_cast<cudaStream_t>(stream));
}

// The tensor-core backward: bf16 q, k, v and dout of head dim 128 with
// 16-byte aligned data and (batch, seq, head) strides that are positive
// multiples of 8 (TMA's rules; the caller checks: ops/flash_attention.py
// flash_variant); arguments as dstpu_flash_bwd_dkdv's and
// dstpu_flash_bwd_dq's without dtype and hd. Each returns a cudaError_t,
// or a negative code of the tensor-map path.
extern "C" int dstpu_flash_bwd_dkdv_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* seg, const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int S, int Hq, int Hkv, int causal,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (const int rc = bwd_wgmma_refuses(q, k, v, dout, dk, dv, strides, Hq,
                                       Hkv))
    return rc;
  return launch_bwd_wgmma(1, q, k, v, dout, seg, lse, delta, dk, dv, strides,
                          B, S, Hq, Hkv, causal, scale,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int dstpu_flash_bwd_dq_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* seg, const void* lse, const void* delta, void* dq,
    const long long* strides, int B, int S, int Hq, int Hkv, int causal,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (const int rc = bwd_wgmma_refuses(q, k, v, dout, dq, dq, strides, Hq,
                                       Hkv))
    return rc;
  return launch_bwd_wgmma(2, q, k, v, dout, seg, lse, delta, dq, nullptr,
                          strides, B, S, Hq, Hkv, causal, scale,
                          static_cast<cudaStream_t>(stream));
}

extern "C" const char* dstpu_cuda_error_string(int code) {
  return tc::error_string(code);
}
