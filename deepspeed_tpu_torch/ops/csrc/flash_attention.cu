// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel      <- _fwd_kernel      (:150, pallas_call in _flash_fwd :238)
//   flash_bwd_dkdv_kernel <- _bwd_dkdv_kernel (:268, pallas_call in _flash_bwd :414)
//   flash_bwd_dq_kernel   <- _bwd_dq_kernel   (:326, pallas_call in _flash_bwd :466)
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
// specialisation. That is the simple first version.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): causal forward
// does 4 * B * Hq * D * S(S+1)/2 flops, dK/dV twice that, dQ 1.5 times.
// At B 2, S 2048, Hq 32, Hkv 8, D 128 that is 68.8 GFLOP forward (70 us at
// the tensor-core rate) against ~67 MB moved (20 us): bound by operations.
// Scalar fp32 FMAs peak at 67 TFLOP/s and shared-memory loads hold this
// version well below that, so expect tens of times the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

extern "C" const char* dstpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
