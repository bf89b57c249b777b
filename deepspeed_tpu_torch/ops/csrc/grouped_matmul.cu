// Grouped matrix multiply for Hopper (sm_90a): the dropless-MoE expert FFN.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/grouped_matmul.py:
//   gmm_kernel<T, BM, false> <- _gmm_kernel  (:129, pallas_call in _gmm_call :183)
//   gmm_kernel<T, BM, true>  <- _gmm_kernel with transpose_rhs (the backward's
//                               dlhs = dout @ rhs[g]^T, :306-311)
//   tgmm_kernel<T>           <- _tgmm_kernel (:212, pallas_call in _tgmm_call :247)
//
// What they compute (the TPU kernels' function, not their block structure):
//   gmm       out[m] = lhs[m] @ rhs[g(m)]        lhs [M, K], rhs [E, K, N]
//   gmm^T     out[m] = lhs[m] @ rhs[g(m)]^T      lhs [M, K], rhs [E, N, K]
//   tgmm      out[e] = lhs_e^T @ dout_e          lhs [M, K], dout [M, N] -> [E, K, N]
// where the rows of lhs (and dout) are sorted by group: group e owns rows
// [start_e, end_e), end_e = min(sizes[0] + ... + sizes[e], M) (the JAX
// metadata's over-sum clamp, make_group_metadata :78). Rows at or past the
// last group's end belong to no group and come back zero (under-sum); tgmm
// writes zeros for a group with no rows (:270-275). Every product sums in
// fp32 and is written once in the input type (fp32 or bf16).
//
// Design. The TPU kernel walks a static work list of (m-tile, group) items
// in a sequential grid and carries an fp32 accumulator in VMEM across the
// consecutive visits to one m-tile. Here every thread block owns one
// (row item, 128-column tile) of the output and loops over the inner
// dimension itself, so nothing is carried between blocks and no atomics
// are used (the results are deterministic):
//   gmm:  grid (ceil(N/128), ceil(M/BM) + E). Row item t is the t-th
//         (group, BM-row tile) pair that intersects, counted in row order
//         over the E groups and one more pseudo-group, the rows
//         [end_{E-1}, M) that no group owns; those rows are written as
//         zeros. With E + 1 groups covering [0, M) there are at most
//         ceil(M/BM) + E such pairs, so the grid is a static worst case and
//         the host never reads group_sizes. A block finds its item from
//         the sizes on the device and exits when it has none. A tile that
//         straddles a group boundary is written by two blocks over
//         disjoint rows.
//   tgmm: grid (ceil(N/128), ceil(K/128), E): one block per (group, k-tile,
//         n-tile), looping over the group's rows 16 at a time.
// Each block is 256 threads as 16 x 16; thread (ty, tx) owns output rows
// ty + 16 i and columns tx + 16 j, and the inner dimension runs through
// shared memory in chunks of 16 (fp32 tiles, the next chunk fetched into
// registers while the current one is multiplied). Operands are read in
// place, masked at every edge (rows outside the group, k >= K, n >= N), so
// no dimension needs padding. BM is 128 rows for large M and 32 for small
// M (decode), where most of a 128-row tile would be masked rows. All
// arithmetic is scalar fp32 FMA on the CUDA cores: no tensor cores, no
// TMA. That is the simple first version.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): Mixtral-8x7B
// training, 2048 tokens x top-2 = 4096 rows, K 4096, N 14336: 481 GFLOP
// per call, 0.49 ms at the tensor-core rate, against 1.09 GB moved (0.33
// ms): bound by operations. Decode (32 rows) reads all eight experts'
// weights, 0.94 GB, for 3.8 GFLOP: bound by bytes, 0.28 ms. Scalar fp32 FMAs peak
// at 67 TFLOP/s, so expect tens of times the operations bound here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int BK = 16;        // inner-dimension chunk
constexpr int BN = 128;       // output columns per block
constexpr int TN = BN / 16;   // output columns per thread

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

// One operand's share of a [BK][W] chunk, staged in registers. Src(i, o)
// returns the (masked) element at inner index i and outer index o; when
// INNER_FAST, neighbouring threads take neighbouring inner indices (the
// operand is contiguous along the inner dimension), else neighbouring
// outer indices.
template <int W, bool INNER_FAST>
struct Stage {
  static constexpr int PER = BK * W / THREADS;
  float r[PER];

  template <class Src>
  __device__ __forceinline__ void fetch(const Src& src, int chunk) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int idx = threadIdx.x + p * THREADS;
      const int i = INNER_FAST ? idx % BK : idx / W;
      const int o = INNER_FAST ? idx / BK : idx % W;
      r[p] = src(chunk * BK + i, o);
    }
  }

  __device__ __forceinline__ void store(float (*sm)[W + 1]) const {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int idx = threadIdx.x + p * THREADS;
      const int i = INNER_FAST ? idx % BK : idx / W;
      const int o = INNER_FAST ? idx / BK : idx % W;
      sm[i][o] = r[p];
    }
  }
};

// acc[i][j] += sum over the inner dimension (chunks x BK) of
// A(inner, ty + 16 i) * B(inner, tx + 16 j), in inner order.
template <int TM, bool A_INNER_FAST, bool B_INNER_FAST, class SrcA, class SrcB>
__device__ __forceinline__ void tile_product(int chunks, const SrcA& a_src,
                                             const SrcB& b_src,
                                             float (&acc)[TM][TN]) {
  constexpr int W = 16 * TM;
  __shared__ float As[BK][W + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  Stage<W, A_INNER_FAST> sa;
  Stage<BN, B_INNER_FAST> sb;
  if (chunks > 0) {
    sa.fetch(a_src, 0);
    sb.fetch(b_src, 0);
  }
  for (int c = 0; c < chunks; ++c) {
    sa.store(As);
    sb.store(Bs);
    __syncthreads();
    if (c + 1 < chunks) {  // next chunk's loads in flight during the FMAs
      sa.fetch(a_src, c + 1);
      sb.fetch(b_src, c + 1);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// gmm / gmm^T
// ---------------------------------------------------------------------------

template <typename T>
struct RowsOfGroup {  // lhs rows [rs, re) of tile row0.., inner = k
  const T* lhs;
  int K, row0, rs, re;
  __device__ __forceinline__ float operator()(int k, int m) const {
    const int row = row0 + m;
    return (row >= rs && row < re && k < K) ? ld(lhs + (long long)row * K + k)
                                            : 0.f;
  }
};

template <typename T>
struct RhsKN {  // rhs[g] as [K, N]
  const T* rhs;
  int K, N, n0;
  __device__ __forceinline__ float operator()(int k, int n) const {
    const int col = n0 + n;
    return (k < K && col < N) ? ld(rhs + (long long)k * N + col) : 0.f;
  }
};

template <typename T>
struct RhsNK {  // rhs[g] stored [N, K], read as its transpose
  const T* rhs;
  int K, N, n0;
  __device__ __forceinline__ float operator()(int k, int n) const {
    const int col = n0 + n;
    return (k < K && col < N) ? ld(rhs + (long long)col * K + k) : 0.f;
  }
};

// Row item t of the static work list -> (group, m-tile, rows [rs, re)).
// Groups 0..E-1 are the real ones; group E is the unowned tail [end, M).
// Returns false when t is past the last item.
template <int BM>
__device__ bool find_item(const int* sizes, int E, int M, int t, int* group,
                          int* tile, int* rs, int* re) {
  int end = 0, base = 0;
  for (int g = 0; g <= E; ++g) {
    const int s = end;
    const int e = g < E ? min(end + max(sizes[g], 0), M) : M;
    end = e;
    if (e <= s) continue;
    const int first = s / BM, n = (e - 1) / BM - first + 1;
    if (t < base + n) {
      *group = g;
      *tile = first + (t - base);
      *rs = s;
      *re = e;
      return true;
    }
    base += n;
  }
  return false;
}

template <typename T, int BM, bool TRANS>
__global__ void __launch_bounds__(THREADS)
    gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
               const int* __restrict__ sizes, T* __restrict__ out, int M,
               int K, int N, int E) {
  constexpr int TM = BM / 16;
  __shared__ int item[4];
  if (threadIdx.x == 0) {
    int g, tile, rs, re;
    if (!find_item<BM>(sizes, E, M, blockIdx.y, &g, &tile, &rs, &re)) g = -1;
    item[0] = g;
    item[1] = tile;
    item[2] = rs;
    item[3] = re;
  }
  __syncthreads();
  const int g = item[0];
  if (g < 0) return;
  const int row0 = item[1] * BM, rs = item[2], re = item[3];
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (g < E) {  // the unowned tail (g == E) stays zero
    const RowsOfGroup<T> a{lhs, K, row0, rs, re};
    const T* rhs_g = rhs + (long long)g * K * N;
    const int chunks = (K + BK - 1) / BK;
    if (TRANS)
      tile_product<TM, true, true>(chunks, a, RhsNK<T>{rhs_g, K, N, n0}, acc);
    else
      tile_product<TM, true, false>(chunks, a, RhsKN<T>{rhs_g, K, N, n0}, acc);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row < rs || row >= re) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) out[(long long)row * N + col] = from_f32<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// tgmm
// ---------------------------------------------------------------------------

template <typename T>
struct GroupRows {  // x[rs + r, c0 + c] for r < re - rs, inner = r
  const T* x;
  int W, c0, rs, re;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const int row = rs + r, col = c0 + c;
    return (row < re && col < W) ? ld(x + (long long)row * W + col) : 0.f;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    tgmm_kernel(const T* __restrict__ lhs, const T* __restrict__ dout,
                const int* __restrict__ sizes, T* __restrict__ out, int M,
                int K, int N, int E) {
  constexpr int TM = 128 / 16;  // 128 k rows of the output tile
  const int g = blockIdx.z;
  int rs = 0, re = 0;
  for (int e = 0; e <= g; ++e) {  // every thread: E is small
    rs = re;
    re = min(re + max(sizes[e], 0), M);
  }
  const int k0 = blockIdx.y * 128, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int chunks = (re - rs + BK - 1) / BK;  // 0 for an empty group
  tile_product<TM, false, false>(chunks, GroupRows<T>{lhs, K, k0, rs, re},
                                 GroupRows<T>{dout, N, n0, rs, re}, acc);

  T* out_g = out + (long long)g * K * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) out_g[(long long)k * N + col] = from_f32<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// rows at or below this use 32-row tiles (decode and small prefill
// batches), above it 128-row tiles
constexpr int SMALL_M = 1024;

template <typename T, int BM, bool TRANS>
int launch_gmm(const void* lhs, const void* rhs, const int* sizes, void* out,
               int M, int K, int N, int E, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM + E);
  gmm_kernel<T, BM, TRANS><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs), sizes,
      static_cast<T*>(out), M, K, N, E);
  return (int)cudaGetLastError();
}

template <typename T, bool TRANS>
int launch_gmm_m(const void* lhs, const void* rhs, const int* sizes,
                 void* out, int M, int K, int N, int E, cudaStream_t stream) {
  if (M <= SMALL_M)
    return launch_gmm<T, 32, TRANS>(lhs, rhs, sizes, out, M, K, N, E, stream);
  return launch_gmm<T, 128, TRANS>(lhs, rhs, sizes, out, M, K, N, E, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous; group_sizes
// is int32 [E] on the device. transpose: 0 reads rhs as [E, K, N], 1 as
// [E, N, K]. out is [M, N]. Each returns a cudaError_t (0 = launched).
extern "C" int dstpu_gmm(int dtype, int transpose, const void* lhs,
                         const void* rhs, const void* group_sizes, void* out,
                         int M, int K, int N, int E, void* stream) {
  if (M <= 0 || N <= 0 || E <= 0) return 0;
  const int* sizes = static_cast<const int*>(group_sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !transpose)
    return launch_gmm_m<float, false>(lhs, rhs, sizes, out, M, K, N, E, s);
  if (dtype == 0 && transpose)
    return launch_gmm_m<float, true>(lhs, rhs, sizes, out, M, K, N, E, s);
  if (dtype == 1 && !transpose)
    return launch_gmm_m<__nv_bfloat16, false>(lhs, rhs, sizes, out, M, K, N,
                                              E, s);
  if (dtype == 1 && transpose)
    return launch_gmm_m<__nv_bfloat16, true>(lhs, rhs, sizes, out, M, K, N, E,
                                             s);
  return (int)cudaErrorInvalidValue;
}

// lhs [M, K], dout [M, N], out [E, K, N].
extern "C" int dstpu_tgmm(int dtype, const void* lhs, const void* dout,
                          const void* group_sizes, void* out, int M, int K,
                          int N, int E, void* stream) {
  if (K <= 0 || N <= 0 || E <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (K + 127) / 128, E);
  const int* sizes = static_cast<const int*>(group_sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tgmm_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(dout),
        sizes, static_cast<float*>(out), M, K, N, E);
  } else if (dtype == 1) {
    tgmm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(lhs),
        static_cast<const __nv_bfloat16*>(dout), sizes,
        static_cast<__nv_bfloat16*>(out), M, K, N, E);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dstpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
