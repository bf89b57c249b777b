// Grouped matrix multiply for Hopper (sm_90a): the dropless-MoE expert FFN.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/grouped_matmul.py:
//   gmm_wgmma_kernel<.., false> <- _gmm_kernel  (:129, pallas_call in
//                                  _gmm_call :183), bf16
//   gmm_wgmma_kernel<.., true>  <- _gmm_kernel with transpose_rhs (the
//                                  backward's dlhs = dout @ rhs[g]^T,
//                                  :306-311), bf16
//   gmm_kernel<T, BM, TRANS>    <- the same two, for fp32 and for shapes the
//                                  tensor-core kernel does not take
//   tgmm_wgmma_kernel<C>        <- _tgmm_kernel (:212, pallas_call in
//                                  _tgmm_call :247), bf16
//   tgmm_kernel<T>              <- the same, for fp32 and other shapes
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
// Work list. The TPU kernel walks a static work list of (m-tile, group)
// items in a sequential grid and carries an fp32 accumulator in VMEM across
// the consecutive visits to one m-tile. Here each (row item, column tile)
// of the output is computed whole by one thread block, which loops over the
// inner dimension itself, so nothing is carried between blocks and no
// atomics are used (two launches give the same bits). Row item t is the
// t-th (group, BM-row tile) pair that intersects, counted in row order over
// the E groups and one more pseudo-group, the rows [end_{E-1}, M) that no
// group owns; those rows are written as zeros. With E + 1 groups covering
// [0, M) there are at most ceil(M/BM) + E such pairs, so the grid is a
// static worst case and the host never reads group_sizes. A block finds its item from the sizes on
// the device (find_item) and exits when it has none. A tile that straddles
// a group boundary is written by two blocks over disjoint rows; rows of
// another group inside a tile are computed with rhs[g] and thrown away, as
// the TPU kernel's jnp.where(mask, prod, 0) does.
//
// The tensor-core kernel (bf16, K and N multiples of 8, 16-byte aligned
// operands; gmm_wgmma_kernel). Bound on the H100 (989 TFLOP/s bf16 dense,
// 3.35 TB/s): Mixtral-8x7B training, 2048 tokens x top-2 = 4096 rows, K
// 4096, N 14336: 481 GFLOP per call, 0.49 ms at the tensor-core rate,
// against 1.09 GB moved (0.33 ms): bound by operations. Decode (32 rows)
// reads all eight experts' weights, 0.94 GB, for 3.8 GFLOP: bound by
// bytes, 0.28 ms. The design:
//   - wgmma.mma_async m64nBNk16 (fp32 += bf16 x bf16) with both operands in
//     shared memory. For M > SMALL_M two consumer warpgroups share a 128 x
//     256 output tile (64 rows each), else one consumer and 64 x 128
//     tiles. A consumer whose 64 rows lie outside the item's
//     group skips its products.
//   - a ring of STAGES (A, B) tile pairs in dynamic shared memory (4 of 48
//     KB, or 8 of 24 KB for small M, which streams weights), 128-byte
//     swizzled, filled by TMA (cp.async.bulk.tensor) from one producer
//     thread, with a full and an empty mbarrier per stage; the consumers
//     keep one wgmma group in flight and free a stage once the group that
//     read it has retired. No split-K and no atomics.
//   - tensor maps built on the host per call: lhs as [M, K] (2-D), rhs as
//     [E, K, N] or [E, N, K] (3-D, so that k >= K zero-fills inside each
//     expert). Rows >= M and columns >= N zero-fill too: no masks in the
//     main loop.
//   - gmm^T reads rhs[g] as [N, K], K-major: wgmma's default B layout. gmm
//     reads rhs[g] as [K, N], N-major: B is loaded as 64-column boxes (a
//     128-byte swizzle row holds 64 bf16) and read with the B-transpose
//     immediate and an MN-major descriptor (LBO = the stride between
//     64-column boxes, SBO = the stride between 8-row k groups).
//   - one block per output tile. Blocks that walk several tiles (a
//     persistent grid, one block per SM round robin; or 2 or 4
//     consecutive tiles a block, the producer running ahead into the next
//     tile) measured slower at the train shapes.
//   - launch order: the row items of a band of column tiles (BAND_COLS,
//     2048 columns) run before the next band, so the blocks in flight share
//     rhs[g]'s column strips and each strip comes from HBM about once per
//     call rather than once per row tile (4096 x 14336 x 2 B = 117 MB a
//     group, more than the 50 MB L2).
//   - epilogue from registers with the row mask [rs, re): a TMA store of a
//     straddling tile would overwrite the neighbouring block's rows.
//
// The tensor-core tgmm (bf16, K and N multiples of 8, 16-byte aligned
// operands; tgmm_wgmma_kernel). The same bound as gmm at the train shapes
// (481 GFLOP, 0.49 ms), but its output is the big array: [8, 4096, 14336]
// bf16 is 0.94 GB, 0.28 ms at 3.35 TB/s. The design:
//   - one block per (group, 128 x 256 output tile of k x n), grid E x
//     ceil(K/128) x ceil(N/256). A block owns its tile outright: no
//     straddling, no split-K, no atomics (two launches give the same
//     bits). Launched group by group, in 2048-column bands within a group,
//     so the blocks in flight share the group's lhs and dout rows in L2.
//   - the contraction runs over the group's rows, 64 a stage, through the
//     same ring, producer and barriers as gmm. Both operands are tiles of
//     row-major arrays with the output dim contiguous: A = lhs_g^T (k
//     contiguous) read with the A-transpose immediate, B = dout_g (n
//     contiguous) exactly as gmm's N-major B; both as [64 rows][64 column]
//     TMA boxes from 2-D maps over lhs [M, K] and dout [M, N].
//   - ragged group rows: stage c loads rows rs + 64 c (TMA takes any row
//     coordinate and zero-fills only rows >= M). In the last stage the rows
//     at or past re belong to the next group: the consumers zero them in
//     shared memory in both operands (a row is a whole 128-byte swizzle
//     row), fence the async proxy and sync before the wgmma reads them. The
//     scalar kernel masks both operands too; the TPU kernel masks lhs only
//     (:224-225), which agrees for finite dout.
//   - the host never reads group_sizes: each block sums them on the device.
//     An empty group's blocks load nothing and store zeros.
//   - epilogue: registers -> swizzled shared memory (the ring, free once
//     both warpgroups' last products retired) -> TMA store, which a block
//     that owns its tile may use; TMA clips k >= K and n >= N. Stores
//     from registers ran slower in a development check.
//
// The scalar kernels (gmm_kernel, tgmm_kernel): 256 threads as 16 x 16;
// thread (ty, tx) owns output rows ty + 16 i and columns tx + 16 j, and the
// inner dimension runs through shared memory in chunks of 16 (fp32 tiles,
// the next chunk fetched into registers while the current one is
// multiplied), every edge masked, scalar fp32 FMA on the CUDA cores.
// tgmm's grid is (ceil(N/128), ceil(K/128), E): one block per (group,
// k-tile, n-tile), looping over the group's rows 16 at a time. The scalar
// gmm keeps fp32 exact (TF32 would not hold fp32's tolerance) and takes
// shapes TMA cannot (K or N not a multiple of 8). Scalar fp32 FMAs peak at
// 67 TFLOP/s, so expect tens of times the operations bound there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

}  // namespace

// ---------------------------------------------------------------------------
// gmm / gmm^T / tgmm on the tensor cores (bf16): wgmma fed by TMA, with the
// building blocks of hopper.cuh
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BK = 64;  // k per stage: 64 bf16 = one 128-byte swizzle row
constexpr int BAND_COLS = 2048;  // output columns per band of the launch order
constexpr int BOX = 64 * 128;    // bytes of a [64 rows][64 bf16] TMA box

// the tile shape and ring depth of one instantiation
template <int BM_, int BN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int CONSUMERS = BM / 64;  // one warpgroup per 64 rows
  static constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the ring, 1 KB to align it to the 1024-byte swizzle atom, a full and
  // an empty barrier per stage, and the block's work item
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 16 * STAGES + 16;
};

// One block: a (row item, BN-column tile) of out. Warpgroups 0..CONSUMERS-1
// each own 64 rows of the BM-row tile; the last warpgroup's first thread
// is the TMA producer.
template <class C, bool TRANS>
__global__ void __launch_bounds__(C::THREADS, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap lhs_map,
                     const __grid_constant__ CUtensorMap rhs_map,
                     const int* __restrict__ sizes,
                     __nv_bfloat16* __restrict__ out, int M, int K, int N,
                     int E, int items, int n_tiles, int band) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES *
                                               C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  int* item = reinterpret_cast<int*>(empty + C::STAGES);

  // launch order: bands of `band` column tiles, all row items of a band
  // before the next band, the column tile fastest within a band
  const int per_band = items * band;
  const int bi = blockIdx.x / per_band;
  const int r = blockIdx.x - bi * per_band;
  const int width = min(band, n_tiles - bi * band);
  const int t = r / width;
  const int n0 = (bi * band + r % width) * C::BN;

  if (threadIdx.x == 0) {
    int g, tile, rs, re;
    if (!find_item<C::BM>(sizes, E, M, t, &g, &tile, &rs, &re)) g = -1;
    item[0] = g;
    item[1] = tile;
    item[2] = rs;
    item[3] = re;
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int g = item[0];
  if (g < 0) return;
  const int row0 = item[1] * C::BM, rs = item[2], re = item[3];
  // the unowned tail (g == E) multiplies nothing and is written as zeros
  const int k_tiles = g < E ? (K + BK - 1) / BK : 0;
  const int wg = threadIdx.x / 128;

  if (wg == C::CONSUMERS) {  // producer
    if (threadIdx.x % 128 == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % C::STAGES;
        if (kt >= C::STAGES) mbar_wait(&empty[s], (kt / C::STAGES - 1) & 1);
        uint8_t* a = ring + s * C::STAGE_BYTES;
        uint8_t* b = a + C::A_BYTES;
        mbar_arrive_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_2d(a, &lhs_map, &full[s], kt * BK, row0);
        if (TRANS) {  // [BN rows of n][64 k]
          tma_load_3d(b, &rhs_map, &full[s], kt * BK, n0, g);
        } else {  // BN / 64 boxes of [64 rows of k][64 n]
#pragma unroll
          for (int j = 0; j < C::BN / 64; ++j)
            tma_load_3d(b + j * BK * 128, &rhs_map, &full[s], n0 + 64 * j,
                        kt * BK, g);
        }
      }
    }
    return;
  }

  float acc[C::BN / 2];
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) acc[i] = 0.f;
  // a warpgroup whose 64 rows hold none of [rs, re) (half of a tile that
  // straddles a group boundary) skips the products and only frees stages
  const bool live = row0 + wg * 64 < re && row0 + wg * 64 + 64 > rs;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % C::STAGES;
    mbar_wait(&full[s], (kt / C::STAGES) & 1);
    const uint8_t* a = ring + s * C::STAGE_BYTES + wg * 64 * 128;
    const uint8_t* b = ring + s * C::STAGE_BYTES + C::A_BYTES;
    if (live) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A, and B for gmm^T: K-major rows of 128 bytes, 8-row groups
        // 1024 bytes apart, the k16 step 32 bytes into the swizzled row.
        // B for gmm: N-major, 64-column boxes BK * 128 bytes apart (LBO),
        // 8-row k groups 1024 bytes apart (SBO), the k16 step 16 rows
        // down.
        const uint64_t da = smem_desc(a + kk * 32, 16, 1024);
        const uint64_t db =
            TRANS ? smem_desc(b + kk * 32, 16, 1024)
                  : smem_desc(b + kk * 16 * 128, BK * 128, 1024);
        wgmma<0, TRANS ? 0 : 1>(acc, da, db);
      }
      wgmma_commit();
    }
    // one group in flight: the previous stage's group has retired
    wgmma_wait<1>();
    if (kt > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(&empty[(kt - 1) % C::STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // fragment of m64nNk16: thread (warp w, lane l) holds rows 16 w + l / 4
  // (+ 8) and, in each 8-column group j, columns 8 j + 2 (l % 4) (+ 1)
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int row_lo = row0 + wg * 64 + (tid / 32) * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    if (row < rs || row >= re) continue;
    __nv_bfloat16* o = out + (long long)row * N;
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col < N)  // N is even, so col + 1 < N too
        *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// One block: the (k tile, n tile) output tile of out[g] = lhs_g^T @ dout_g,
// BM rows of k by BN columns of n, contracting over the group's rows
// [rs, re) 64 at a time. Warpgroups 0..CONSUMERS-1 each own 64 rows of k;
// the last warpgroup's first thread is the TMA producer.
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    tgmm_wgmma_kernel(const __grid_constant__ CUtensorMap lhs_map,
                      const __grid_constant__ CUtensorMap dout_map,
                      const __grid_constant__ CUtensorMap out_map,
                      const int* __restrict__ sizes, int M, int k_tiles,
                      int n_tiles, int band) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES *
                                               C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;

  // launch order: group by group; within a group, bands of `band` column
  // tiles, every k tile of a band before the next band, the column tile
  // fastest within a band (the blocks in flight share the group's rows
  // of lhs and dout in L2)
  const int per_group = k_tiles * n_tiles;
  const int g = blockIdx.x / per_group;
  const int r = blockIdx.x - g * per_group;
  const int per_band = k_tiles * band;
  const int bi = r / per_band;
  const int rb = r - bi * per_band;
  const int width = min(band, n_tiles - bi * band);
  const int k0 = (rb / width) * C::BM;
  const int n0 = (bi * band + rb % width) * C::BN;
  // the group's rows from the sizes on the device (every thread; E is
  // small), ends clamped to M
  int rs = 0, re = 0;
  for (int e = 0; e <= g; ++e) {
    rs = re;
    re = min(re + max(sizes[e], 0), M);
  }
  const int chunks = (re - rs + BK - 1) / BK;  // 0 for an empty group

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  constexpr int CONSUMER_THREADS = C::CONSUMERS * 128;

  if (wg == C::CONSUMERS) {  // producer
    if (threadIdx.x % 128 == 0) {
      for (int c = 0; c < chunks; ++c) {
        const int s = c % C::STAGES;
        if (c >= C::STAGES) mbar_wait(&empty[s], (c / C::STAGES - 1) & 1);
        uint8_t* a = ring + s * C::STAGE_BYTES;
        uint8_t* b = a + C::A_BYTES;
        // any row coordinate: TMA zero-fills only rows >= M
        const int row = rs + c * BK;
        mbar_arrive_expect_tx(&full[s], C::STAGE_BYTES);
#pragma unroll
        for (int j = 0; j < C::BM / 64; ++j)
          tma_load_2d(a + j * BOX, &lhs_map, &full[s], k0 + 64 * j, row);
#pragma unroll
        for (int j = 0; j < C::BN / 64; ++j)
          tma_load_2d(b + j * BOX, &dout_map, &full[s], n0 + 64 * j, row);
      }
    }
    return;
  }

  float acc[C::BN / 2];
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) acc[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % C::STAGES;
    mbar_wait(&full[s], (c / C::STAGES) & 1);
    uint8_t* stage = ring + s * C::STAGE_BYTES;
    const int valid = re - (rs + c * BK);
    if (valid < BK) {
      // the last chunk: its rows at or past re belong to the next group
      // (or to none). Zero them in every box of both operands. A row is
      // one whole 128-byte swizzle row, so the swizzle does not move it.
      const int dead = BK - valid;
      constexpr int BOXES = (C::BM + C::BN) / 64;
      for (int i = threadIdx.x; i < BOXES * dead * 8; i += CONSUMER_THREADS) {
        const int box = i / (dead * 8), rest = i - box * dead * 8;
        *reinterpret_cast<uint4*>(stage + box * BOX + (valid + rest / 8) * 128 +
                                  (rest % 8) * 16) = make_uint4(0, 0, 0, 0);
      }
      fence_proxy_async();
      named_barrier(1, CONSUMER_THREADS);
    }
    const uint8_t* a = stage + wg * BOX;  // this warpgroup's 64 k
    const uint8_t* b = stage + C::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A (lhs_g^T, M-major: k contiguous) and B (dout_g, N-major): boxes
      // of [64 rows][64 columns], the k16 step 16 rows down
      const uint64_t da = smem_desc(a + kk * 16 * 128, BOX, 1024);
      const uint64_t db = smem_desc(b + kk * 16 * 128, BOX, 1024);
      wgmma<1, 1>(acc, da, db);
    }
    wgmma_commit();
    // one group in flight: the previous stage's group has retired
    wgmma_wait<1>();
    if (c > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(&empty[(c - 1) % C::STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // fragment of m64nNk16: thread (warp w, lane l) holds k rows 16 w + l / 4
  // (+ 8) and, in each 8-column group j, columns 8 j + 2 (l % 4) (+ 1)
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int r_lo = (tid / 32) * 16 + lane / 4;  // within the warpgroup's 64
  // every wgmma of both warpgroups has read its operands: the ring is free
  named_barrier(1, CONSUMER_THREADS);
  // this warpgroup's 64 x BN tile as BN / 64 swizzled [64][64] boxes
  uint8_t* st = ring + wg * (C::BN / 64) * BOX;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + 8 * h;
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          st + (j / 8) * BOX + row * 128 + (((j % 8) ^ (row % 8)) * 16) +
          (lane % 4) * 4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  fence_proxy_async();
  named_barrier(2 + wg, 128);
  if (tid == 0) {
    // TMA clips the parts of a box at k >= K or n >= N
#pragma unroll
    for (int j = 0; j < C::BN / 64; ++j)
      tma_store_3d(&out_map, st + j * BOX, n0 + 64 * j, k0 + wg * 64, g);
    tma_store_commit_and_drain();
  }
}

template <class C, bool TRANS>
int launch(const void* lhs, const void* rhs, const int* sizes, void* out,
           int M, int K, int N, int E, cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return ERR_NO_ENCODE;
  CUtensorMap lhs_map, rhs_map;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t a_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t a_box[2] = {BK, C::BM};
  // rhs [E, N, K] (gmm^T) or [E, K, N] (gmm), innermost first
  const cuuint64_t inner = TRANS ? K : N, outer = TRANS ? N : K;
  const cuuint64_t b_dims[3] = {inner, outer, (cuuint64_t)E};
  const cuuint64_t b_strides[2] = {inner * 2, inner * outer * 2};
  const cuuint32_t b_box[3] = {BK, TRANS ? (cuuint32_t)C::BN : BK, 1};
  if (!encode(enc, &lhs_map, lhs, 2, a_dims, a_strides, a_box) ||
      !encode(enc, &rhs_map, rhs, 3, b_dims, b_strides, b_box))
    return ERR_TENSOR_MAP;
  auto kernel = gmm_wgmma_kernel<C, TRANS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int items = (M + C::BM - 1) / C::BM + E;
  const int n_tiles = (N + C::BN - 1) / C::BN;
  static_assert(BAND_COLS % C::BN == 0, "a band is whole column tiles");
  const int band = n_tiles < BAND_COLS / C::BN ? n_tiles : BAND_COLS / C::BN;
  kernel<<<items * n_tiles, C::THREADS, C::SMEM, stream>>>(
      lhs_map, rhs_map, sizes, static_cast<__nv_bfloat16*>(out), M, K, N, E,
      items, n_tiles, band);
  return (int)cudaGetLastError();
}

template <class C>
int launch_tgmm(const void* lhs, const void* dout, const int* sizes,
                void* out, int M, int K, int N, int E, cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return ERR_NO_ENCODE;
  CUtensorMap lhs_map, dout_map, out_map;
  const cuuint32_t box[3] = {64, BK, 1};  // 64 columns x 64 rows
  const cuuint64_t l_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t l_strides[1] = {(cuuint64_t)K * 2};
  const cuuint64_t d_dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t d_strides[1] = {(cuuint64_t)N * 2};
  const cuuint64_t o_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t o_strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)N * K * 2};
  if (!encode(enc, &lhs_map, lhs, 2, l_dims, l_strides, box) ||
      !encode(enc, &dout_map, dout, 2, d_dims, d_strides, box) ||
      !encode(enc, &out_map, out, 3, o_dims, o_strides, box))
    return ERR_TENSOR_MAP;
  auto kernel = tgmm_wgmma_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int k_tiles = (K + C::BM - 1) / C::BM;
  const int n_tiles = (N + C::BN - 1) / C::BN;
  static_assert(BAND_COLS % C::BN == 0, "a band is whole column tiles");
  const int band = n_tiles < BAND_COLS / C::BN ? n_tiles : BAND_COLS / C::BN;
  kernel<<<E * k_tiles * n_tiles, C::THREADS, C::SMEM, stream>>>(
      lhs_map, dout_map, out_map, sizes, M, k_tiles, n_tiles, band);
  return (int)cudaGetLastError();
}

}  // namespace tc

namespace {

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// rows at or below this use small row tiles (decode and small prefill
// batches: 32 rows in the scalar kernel, 64 in the tensor-core one),
// above it 128-row tiles
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

// The tensor-core gmm (transpose 0) and gmm^T (1): bf16 lhs [M, K], rhs
// [E, K, N] or [E, N, K], out [M, N], all contiguous; K > 0 and N
// multiples of 8 and lhs, rhs and out 16-byte aligned (TMA's rules), which
// the caller checks (ops/grouped_matmul.py gmm_variant). Returns a
// cudaError_t, or a negative code of the tensor-map path
// (dstpu_cuda_error_string names it).
extern "C" int dstpu_gmm_wgmma(int transpose, const void* lhs,
                               const void* rhs, const void* group_sizes,
                               void* out, int M, int K, int N, int E,
                               void* stream) {
  if (M <= 0 || N <= 0 || E <= 0) return 0;
  if (K <= 0 || K % 8 || N % 8 ||
      ((uintptr_t)lhs | (uintptr_t)rhs | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  const int* sizes = static_cast<const int*>(group_sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // decode and small prefill batches: one consumer warpgroup, 64-row
  // tiles and a deeper ring (the weights stream through at HBM rate)
  using Small = tc::Tile<64, 128, 8>;
  using Wide = tc::Tile<128, 256, 4>;
  if (M <= SMALL_M)
    return transpose
               ? tc::launch<Small, true>(lhs, rhs, sizes, out, M, K, N, E, s)
               : tc::launch<Small, false>(lhs, rhs, sizes, out, M, K, N, E, s);
  return transpose
             ? tc::launch<Wide, true>(lhs, rhs, sizes, out, M, K, N, E, s)
             : tc::launch<Wide, false>(lhs, rhs, sizes, out, M, K, N, E, s);
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

// The tensor-core tgmm: bf16 lhs [M, K], dout [M, N], out [E, K, N], all
// contiguous; K and N positive multiples of 8 and the three 16-byte
// aligned (the caller checks: ops/grouped_matmul.py tgmm_variant).
// Returns a cudaError_t or a negative tensor-map code.
extern "C" int dstpu_tgmm_wgmma(const void* lhs, const void* dout,
                                const void* group_sizes, void* out, int M,
                                int K, int N, int E, void* stream) {
  if (E <= 0) return 0;
  if (K <= 0 || N <= 0 || K % 8 || N % 8 ||
      ((uintptr_t)lhs | (uintptr_t)dout | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0)  // every group empty: no rows to map
    return (int)cudaMemsetAsync(out, 0, (size_t)E * K * N * 2, s);
  const int* sizes = static_cast<const int*>(group_sizes);
  return tc::launch_tgmm<tc::Tile<128, 256, 4>>(lhs, dout, sizes, out, M, K,
                                                 N, E, s);
}

extern "C" const char* dstpu_cuda_error_string(int code) {
  return tc::error_string(code);
}
