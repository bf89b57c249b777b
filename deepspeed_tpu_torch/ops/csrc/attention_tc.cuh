// The consumer step of the tensor-core attention forwards, shared by
// flash_fwd_wgmma_kernel (flash_attention.cu), blocksparse_fwd_wgmma_kernel
// (blocksparse_attention.cu) and paged_prefill_wgmma_kernel
// (paged_attention.cu): head dim 128, key tiles of 128, each consumer
// warpgroup owning 64 query rows as the fp32 m64n128k16 fragment.
//   S = Q K^T     wgmma m64n128k16, Q and K both K-major in shared memory
//                 (d in two [rows][64] boxes of 128-byte swizzle);
//   softmax       fp32 online softmax on the fragment in log2 units
//                 (scores times scale * log2 e, exp2), masked columns at
//                 NEG_INF with an exact-zero probability;
//   O += P V      P packed pairwise to bf16 as the register A operand (the
//                 FlashAttention-3 layout identity), V N-major in shared
//                 memory. P goes in one part (p rounded to bf16, as the
//                 flash and block-sparse TPU kernels round it) or two
//                 (p = hi + lo, both bf16: the paged TPU kernel keeps p in
//                 fp32, and hi + lo carries ~16 of its 24 bits).
// With two consumer warpgroups they take turns to issue their products
// (named barriers BAR_TURN + wg), so that one's softmax overlaps the
// other's products. Fragment: thread (warp w, lane l) of a warpgroup holds
// rows 16 w + l / 4 and + 8, and in each 8-column group j the columns
// 8 j + 2 (l % 4) (+ 1): x[4 j + 2 hh + e] is row + 8 hh, column
// 8 j + 2 (l % 4) + e. A row's max and sum reduce over a quad's 4 lanes.
// The host side encodes the 4-D tensor maps over [B, S, H, 128] views.
// Header only; every name lives in namespace attn_tc.

#pragma once

#include "hopper.cuh"

namespace attn_tc {

constexpr int D = 128;            // head dim
constexpr int BKV = 128;          // keys a tile
constexpr int HALF = 128 * 128;   // bytes of a [128 rows][64 d] box
constexpr int KV_BYTES = 2 * HALF;  // K or V of one tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
// named barriers 1 and 2: warpgroup 0's and 1's turn to issue products
constexpr int BAR_TURN = 1;

// rows [s, s + the map's box rows) of head h, batch b, both 64-wide halves
// of d, into two [rows][64] boxes `box` bytes apart (128 rows: HALF) through
// a map of encode_bshd (pos: the map dimension of head, seq and batch)
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int pos, int h,
                                          int s, int b, int box = HALF) {
  auto at = [&](int i) {
    return (pos & 3) == i ? h : ((pos >> 2) & 3) == i ? s : b;
  };
  tc::tma_load_4d(dst, map, bar, 0, at(1), at(2), at(3));
  tc::tma_load_4d(dst + box, map, bar, 64, at(1), at(2), at(3));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// sc = Q K^T for this warpgroup's 64 rows (qw: its rows of the first d
// box, the second q_half bytes on) against a 128-key tile ks, in this
// warpgroup's turn when NWG is 2. The caller has waited for K.
template <int NWG>
__device__ __forceinline__ void qk_scores(float (&sc)[64], const uint8_t* qw,
                                          int q_half, const uint8_t* ks,
                                          int wg) {
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  if (NWG == 2) tc::named_barrier(BAR_TURN + wg, 256);
  tc::wgmma_fence();
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma<0, 0>(sc, tc::smem_desc(qw + half * q_half + kk * 32, 16, 1024),
                      tc::smem_desc(ks + half * HALF + kk * 32, 16, 1024));
  tc::wgmma_commit();
  if (NWG == 2) tc::named_barrier_arrive(BAR_TURN + 1 - wg, 256);
  tc::wgmma_wait<0>();
  tc::fence_regs(sc);
}

// The fp32 online softmax of one tile: sc holds the raw scores and leaves
// with p; vis[hh] bit 2 j + e says whether column 8 j + 2 (l % 4) + e is
// visible to row + 8 hh; m (log2 units) and l are the rows' running max
// and denominator; o is rescaled by exp2(m_old - m_new). p is 0 exactly
// where a column is masked (while every score so far is NEG_INF,
// exp(s - m) would be exp(0)).
__device__ __forceinline__ void online_softmax(float (&sc)[64],
                                               const uint32_t (&vis)[2],
                                               float scale2, float (&m)[2],
                                               float (&l)[2], float (&o)[64]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * hh + e];
        x = (vis[hh] >> (2 * j + e) & 1u) ? x * scale2 : NEG_INF;
        mx = fmaxf(mx, x);
      }
    const float mn = fmaxf(m[hh], quad_max(mx));
    const float alpha = exp2f(m[hh] - mn);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * hh + e];
        x = (vis[hh] >> (2 * j + e) & 1u) ? exp2f(x - mn) : 0.f;
        sum += x;
      }
    l[hh] = alpha * l[hh] + quad_sum(sum);
    m[hh] = mn;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[4 * j + 2 * hh] *= alpha;
      o[4 * j + 2 * hh + 1] *= alpha;
    }
  }
}

// p rounded to bf16 as A registers: the fragment's columns 16 kk ..
// 16 kk + 15 (groups 2 kk and 2 kk + 1) are the A fragment of k16 step kk
__device__ __forceinline__ void pack_p(const float (&p)[64],
                                       uint32_t (&pa)[1][8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w)
      pa[0][kk][w] = pack_bf16(p[8 * kk + 2 * w], p[8 * kk + 2 * w + 1]);
}

// p = hi + lo: hi = bf16(p), lo = bf16(p - hi) (the difference is exact in
// fp32), so that hi V + lo V carries p to ~2^-16 of itself
__device__ __forceinline__ void pack_p_split(const float (&p)[64],
                                             uint32_t (&pa)[2][8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float a = p[8 * kk + 2 * w], b = p[8 * kk + 2 * w + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
      pa[0][kk][w] = *reinterpret_cast<const uint32_t*>(&hi);
      pa[1][kk][w] = pack_bf16(a - __low2float(hi), b - __high2float(hi));
    }
}

// O += P V over one 128-key tile vs (V N-major: two 64-d boxes HALF bytes
// apart, the k16 step 16 keys down), P in NP parts, in this warpgroup's
// turn when NWG is 2; hand_over passes the turn on (warpgroup 1's last
// hand-over has no taker). The caller has waited for V.
template <int NWG, int NP>
__device__ __forceinline__ void pv_product(float (&o)[64],
                                           const uint32_t (&pa)[NP][8][4],
                                           const uint8_t* vs, int wg,
                                           bool hand_over) {
  if (NWG == 2) tc::named_barrier(BAR_TURN + wg, 256);
  tc::wgmma_fence();
#pragma unroll
  for (int part = 0; part < NP; ++part)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      tc::wgmma_rs<1>(o, pa[part][kk],
                      tc::smem_desc(vs + kk * 16 * 128, HALF, 1024));
  tc::wgmma_commit();
  if (NWG == 2 && hand_over) tc::named_barrier_arrive(BAR_TURN + 1 - wg, 256);
  tc::wgmma_wait<0>();
  tc::fence_regs(o);
}

// one fragment row (hh) of O / l as bf16 into out[0 .. 128), 0 where l
// is 0 (a row that saw no column)
__device__ __forceinline__ void store_row(__nv_bfloat16* out,
                                          const float (&o)[64], int hh,
                                          float l, int q4) {
  const float ls = l == 0.f ? 1.f : l;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * q4) =
        __floats2bfloat162_rn(o[4 * j + 2 * hh] / ls,
                              o[4 * j + 2 * hh + 1] / ls);
}

// -- host ---------------------------------------------------------------------

// A 4-D map {d, then head, seq and batch ordered by stride} over a bf16
// [B, S, H, 128] tensor read at element strides st (batch, seq, head) with
// a [rows][64 d] box; *pos gets the map dimension (1..3) of head, seq and
// batch, two bits each.
inline bool encode_bshd(tc::EncodeTiled enc, CUtensorMap* map,
                        const void* base, int B, int S, int H,
                        const long long* st, int rows, int* pos) {
  long long size[3] = {H, S, B}, stride[3] = {st[2], st[1], st[0]};
  const cuuint32_t box_of[3] = {1, (cuuint32_t)rows, 1};
  // a dimension of size 1 is never stepped: any stride does, and the
  // tensor's span puts it last
  long long span = D;
  for (int i = 0; i < 3; ++i)
    if (size[i] > 1 && stride[i] * size[i] > span) span = stride[i] * size[i];
  for (int i = 0; i < 3; ++i)
    if (size[i] == 1) stride[i] = span;
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  cuuint64_t dims[4] = {D}, strides[3];
  cuuint32_t box[4] = {64};
  *pos = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)size[order[i]];
    strides[i] = (cuuint64_t)stride[order[i]] * 2;
    box[i + 1] = box_of[order[i]];
    *pos |= (i + 1) << (2 * order[i]);
  }
  return tc::encode(enc, map, base, 4, dims, strides, box);
}

}  // namespace attn_tc
