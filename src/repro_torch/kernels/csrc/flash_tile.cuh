// The bf16 flash tile on the tensor cores: the device pieces that
// flash_attention.cu and the varlen_prefill tensor-core kernels
// (varlen_prefill_tc.cuh) share, and the exact widening of int8/fp8 codes to
// bf16 that those kernels and the split-KV decode routine (decode_split.cuh)
// share.  One copy, so that the kernels run one arithmetic.
//
// A block owns a run of query rows of one kv head, numbered position * rep +
// head-in-group inside a "sequence" of sq positions (flash: a batch row;
// varlen_prefill: one page of the packed buffer).  Each warp owns 16 rows and
// keeps their S fragment, running max m, sum l and accumulator O in
// registers (the m16n8 layout of mma.cuh); scores are in log2 units; a masked
// score is exactly NEG_INF and its p an explicit 0, so a tile with no live
// key of a row leaves that row's m, l and O exactly as they were; P enters
// P V as two bf16 terms (mma.cuh split_bf16); O / max(l, 1e-37) goes out as
// bf16 through shared memory in 16-byte stores.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace rt {
namespace tile {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {  // 2^x; -huge gives +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The query rows of a block and the keys they can see.  The block owns rows
// [row0, row0 + ROWS) of kv head g of sequence bi; rows past `total` do not
// exist and load the last one.
struct Rows {
  int sq, h, rep, total, row0, bi, g;
  int pos_first, pos_last;  // positions of its first and last live rows
  int lo, hi;               // the live keys of those rows: [lo, hi)

  // first element of tile row `row` in q and out, (sequences, sq, h, D)
  template <int D>
  __device__ __forceinline__ int64_t elem(int row) const {
    const int r = imin(row0 + row, total - 1);
    return (((int64_t)bi * sq + r / rep) * h + g * rep + r % rep) * D;
  }
};

// The block's `rows` query rows into a tile laid out by at(row, chunk), by
// `threads` threads in 16-byte copies.
template <int D, class At>
__device__ __forceinline__ void copy_q(bf16* dst, At at, const bf16* __restrict__ q, const Rows& r,
                                       int rows, int threads) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += threads) {
    const int row = i / kChunks, c = i % kChunks;
    mma::cp_async_16(dst + at(row, c), q + r.elem<D>(row) + c * 8, true);
  }
}

// One online-softmax step on a warp's S fragment over keys [k0, k0 + BK):
// scores to log2 units (scale, or softcap), the mask live(key, i) unless
// `full` (every row of the block sees every key of the tile), the running
// max m, the numerators p in place of the scores, this lane's share of the
// row sums l and the factor alpha that rescales the accumulator.  A row with
// no live key in the tile keeps m and l exactly (alpha 1, every p 0).  i is
// the lane's row: 0 for row `group`, 1 for row `group + 8`.
template <int BK, class Live>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 8][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool full, int k0, Live live,
                                             float scale, float softcap) {
  const int quad_t = threadIdx.x & 3;
  // each branch is uniform and outside the unrolled loops
  if (softcap > 0.f) {
    const float cap = softcap * kLog2e, in = scale / softcap;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = cap * tanhf(s[n][e] * in);
  } else {
    const float sl2 = scale * kLog2e;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= sl2;
  }
  if (!full) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * quad_t + (e & 1);
        s[n][e] = live(key, e >> 1) ? s[n][e] : kNegInf;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    alpha[i] = m_new == m[i] ? 1.f : exp2_approx(m[i] - m_new);
    m[i] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[n][e];
      // a masked score is exactly NEG_INF; its p is an explicit 0
      const float p = (!full && x == kNegInf) ? 0.f : exp2_approx(x - m[e >> 1]);
      s[n][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
}

// s[n][e] *= w[key of (n, e)] for per-key factors w of the tile (an int8/fp8
// pool's k_scale on S, v_scale on P)
template <int BK>
__device__ __forceinline__ void scale_keys(float (&s)[BK / 8][4], const float* w) {
  const int quad_t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] *= w[8 * n + 2 * quad_t + (e & 1)];
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N][4], const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

// P of keys 16kk..16kk+15 as the A fragments of its two bf16 terms.
template <int BK>
__device__ __forceinline__ void split_p(const float (&s)[BK / 8][4], int kk, uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
  using mma::split_bf16;
  split_bf16(s[2 * kk][0], s[2 * kk][1], big[0], small[0]);
  split_bf16(s[2 * kk][2], s[2 * kk][3], big[1], small[1]);
  split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], big[2], small[2]);
  split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], big[3], small[3]);
}

// This warp's 16 rows (wrow..wrow+15) of O / max(l, 1e-37) as bf16 into its
// own rows of the staging tile laid out by at(row, chunk), then 16-byte
// stores of the rows that exist.
template <int D, class At>
__device__ __forceinline__ void store_rows(bf16* stage, At at, const float (&o)[D / 8][4],
                                           const float (&l)[2], int wrow, const Rows& r,
                                           bf16* __restrict__ out) {
  constexpr int kChunks = D / 8;
  const int lane = threadIdx.x & 31, group = lane >> 2, quad_t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = 1.f / fmaxf(li, kMinL);
    const int row = wrow + group + 8 * i;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(stage + at(row, n) + 2 * quad_t) =
          mma::pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int row = wrow + i / kChunks, c = i % kChunks;
    if (r.row0 + row < r.total)
      *reinterpret_cast<uint4*>(out + r.elem<D>(row) + c * 8) =
          *reinterpret_cast<const uint4*>(stage + at(row, c));
  }
}

// ---------------------------------------------------------------------------
// d 128 on wgmma: operands in 128-byte-swizzled blocks,
// [64-column block][row][64], 16-byte chunk c of a row at c ^ (row % 8)
// ---------------------------------------------------------------------------
template <int ROWS>
__device__ __forceinline__ int sw128(int row, int chunk) {
  return (chunk >> 3) * ROWS * 64 + row * 64 + (((chunk & 7) ^ (row & 7)) << 3);
}

// S = Q K^T for this warp's warpgroup: Q the block's kRows x 128 tile, K a
// BK x 128 tile, both sw128; D/16 k16 steps along the two 64-column blocks.
template <int kRows, int BK>
__device__ __forceinline__ void wgmma_scores(float (&s)[BK / 8][4], const bf16* sQ,
                                             const bf16* tk, int warp) {
  using namespace mma;
  constexpr int D = 128;
  static_assert(BK == 32, "S is one m64n32 wgmma (mma.cuh wgmma_ss)");
  float(&sacc)[BK / 2] = *reinterpret_cast<float(*)[BK / 2]>(&s[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int qoff = (kk >> 2) * kRows * 64 + (warp >> 2) * 64 * 64 + (kk & 3) * 16;
    const int koff = (kk >> 2) * BK * 64 + (kk & 3) * 16;
    wgmma_ss(sacc, wgmma_desc(sQ + qoff, 16, 1024), wgmma_desc(tk + koff, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sacc);
}

// O += P V: per 16 keys, the two bf16 terms of P (from registers) against
// the sw128 V tile read transposed.
template <int BK>
__device__ __forceinline__ void wgmma_pv(float (&o)[16][4], const float (&s)[BK / 8][4],
                                         const bf16* tv) {
  using namespace mma;
  float(&oacc)[64] = *reinterpret_cast<float(*)[64]>(&o[0][0]);
  uint32_t pb[BK / 16][4], ps[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) split_p<BK>(s, kk, pb[kk], ps[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = wgmma_desc(tv + 16 * kk * 64, BK * 128, 1024);
    wgmma_rs(oacc, pb[kk], dv, 1);
    wgmma_rs(oacc, ps[kk], dv, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(oacc);
}

// ---------------------------------------------------------------------------
// other head dims on mma.sync m16n8k16: tiles of rows of D laid out by Lay
// (mma.cuh Swizzle<D> or Padded<D>)
// ---------------------------------------------------------------------------
// The A fragment of Q's k16 step kk for this warp's 16 rows.
template <class Lay>
__device__ __forceinline__ void q_frag(uint32_t (&a)[4], const bf16* sQ, int wrow, int kk) {
  const int lane = threadIdx.x & 31;
  mma::ldmatrix_x4(a, sQ + Lay::at(wrow + (lane & 15), 2 * kk + (lane >> 4)));
}

// S = Q K^T: 16 rows x BK keys per warp, Q fragments from registers (qf) or,
// where registers run out, re-read from sQ per step.
template <int D, int BK, class Lay, bool kQInRegs>
__device__ __forceinline__ void mma_scores(float (&s)[BK / 8][4],
                                           const uint32_t (&qf)[kQInRegs ? D / 16 : 1][4],
                                           const bf16* sQ, const bf16* tk, int wrow) {
  using namespace mma;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    if constexpr (kQInRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
    } else {
      q_frag<Lay>(a, sQ, wrow, kk);
    }
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t kf[4];  // keys 16np..+7 and +8..+15, d chunks 2kk and 2kk+1
      ldmatrix_x4(kf, tk + Lay::at(16 * np + (lane & 7) + ((lane >> 4) << 3),
                                   2 * kk + ((lane >> 3) & 1)));
      mma_bf16(s[2 * np], a, kf[0], kf[1]);
      mma_bf16(s[2 * np + 1], a, kf[2], kf[3]);
    }
  }
}

// O += P V: per 16 keys, the two bf16 terms of P against V fragments by
// ldmatrix.trans; the small terms trail the big ones by one column pair, so
// that two products into one accumulator never run back to back.
template <int D, int BK, class Lay>
__device__ __forceinline__ void mma_pv(float (&o)[D / 8][4], const float (&s)[BK / 8][4],
                                       const bf16* tv) {
  using namespace mma;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t pb[4], ps[4];
    split_p<BK>(s, kk, pb, ps);
    uint32_t vf[2][4];  // keys 16kk..+7 / +8..+15 of d chunks 2dp and 2dp+1
#pragma unroll
    for (int dp = 0; dp <= D / 16; ++dp) {
      if (dp < D / 16) {
        ldmatrix_x4_trans(vf[dp & 1], tv + Lay::at(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                   2 * dp + (lane >> 4)));
        mma_bf16(o[2 * dp], pb, vf[dp & 1][0], vf[dp & 1][1]);
        mma_bf16(o[2 * dp + 1], pb, vf[dp & 1][2], vf[dp & 1][3]);
      }
      if (dp > 0) {
        const int e = (dp - 1) & 1;
        mma_bf16(o[2 * dp - 2], ps, vf[e][0], vf[e][1]);
        mma_bf16(o[2 * dp - 1], ps, vf[e][2], vf[e][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// int8/fp8 codes widened to bf16: an int8 code and an e4m3 value are both
// exact in bf16, so the widened tile holds the codes' values exactly
// ---------------------------------------------------------------------------
// code i of a little-endian word
__device__ __forceinline__ float code_f32(uint32_t word, int i, bool fp8) {
  const uint32_t byte = (word >> (8 * i)) & 0xffu;
  if (fp8) {
    __nv_fp8_e4m3 v;
    v.__x = (__nv_fp8_storage_t)byte;
    return to_f32(v);
  }
  return (float)(int8_t)byte;
}

// 8 codes (int8, or e4m3 when fp8) as 8 bf16, exactly
__device__ __forceinline__ uint4 widen(uint2 c, bool fp8) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = i < 2 ? c.x : c.y;
    w[i] = mma::pack_bf16(code_f32(word, 2 * (i & 1), fp8), code_f32(word, 2 * (i & 1) + 1, fp8));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace tile
}  // namespace rt
