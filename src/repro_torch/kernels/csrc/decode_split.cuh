// Split-KV decode attention on the tensor cores for Hopper (sm_90a): the
// one routine behind the bf16 decode family.
//
// Replaces, in bf16, the TPU kernels repro/kernels/paged_attention.py:
// paged_attention (one new token per request over a page pool through a
// page table), repro/kernels/spec_verify.py:spec_verify (a window of W
// in-flight tokens per slot over the same pool) and, through a dense cache
// viewed as a pool of 16-key pages with an identity table,
// repro/kernels/decode_attention.py:decode_attention.  One routine, so that
// spec row w and a one-token call at len + w + 1, and a dense row and the
// same keys in pages, run the same arithmetic and give the same bits.
//
// Each slot has L committed keys before its first query and wl live
// queries; query w sits at position L + w and attends keys k with
// k <= L + w, k < key_lim (the key cap and pages_bound * ps) and, with a
// window, L + w - k < window.  paged_attention is the instance W = 1 with
// L = len - 1 and wl = (len > 0).  Queries past wl, rows with no live key
// and length-0 slots come out exactly zero.
//
// Bound on this card: bytes.  A key row is read once for 2 * W * rep * d
// multiply-adds (rep = h / kvh query heads per kv head), far below the
// H100's ~295 operations per byte at every shape the engines give.  What
// the design does about it: enough blocks to keep the card's memory busy,
// and no byte read twice within a block.
//
//  - Split the keys.  The key range is cut into splits of split_keys keys
//    (a whole number of pages and of BK-key chunks, fixed by page size and
//    head dim alone, anchored at key 0), one block per (slot, kv head, row
//    chunk, split): at 8 slots of ~420 live keys, 64-key splits give ~100
//    working blocks.  A block whose split holds no live key of its rows
//    writes "no key" (m = NEG_INF) for them and stops.
//  - Query rows as m16 tiles.  Tile row w * rep + i holds window position w
//    and query head g * rep + i; each warp owns 16 rows, a block up to 8
//    warps, and a group or window wider than that spans row chunks (more
//    blocks, each reading the split's K/V again).
//  - K/V through the page table into a two-stage ring of BK keys by 16-byte
//    cp.async (keys outside the block's live range zero-filled, never
//    read), so the next chunk loads while this one is multiplied.  An
//    int8/fp8 pool rides the ring as 1-byte codes (half the bytes) with its
//    f32 row scales, and each chunk's codes are widened to bf16 in shared
//    memory (flash_tile.cuh widen): an int8 code and an e4m3 value are both
//    exact in bf16.
//  - The math: S = Q K^T and O += P V by mma.sync m16n8k16, bf16 in, f32
//    accumulate; k_scale multiplies S's column in f32; the online softmax
//    runs in f32 registers (log2 units); v_scale multiplies P's column, and
//    P enters P V as two bf16 terms (mma.cuh split_bf16).
//  - Combine.  Each block writes its rows' (m, l, acc) for its split; a
//    second launch (decode_split_combine) merges a row's splits in split
//    order, skipping splits with no live key, into acc / max(l, 1e-37) in
//    bf16.  Two CUDA launches a call.
//
// Exactness: chunk and split boundaries sit at fixed multiples of BK and
// split_keys from key 0; a chunk with no live key of a row leaves its m, l
// and acc exactly as they were (alpha 1 by an explicit test, p 0 by the
// mask); a split with no live key of a row adds nothing in the combine.  A
// row's output so depends only on its query, its position and its live
// keys: not on W, the rows beside it, pages_bound or the table's width.
#pragma once

#include "flash_tile.cuh"

namespace rt {
namespace split {
namespace {  // each source that includes this builds its own instances

using bf16 = __nv_bfloat16;
using tile::exp2_approx;
using tile::kLog2e;
using tile::widen;
constexpr int kMaxWarps = 8;  // warps (16 query rows each) of a block
constexpr int kStages = 2;    // K/V chunks in the ring
constexpr int kCombineThreads = 128;

struct Args {
  const bf16* q;            // (b, W, h, d)
  const void* k_pages;      // (num_pages, ps, kvh, d): bf16, or int8/fp8 codes
  const void* v_pages;
  const float* k_scales;    // (num_pages, ps, kvh) with codes, else null
  const float* v_scales;
  const int32_t* table;     // (b, table_stride), or null: the identity table
  const int32_t* lengths;   // (b,)
  const int32_t* window_lens;  // (b,), or null: the one-token instance
  float* part_m;            // (b, kvh, n_splits, R), R = W * rep
  float* part_l;
  float* part_acc;          // (b, kvh, n_splits, R, d)
  bf16* out;                // (b, W, h, d)
  int b, W, h, kvh, d, ps, table_stride, key_lim, window, split_keys, rows, row_chunks,
      n_splits, store;
  float scale, softcap;
};

// L committed keys before the first query, wl live queries
struct Slot {
  int L, wl;
};

__device__ __forceinline__ Slot slot_of(const Args& a, int bi) {
  const int len = a.lengths[bi];
  if (a.window_lens != nullptr) return {len, a.window_lens[bi]};
  return {len - 1, len > 0 ? 1 : 0};
}

__host__ __device__ constexpr int block_k(int d) { return d <= 128 ? 32 : 16; }

// Q tile, then the K/V ring: bf16 tiles per stage (bf16 pool), or one bf16
// tile pair plus code tiles and scales per stage (int8/fp8 pool)
__host__ __device__ constexpr size_t smem_bytes(int d, int bk, int rows, int stages, bool quant) {
  return sizeof(bf16) * (size_t)rows * (d + 8) +
         (quant ? sizeof(bf16) * 2 * (size_t)bk * (d + 8) +
                      (size_t)stages * 2 * bk * (d + 4)
                : sizeof(bf16) * (size_t)stages * 2 * bk * (d + 8));
}

template <int D, int BK, bool kQuant>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) decode_split_kernel(const Args a) {
  using namespace rt::mma;
  using Lay = Padded<D>;
  constexpr int kChunks = D / 8;      // 16-byte bf16 chunks of a row
  constexpr bool kQInRegs = D <= 128;
  static_assert(BK % 16 == 0, "whole k16 steps of P V");

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int rep = a.h / a.kvh, R = a.W * rep;
  const int rc = (int)(blockIdx.x % (unsigned)a.row_chunks);
  const int bg = (int)(blockIdx.x / (unsigned)a.row_chunks);
  const int bi = bg / a.kvh, g = bg % a.kvh, s = blockIdx.y;
  const int row0 = rc * a.rows, row_end = imin(row0 + a.rows, R);
  const Slot sl = slot_of(a, bi);
  // the live keys of the block's rows, [lo, hi), and their part in this split
  const int w_first = row0 / rep, w_last = imin((row_end - 1) / rep, sl.wl - 1);
  const int hi = w_last >= w_first ? imin(sl.L + w_last + 1, a.key_lim) : 0;
  const int lo = a.window > 0 ? imax(sl.L + w_first - a.window + 1, 0) : 0;
  const int k_begin = imax(s * a.split_keys, lo), k_end = imin((s + 1) * a.split_keys, hi);
  const int64_t part0 = ((int64_t)bg * a.n_splits + s) * R;
  if (k_begin >= k_end) {
    for (int r = row0 + tid; r < row_end; r += nthreads) a.part_m[part0 + r] = kNegInf;
    return;
  }

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);          // rows x (D + 8)
  bf16* sK = sQ + a.rows * Lay::kStride;                 // ring (bf16) or one tile (codes)
  bf16* sV = sK + (kQuant ? 1 : kStages) * BK * Lay::kStride;
  uint8_t* cK = reinterpret_cast<uint8_t*>(sV + (kQuant ? 1 : kStages) * BK * Lay::kStride);
  uint8_t* cV = cK + kStages * BK * D;                   // code ring (int8/fp8)
  float* sKs = reinterpret_cast<float*>(cV + kStages * BK * D);
  float* sVs = sKs + kStages * BK;

  // the block's query rows; rows past R load the last one and are never stored
  for (int i = tid; i < a.rows * kChunks; i += nthreads) {
    const int row = i / kChunks, c = i % kChunks;
    const int r = imin(row0 + row, R - 1);
    const bf16* src =
        a.q + (((int64_t)bi * a.W + r / rep) * a.h + g * rep + r % rep) * D + c * 8;
    cp_async_16(sQ + Lay::at(row, c), src, true);
  }
  cp_async_commit();

  const int32_t* trow = a.table == nullptr ? nullptr : a.table + (int64_t)bi * a.table_stride;
  // pool row of key `key` (its page through the table, or with no table
  // page bi * table_stride + key / ps: a dense cache viewed as a pool), kv head g
  auto pool_row = [&](int key) -> int64_t {
    const int64_t page = trow != nullptr ? (int64_t)trow[key / a.ps]
                                         : (int64_t)bi * a.table_stride + key / a.ps;
    return (page * a.ps + key % a.ps) * a.kvh + g;
  };
  auto load = [&](int key0, int stage) {
    if constexpr (!kQuant) {
      const bf16* kp = static_cast<const bf16*>(a.k_pages);
      const bf16* vp = static_cast<const bf16*>(a.v_pages);
      bf16* dk = sK + stage * BK * Lay::kStride;
      bf16* dv = sV + stage * BK * Lay::kStride;
      for (int i = tid; i < BK * kChunks; i += nthreads) {
        const int j = i / kChunks, c = i % kChunks, key = key0 + j;
        const bool ok = key >= lo && key < hi;
        const int64_t src = ok ? pool_row(key) * D + c * 8 : 0;
        cp_async_16(dk + Lay::at(j, c), kp + src, ok);
        cp_async_16(dv + Lay::at(j, c), vp + src, ok);
      }
    } else {
      constexpr int kCodeChunks = D / 16;   // 16-byte chunks of a code row
      const uint8_t* kp = static_cast<const uint8_t*>(a.k_pages);
      const uint8_t* vp = static_cast<const uint8_t*>(a.v_pages);
      for (int i = tid; i < BK * kCodeChunks; i += nthreads) {
        const int j = i / kCodeChunks, c = i % kCodeChunks, key = key0 + j;
        const bool ok = key >= lo && key < hi;
        const int64_t src = ok ? pool_row(key) * D + c * 16 : 0;
        cp_async_16(cK + (stage * BK + j) * D + c * 16, kp + src, ok);
        cp_async_16(cV + (stage * BK + j) * D + c * 16, vp + src, ok);
      }
      for (int j = tid; j < BK; j += nthreads) {
        const int key = key0 + j;
        const bool ok = key >= lo && key < hi;
        const int64_t src = ok ? pool_row(key) : 0;
        cp_async_4(sKs + stage * BK + j, a.k_scales + src, ok);
        cp_async_4(sVs + stage * BK + j, a.v_scales + src, ok);
      }
    }
  };

  const int kb_lo = k_begin / BK, kb_hi = (k_end + BK - 1) / BK;
  // the ring: chunk kb_lo + t in stage t % kStages, kStages - 1 in flight
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (kb_lo + t < kb_hi) load((kb_lo + t) * BK, t);
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31, group = lane >> 2, quad_t = lane & 3;
  const int wrow = warp * 16;
  // this lane's two rows (group, group + 8): their live keys [row_lo, row_hi)
  int row_lo[2], row_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + wrow + group + 8 * i, w = r / rep, q_pos = sl.L + w;
    const bool live = r < R && w < sl.wl;
    row_hi[i] = live ? imin(q_pos + 1, a.key_lim) : 0;
    row_lo[i] = a.window > 0 ? imax(q_pos - a.window + 1, 0) : 0;
  }
  auto q_frag = [&](int kk, uint32_t (&f)[4]) {
    ldmatrix_x4(f, sQ + Lay::at(wrow + (lane & 15), 2 * kk + (lane >> 4)));
  };
  uint32_t qf[kQInRegs ? D / 16 : 1][4];
  cp_async_wait<kStages - 1>();  // Q has landed
  __syncthreads();
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) q_frag(kk, qf[kk]);
  }
  const bool capped = a.softcap > 0.f;
  const float sl2 = a.scale * kLog2e, cap = a.softcap * kLog2e, cap_in = a.scale / a.softcap;
  const bool fp8 = a.store == kKVFp8;
  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int t = kb - kb_lo, stage = t % kStages, k0 = kb * BK;
    cp_async_wait<kStages - 2>();  // chunk kb has landed
    // every warp sees the chunk and is done with the stage (and, with
    // codes, the bf16 tile) that the next copy and widening overwrite
    __syncthreads();
    if (kb + kStages - 1 < kb_hi) load((kb + kStages - 1) * BK, (t + kStages - 1) % kStages);
    cp_async_commit();
    const bf16 *tk, *tv;
    const float *ks = nullptr, *vs = nullptr;
    if constexpr (kQuant) {
      const uint8_t* ck = cK + stage * BK * D;
      const uint8_t* cv = cV + stage * BK * D;
      for (int i = tid; i < BK * kChunks; i += nthreads) {
        const int j = i / kChunks, c = i % kChunks;
        *reinterpret_cast<uint4*>(sK + Lay::at(j, c)) =
            widen(*reinterpret_cast<const uint2*>(ck + j * D + c * 8), fp8);
        *reinterpret_cast<uint4*>(sV + Lay::at(j, c)) =
            widen(*reinterpret_cast<const uint2*>(cv + j * D + c * 8), fp8);
      }
      __syncthreads();
      tk = sK;
      tv = sV;
      ks = sKs + stage * BK;
      vs = sVs + stage * BK;
    } else {
      tk = sK + stage * BK * Lay::kStride;
      tv = sV + stage * BK * Lay::kStride;
    }

    // S = Q K^T: 16 rows x BK keys per warp
    float sc[BK / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = qf[kk][e];
      } else {
        q_frag(kk, af);
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[4];  // keys 16np..+7 and +8..+15, d chunks 2kk and 2kk+1
        ldmatrix_x4(kf, tk + Lay::at(16 * np + (lane & 7) + ((lane >> 4) << 3),
                                     2 * kk + ((lane >> 3) & 1)));
        mma_bf16(sc[2 * np], af, kf[0], kf[1]);
        mma_bf16(sc[2 * np + 1], af, kf[2], kf[3]);
      }
    }

    // online softmax in log2 units; masked scores are exactly NEG_INF
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * quad_t + (e & 1), key = k0 + j, i = e >> 1;
        float x = sc[n][e];
        if constexpr (kQuant) x *= ks[j];
        x = capped ? cap * tanhf(x * cap_in) : x * sl2;
        sc[n][e] = key >= row_lo[i] && key < row_hi[i] ? x : kNegInf;
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * i], sc[n][2 * i + 1]));
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
        const float x = sc[n][e];
        const float p = x == kNegInf ? 0.f : exp2_approx(x - m[e >> 1]);
        sum[e >> 1] += p;
        // v_scale folds into P's column (after the row sum, which it is not part of)
        if constexpr (kQuant) {
          sc[n][e] = p * vs[8 * n + 2 * quad_t + (e & 1)];
        } else {
          sc[n][e] = p;
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: per 16 keys, the two bf16 terms of P against V fragments by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pb[4], pl[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], pb[0], pl[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], pb[1], pl[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], pb[2], pl[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], pb[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];  // keys 16kk..+7 / +8..+15 of d chunks 2dp and 2dp+1
        ldmatrix_x4_trans(vf, tv + Lay::at(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                           2 * dp + (lane >> 4)));
        mma_bf16(o[2 * dp], pb, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pb, vf[2], vf[3]);
        mma_bf16(o[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // this split's (m, l, acc) of the lane's rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = row0 + wrow + group + 8 * i;
    if (r >= R) continue;
    const int64_t pr = part0 + r;
    if (quad_t == 0) {
      a.part_m[pr] = m[i];
      a.part_l[pr] = li;
    }
    float* acc = a.part_acc + pr * D + 2 * quad_t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(acc + 8 * n) = make_float2(o[n][2 * i], o[n][2 * i + 1]);
  }
}

// One thread per 4 output columns of a row: the row's splits in order,
// those with a live key only, rescaled to their common max.
__global__ void __launch_bounds__(kCombineThreads) decode_split_combine(const Args a) {
  const int rep = a.h / a.kvh, R = a.W * rep, d4 = a.d / 4;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)a.b * a.kvh * R * d4) return;
  const int c = (int)(i % d4) * 4;
  const int64_t row = i / d4;  // (b * kvh + g) * R + r
  const int r = (int)(row % R);
  const int64_t bg = row / R;
  const int bi = (int)(bg / a.kvh), g = (int)(bg % a.kvh);
  const float* pm = a.part_m + bg * a.n_splits * R + r;
  float mx = kNegInf;
  for (int s = 0; s < a.n_splits; ++s) mx = fmaxf(mx, pm[(int64_t)s * R]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < a.n_splits; ++s) {
    const float ms = pm[(int64_t)s * R];
    if (ms == kNegInf) continue;  // no live key of the row in split s
    const int64_t pr = (bg * a.n_splits + s) * R + r;
    const float f = exp2f(ms - mx);
    const float4 v = *reinterpret_cast<const float4*>(a.part_acc + pr * a.d + c);
    l += a.part_l[pr] * f;
    acc.x += v.x * f;
    acc.y += v.y * f;
    acc.z += v.z * f;
    acc.w += v.w * f;
  }
  const float inv = 1.f / fmaxf(l, kMinL);
  bf16* dst = a.out + (((int64_t)bi * a.W + r / rep) * a.h + g * rep + r % rep) * a.d + c;
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(mma::pack_bf16(acc.x * inv, acc.y * inv), mma::pack_bf16(acc.z * inv, acc.w * inv));
}

template <int D, bool kQuant>
int launch(const Args& a, int block_k_, int stages, cudaStream_t st) {
  constexpr int BK = block_k(D);
  if (block_k_ != BK || stages != kStages || a.split_keys % BK) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, BK, a.rows, kStages, kQuant);
  auto kernel = decode_split_kernel<D, BK, kQuant>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (int64_t)a.b * a.kvh * a.row_chunks;
  if (blocks > 0x7fffffff || a.n_splits > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks, a.n_splits), 32 * (a.rows / 16), smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t threads = (int64_t)a.b * a.kvh * a.W * (a.h / a.kvh) * (a.d / 4);
  decode_split_combine<<<(unsigned)((threads + kCombineThreads - 1) / kCombineThreads),
                         kCombineThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// The C entry of one pool kind: argument checks, then the head dim's
// instance.  The (d, block_k, stages) tuples built are the RT_SPLIT lines
// (kernels/decode_split.py plan).
template <bool kQuant>
int entry(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
          const void* v_scales, const void* table, const void* lengths, const void* window_lens,
          void* part_m, void* part_l, void* part_acc, void* out, int b, int W, int h, int kvh,
          int d, int ps, int table_stride, int max_pages, int key_cap, int window,
          int split_keys, int block_k_, int tile_rows, int stages, int kv_store, float scale,
          float softcap, void* stream) {
  if (b <= 0 || W <= 0 || kvh <= 0 || h % kvh || ps <= 0 || ps % 8 || max_pages <= 0 ||
      max_pages > table_stride || key_cap <= 0 || split_keys <= 0 || split_keys % ps ||
      tile_rows <= 0 || tile_rows % 16 || tile_rows > 16 * kMaxWarps ||
      (kv_store != kKVSame) != kQuant || !kv_args_ok(kv_store, k_scales, v_scales))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const bf16*)q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scales = (const float*)k_scales;
  a.v_scales = (const float*)v_scales;
  a.table = (const int32_t*)table;
  a.lengths = (const int32_t*)lengths;
  a.window_lens = (const int32_t*)window_lens;
  a.part_m = (float*)part_m;
  a.part_l = (float*)part_l;
  a.part_acc = (float*)part_acc;
  a.out = (bf16*)out;
  a.b = b;
  a.W = W;
  a.h = h;
  a.kvh = kvh;
  a.d = d;
  a.ps = ps;
  a.table_stride = table_stride;
  const int64_t keys = (int64_t)max_pages * ps;
  a.key_lim = (int)(keys < key_cap ? keys : key_cap);
  a.window = window;
  a.split_keys = split_keys;
  a.rows = tile_rows;
  const int R = W * (h / kvh);
  a.row_chunks = (R + tile_rows - 1) / tile_rows;
  a.n_splits = (a.key_lim + split_keys - 1) / split_keys;
  a.store = kv_store;
  a.scale = scale;
  a.softcap = softcap;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_SPLIT(D, BK, ST)                                      \
  if (d == D) {                                                  \
    static_assert(block_k(D) == BK && kStages == ST, "the plan"); \
    return launch<D, kQuant>(a, block_k_, stages, st);           \
  }
  RT_SPLIT(16, 32, 2)
  RT_SPLIT(32, 32, 2)
  RT_SPLIT(48, 32, 2)
  RT_SPLIT(64, 32, 2)
  RT_SPLIT(80, 32, 2)
  RT_SPLIT(96, 32, 2)
  RT_SPLIT(112, 32, 2)
  RT_SPLIT(128, 32, 2)
  RT_SPLIT(144, 16, 2)
  RT_SPLIT(160, 16, 2)
  RT_SPLIT(176, 16, 2)
  RT_SPLIT(192, 16, 2)
  RT_SPLIT(208, 16, 2)
  RT_SPLIT(224, 16, 2)
  RT_SPLIT(240, 16, 2)
  RT_SPLIT(256, 16, 2)
#undef RT_SPLIT
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace split
}  // namespace rt
