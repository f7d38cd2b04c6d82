// Packed varlen prefill attention on the tensor cores for Hopper (sm_90a):
// the bf16 routine behind varlen_prefill.
//
// Replaces, in bf16, the TPU kernel repro/kernels/varlen_prefill.py:
// varlen_prefill.  Prompt chunks of many requests share one token-packed
// buffer: chunk c owns rows [cu[c], cu[c+1]) (page-aligned spans), its first
// chunk_lens[c] rows are real tokens, and it starts at the absolute position
// pos0 = chunk_pos0[c].  A real row at position q_pos attends its request's
// committed context keys [0, cap), cap = min(pos0, ctx_bound * ps), through
// the page table, and its own chunk's keys [pos0, q_pos] from the packed
// K/V, both under the window; pad rows (chunk tails, buffer tail) come out
// exactly zero.
//
// Bound on this card: operations.  A block of R query rows does 4 * R * d
// flops per key it reads; at the engines' shapes (16 query heads per kv
// head, chunks of hundreds of tokens) that is far above the H100's ~295
// operations per byte.  The design is flash_attention's bf16 tile
// (flash_tile.cuh) with q_offset = pos0, over a key stream taken from two
// sources:
//
//  - Rows.  The rows of kv head g are numbered page by page of the packed
//    buffer: in one page, row i * rep + j is the page's token i and query
//    head g * rep + j, so a page is a "sequence" of ps positions to the
//    flash tile and every K/V tile a block reads serves the whole GQA group.
//    A block owns a fixed run of ROWS rows inside one page (glm4-9b, ps 16,
//    rep 16: two blocks of 128 a page; rep 48: six; a run past the page's
//    rows is partial and stores only the rows that exist).  Chunk spans are
//    page-aligned, so a block never holds rows of two chunks; it finds its
//    chunk by a scan of cu.  A block of pad rows only writes exact zeros and
//    stops; a pad row inside a live block has no live key and is stored as
//    exact zeros.
//  - Order.  A first launch (varlen_prefill_kernel_order, one block) counts
//    the key tiles each page's rows visit and ranks the pages by it,
//    heaviest first (ties by page): the main launch's blockIdx.x walks that
//    order, so the blocks with the most context plus causal keys start
//    first, as flash_attention's block_rows starts with its last row tiles.
//  - Keys by absolute position, in tiles of BK keys at fixed multiples of BK
//    from key 0.  A key k < cap is row k % ps of pool page
//    page_tables[c][k / ps]; a key pos0 <= k < pos0 + len is packed row
//    cu[c] + k - pos0.  A tile may hold context and own keys side by side
//    (pos0 is a multiple of ps, not of BK); each 16-byte copy picks its
//    source per key.  A block visits only the tiles that can hold a live key
//    of its rows (the gap [cap, pos0) that pages_bound leaves is skipped);
//    keys outside the live range are zero-filled and never read.  Tiles ride
//    a cp.async ring of ST stages, ST - 1 in flight while one is multiplied.
//  - Products: at d 128, two warpgroups of 64 rows on wgmma (S = Q K^T from
//    shared memory, O += P V with P from registers, 128-byte-swizzled
//    operands); at the other multiples of 16 up to 256, warps of 16 rows on
//    mma.sync m16n8k16 over rows padded to d + 8 (mma.cuh Padded), up to four
//    warps a block (fewer where a page has fewer rows).
//  - int8/fp8 context pages: the codes ride the ring as 1-byte values with
//    their f32 row scales and are widened to bf16 in shared memory, exactly,
//    into the same stage tile that the own keys reach as bf16 by cp.async;
//    k_scale multiplies S's column and v_scale P's (own keys: scale 1), as
//    decode_split.cuh does.
//
// Exactness: a tile with no live key of a row leaves its m, l and O exactly
// as they were, and tiles sit at fixed multiples of BK from key 0, so a row's
// output depends only on its query, its position and its live keys: not on
// the rows beside it in its block, where its chunk sits in the packed buffer,
// or whether its earlier keys came from the pool or the packed buffer.  On a
// bf16 pool a prompt prefilled whole and the same prompt split at a page
// boundary give the same bits for the rows of the second part.
#pragma once

#include "flash_tile.cuh"

namespace rt {
namespace varlen {
namespace {  // each source that includes this builds its own instances

using bf16 = __nv_bfloat16;
using tile::Rows;
constexpr int kBK = 32;          // keys per K/V tile
constexpr int kOrderThreads = 1024;
constexpr int kMmaMaxWarps = 4;  // mma.sync: warps (16 rows each) of a block

struct Args {
  const bf16* q;              // (T, h, d)
  const bf16* k;              // (T, kvh, d) packed chunk K
  const bf16* v;
  const void* k_pages;        // (num_pages, ps, kvh, d): bf16, or int8/fp8 codes
  const void* v_pages;
  const float* k_scales;      // (num_pages, ps, kvh) with codes, else null
  const float* v_scales;
  const int32_t* cu;          // (C + 1,)
  const int32_t* lens;        // (C,)
  const int32_t* pos0s;       // (C,)
  const int32_t* tables;      // (C, max_pages)
  int32_t* weight;            // (T / ps,) scratch: key tiles a page's rows visit
  int32_t* order;             // (T / ps,) scratch: pages, heaviest first
  bf16* out;                  // (T, h, d)
  int T, C, h, kvh, ps, max_pages, ctx_bound, window, rows, blocks_per_page, store;
  float scale, softcap;
};

// The chunk that owns packed page `page`: the last one whose span starts at
// or before it (empty chunks share their start with the next; the buffer
// tail maps to the last chunk and is pad by its length); off0 is the page's
// first token's offset in the chunk.
struct Chunk {
  int c, len, pos0, start, off0;
};

__device__ __forceinline__ Chunk chunk_of(const Args& a, int page) {
  Chunk ch;
  ch.c = 0;
  for (int i = 0; i < a.C; ++i)
    if (a.cu[i] <= page * a.ps) ch.c = i;
  ch.len = a.lens[ch.c];
  ch.pos0 = a.pos0s[ch.c];
  ch.start = a.cu[ch.c];
  ch.off0 = page * a.ps - ch.start;
  return ch;
}

// The keys of the live tokens i0..i1 of a page, as absolute positions:
// context [lo, cap) and own [max(lo, pos0), hi); and the tiles that meet
// them: nA from tile a0 on, then the rest from tile b0 on (tile_kb).
struct Keys {
  int lo, cap, pos0, hi, a0, nA, b0, n;
};

__device__ __forceinline__ Keys keys_of(const Args& a, const Chunk& ch, int i0, int i1) {
  Keys k;
  const int q0 = ch.pos0 + ch.off0 + i0, q1 = ch.pos0 + ch.off0 + i1;
  k.pos0 = ch.pos0;
  k.hi = q1 + 1;
  k.lo = a.window > 0 ? imax(q0 - a.window + 1, 0) : 0;
  k.cap = imin(ch.pos0, a.ctx_bound * a.ps);
  k.a0 = k.lo / kBK;
  k.nA = k.cap > k.lo ? (k.cap - 1) / kBK + 1 - k.a0 : 0;
  k.b0 = imax(imax(k.lo, k.pos0) / kBK, k.a0 + k.nA);
  k.n = k.nA + imax((k.hi - 1) / kBK + 1 - k.b0, 0);
  return k;
}

__device__ __forceinline__ int tile_kb(const Keys& k, int t) {
  return t < k.nA ? k.a0 + t : k.b0 + t - k.nA;
}

// Live tokens of a page: its first min(ps, len - off0) tokens, or none.
__device__ __forceinline__ int live_tokens(const Args& a, const Chunk& ch) {
  return imax(imin(a.ps, ch.len - ch.off0), 0);
}

// One block: the key tiles every page's rows visit, then the pages ranked
// by them, heaviest first, ties by page.
__global__ void __launch_bounds__(kOrderThreads) varlen_prefill_kernel_order(const Args a) {
  const int P = a.T / a.ps;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const Chunk ch = chunk_of(a, p);
    const int n = live_tokens(a, ch);
    a.weight[p] = n > 0 ? keys_of(a, ch, 0, n - 1).n : 0;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int w = a.weight[p];
    int rank = 0;
    for (int q = 0; q < P; ++q) {
      const int wq = a.weight[q];
      rank += wq > w || (wq == w && q < p);
    }
    a.order[rank] = p;
  }
}

// A block of the main launch: its page (the order's rank blockIdx.x /
// (blocks_per_page * kvh)), its run of rows in the page and its kv head.
struct Block {
  Rows r;
  Chunk ch;
  Keys k;
  int live;       // live tokens of the page
  bool all_live;  // every row of the block exists and is a live token's
};

// Fills b; false when the block holds pad rows only.
__device__ __forceinline__ bool block_of(const Args& a, int rows, Block& b) {
  const int per_page = a.blocks_per_page * a.kvh;
  const int page = a.order[blockIdx.x / per_page];
  const int rem = (int)(blockIdx.x % (unsigned)per_page);
  Rows& r = b.r;
  r.sq = a.ps;
  r.h = a.h;
  r.rep = a.h / a.kvh;
  r.total = a.ps * r.rep;
  r.row0 = (rem / a.kvh) * rows;
  r.bi = page;
  r.g = rem % a.kvh;
  b.ch = chunk_of(a, page);
  b.live = live_tokens(a, b.ch);
  const int i0 = r.row0 / r.rep, i1 = (imin(r.row0 + rows, r.total) - 1) / r.rep;
  if (i0 >= b.live) return false;
  const int i1l = imin(i1, b.live - 1);
  b.k = keys_of(a, b.ch, i0, i1l);
  r.pos_first = b.ch.pos0 + b.ch.off0 + i0;
  r.pos_last = b.ch.pos0 + b.ch.off0 + i1l;
  r.lo = b.k.lo;
  r.hi = b.k.hi;
  b.all_live = r.row0 + rows <= r.total && i1 < b.live;
  return true;
}

// Exact zeros into the block's rows that exist.
template <int D>
__device__ __forceinline__ void store_zeros(const Args& a, const Rows& r, int rows, int threads) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += threads) {
    const int row = i / kChunks, c = i % kChunks;
    if (r.row0 + row < r.total)
      *reinterpret_cast<uint4*>(a.out + r.elem<D>(row) + c * 8) = make_uint4(0, 0, 0, 0);
  }
}

// Positions of this lane's two rows (group, group + 8 of the warp's 16), -1
// for a pad row or a row that does not exist (it then sees no key).
__device__ __forceinline__ void lane_positions(const Block& b, int wrow, int (&q_pos)[2]) {
  const int group = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = b.r.row0 + wrow + group + 8 * i, tok = row / b.r.rep;
    q_pos[i] = row < b.r.total && tok < b.live ? b.ch.pos0 + b.ch.off0 + tok : -1;
  }
}

// Every row of the block sees every key of the tile [k0, k0 + kBK).
__device__ __forceinline__ bool tile_full(const Args& a, const Block& b, int k0) {
  return b.all_live && (k0 + kBK <= b.k.cap || k0 >= b.k.pos0) &&
         k0 + kBK - 1 <= b.r.pos_first && (a.window <= 0 || b.r.pos_last - k0 < a.window);
}

// Tile kb into one ring stage: bf16 K/V rows at at(key, chunk) of dk, dv (a
// context key of a bf16 pool, an own key, or zeros); with codes, a context
// key's codes into ck, cv (row j at j * D) and its scales into ks, vs, and
// scale 1 for every other key.
template <int D, bool kQuant, class At>
__device__ __forceinline__ void load_tile(const Args& a, const Block& b, int kb, bf16* dk,
                                          bf16* dv, uint8_t* ck, uint8_t* cv, float* ks,
                                          float* vs, At at, int threads) {
  constexpr int kChunks = D / 8;
  const int k0 = kb * kBK;
  const int32_t* trow = a.tables + (int64_t)b.ch.c * a.max_pages;
  // (pool row, or packed row) x kvh + g of key `key`, by its source
  auto pool_row = [&](int key) -> int64_t {
    return ((int64_t)trow[key / a.ps] * a.ps + key % a.ps) * a.kvh + b.r.g;
  };
  auto packed_row = [&](int key) -> int64_t {
    return (int64_t)(b.ch.start + key - b.k.pos0) * a.kvh + b.r.g;
  };
  auto is_ctx = [&](int key) { return key >= b.k.lo && key < b.k.cap; };
  auto is_own = [&](int key) { return key >= b.k.lo && key >= b.k.pos0 && key < b.k.hi; };
  for (int i = threadIdx.x; i < kBK * kChunks; i += threads) {
    const int j = i / kChunks, c = i % kChunks, key = k0 + j;
    const bool ctx = is_ctx(key), own = !ctx && is_own(key);
    if (kQuant && ctx) continue;  // its codes, below
    const bf16 *ksrc = a.k, *vsrc = a.v;
    int64_t row = 0;
    if (ctx) {
      ksrc = static_cast<const bf16*>(a.k_pages);
      vsrc = static_cast<const bf16*>(a.v_pages);
      row = pool_row(key);
    } else if (own) {
      row = packed_row(key);
    }
    mma::cp_async_16(dk + at(j, c), ksrc + row * D + c * 8, ctx || own);
    mma::cp_async_16(dv + at(j, c), vsrc + row * D + c * 8, ctx || own);
  }
  if constexpr (kQuant) {
    constexpr int kCodeChunks = D / 16;  // 16-byte chunks of a code row
    const uint8_t* kp = static_cast<const uint8_t*>(a.k_pages);
    const uint8_t* vp = static_cast<const uint8_t*>(a.v_pages);
    for (int i = threadIdx.x; i < kBK * kCodeChunks; i += threads) {
      const int j = i / kCodeChunks, c = i % kCodeChunks, key = k0 + j;
      if (!is_ctx(key)) continue;
      const int64_t src = pool_row(key) * D + c * 16;
      mma::cp_async_16(ck + j * D + c * 16, kp + src, true);
      mma::cp_async_16(cv + j * D + c * 16, vp + src, true);
    }
    for (int j = threadIdx.x; j < kBK; j += threads) {
      const int key = k0 + j;
      if (is_ctx(key)) {
        const int64_t src = pool_row(key);
        mma::cp_async_4(ks + j, a.k_scales + src, true);
        mma::cp_async_4(vs + j, a.v_scales + src, true);
      } else {
        ks[j] = 1.f;
        vs[j] = 1.f;
      }
    }
  }
}

// The context keys' codes of tile kb, widened to bf16 into the stage's K/V
// rows (the other rows came by cp.async).
template <int D, class At>
__device__ __forceinline__ void widen_tile(const Args& a, const Block& b, int kb, bf16* dk,
                                           bf16* dv, const uint8_t* ck, const uint8_t* cv, At at,
                                           int threads) {
  constexpr int kChunks = D / 8;
  const bool fp8 = a.store == kKVFp8;
  for (int i = threadIdx.x; i < kBK * kChunks; i += threads) {
    const int j = i / kChunks, c = i % kChunks, key = kb * kBK + j;
    if (key < b.k.lo || key >= b.k.cap) continue;
    *reinterpret_cast<uint4*>(dk + at(j, c)) =
        tile::widen(*reinterpret_cast<const uint2*>(ck + j * D + c * 8), fp8);
    *reinterpret_cast<uint4*>(dv + at(j, c)) =
        tile::widen(*reinterpret_cast<const uint2*>(cv + j * D + c * 8), fp8);
  }
}

// Shared memory of a block: the Q tile (rows of d, or d + 8 on mma.sync),
// then per ring stage a bf16 K and V tile, and with codes a K and V code
// tile and their scales; wgmma's swizzle blocks take 1 KB more to align.
__host__ __device__ constexpr size_t smem_bytes(int d, int rows, int stages, bool wgmma,
                                                bool quant) {
  const size_t row = wgmma ? d : d + 8;
  return sizeof(bf16) * ((size_t)rows * row + (size_t)stages * 2 * kBK * row) +
         (quant ? (size_t)stages * 2 * kBK * (d + sizeof(float)) : 0) + (wgmma ? 1024 : 0);
}

// ---------------------------------------------------------------------------
// d 128: two warpgroups of 64 rows on wgmma
// ---------------------------------------------------------------------------
constexpr int kWgRows = 128;
constexpr int kWgThreads = 256;

template <int ST, bool kQuant>
__global__ void __launch_bounds__(kWgThreads) varlen_prefill_kernel_wgmma(const Args a) {
  using namespace rt::mma;
  using namespace rt::tile;
  constexpr int D = 128, BK = kBK, kRows = kWgRows, kThreads = kWgThreads;
  static_assert(ST >= 2, "a ring of at least two K/V tiles");

  extern __shared__ unsigned char smem_raw[];
  // the swizzle blocks sit on 1024-byte boundaries (the launch adds 1 KB)
  const uint32_t base = smem_addr(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + (((base + 1023u) & ~1023u) - base));
  bf16* sK = sQ + kRows * D;  // ST x BK x D
  bf16* sV = sK + ST * BK * D;
  uint8_t* cK = reinterpret_cast<uint8_t*>(sV + ST * BK * D);  // codes: ST x BK x D
  uint8_t* cV = cK + ST * BK * D;
  float* sKs = reinterpret_cast<float*>(cV + ST * BK * D);      // scales: ST x BK
  float* sVs = sKs + ST * BK;

  Block b;
  if (!block_of(a, kRows, b)) {
    store_zeros<D>(a, b.r, kRows, kThreads);
    return;
  }
  const Rows& r = b.r;
  auto at_q = [](int row, int c) { return sw128<kRows>(row, c); };
  auto at_kv = [](int row, int c) { return sw128<BK>(row, c); };
  copy_q<D>(sQ, at_q, a.q, r, kRows, kThreads);
  cp_async_commit();
  const int n = b.k.n;
  auto load = [&](int t, int st) {
    load_tile<D, kQuant>(a, b, tile_kb(b.k, t), sK + st * BK * D, sV + st * BK * D,
                         cK + st * BK * D, cV + st * BK * D, sKs + st * BK, sVs + st * BK, at_kv,
                         kThreads);
  };
  // the ring: the block's tile t in stage t % ST, ST - 1 tiles in flight
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < n) load(t, t);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int wrow = warp * 16;  // this warp's rows; its warpgroup's start at 64 * (warp / 4)
  int q_pos[2];
  lane_positions(b, wrow, q_pos);
  auto live = [&](int key, int i) {
    const int qp = q_pos[i];
    return (key < b.k.cap || key >= b.k.pos0) && key <= qp &&
           (a.window <= 0 || qp - key < a.window);
  };
  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n; ++t) {
    const int kb = tile_kb(b.k, t), st = t % ST;
    cp_async_wait<ST - 2>();  // tile t (and Q) have landed
    fence_async_smem();       // ... for wgmma's reads too
    // one barrier a tile: the tile is visible to every warp, and every warp
    // is done with the stage the next copy refills (read last tile)
    __syncthreads();
    if (t + ST - 1 < n) load(t + ST - 1, (t + ST - 1) % ST);
    cp_async_commit();
    bf16* tk = sK + st * BK * D;
    bf16* tv = sV + st * BK * D;
    if constexpr (kQuant) {
      widen_tile<D>(a, b, kb, tk, tv, cK + st * BK * D, cV + st * BK * D, at_kv, kThreads);
      fence_async_smem();
      __syncthreads();
    }
    float s[BK / 8][4];
    wgmma_scores<kRows, BK>(s, sQ, tk, warp);
    if constexpr (kQuant) scale_keys<BK>(s, sKs + st * BK);
    float alpha[2];
    softmax_step<BK>(s, m, l, alpha, tile_full(a, b, kb * BK), kb * BK, live, a.scale,
                     a.softcap);
    // v_scale folds into P's column (after the row sum, which it is not part of)
    if constexpr (kQuant) scale_keys<BK>(s, sVs + st * BK);
    rescale(o, alpha);
    wgmma_pv<BK>(o, s, tv);
  }
  cp_async_wait<0>();
  __syncthreads();  // every wgmma of the block is done with sQ
  store_rows<D>(sQ, at_q, o, l, wrow, r, a.out);
}

// ---------------------------------------------------------------------------
// other head dims: warps of 16 rows on mma.sync m16n8k16, rows of d + 8
// ---------------------------------------------------------------------------
template <int D, int ST, bool kQuant>
__global__ void __launch_bounds__(32 * kMmaMaxWarps) varlen_prefill_kernel_mma(const Args a) {
  using namespace rt::mma;
  using namespace rt::tile;
  using Lay = Padded<D>;
  constexpr int BK = kBK, kRow = Lay::kStride;
  constexpr bool kQInRegs = D <= 128;  // 32 registers at d 128; 64 at d 256
  static_assert(D % 16 == 0, "whole m16n8k16 steps");
  static_assert(ST >= 2, "a ring of at least two K/V tiles");
  const int threads = blockDim.x, rows = a.rows;  // 16 rows a warp

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // rows x (D + 8), later O
  bf16* sK = sQ + rows * kRow;                   // ST x BK x (D + 8)
  bf16* sV = sK + ST * BK * kRow;
  uint8_t* cK = reinterpret_cast<uint8_t*>(sV + ST * BK * kRow);  // codes: ST x BK x D
  uint8_t* cV = cK + ST * BK * D;
  float* sKs = reinterpret_cast<float*>(cV + ST * BK * D);         // scales: ST x BK
  float* sVs = sKs + ST * BK;

  Block b;
  if (!block_of(a, rows, b)) {
    store_zeros<D>(a, b.r, rows, threads);
    return;
  }
  const Rows& r = b.r;
  auto at = [](int row, int c) { return Lay::at(row, c); };
  copy_q<D>(sQ, at, a.q, r, rows, threads);
  cp_async_commit();
  const int n = b.k.n;
  auto load = [&](int t, int st) {
    load_tile<D, kQuant>(a, b, tile_kb(b.k, t), sK + st * BK * kRow, sV + st * BK * kRow,
                         cK + st * BK * D, cV + st * BK * D, sKs + st * BK, sVs + st * BK, at,
                         threads);
  };
  // the ring: the block's tile t in stage t % ST, ST - 1 tiles in flight
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < n) load(t, t);
    cp_async_commit();
  }

  const int wrow = (threadIdx.x >> 5) * 16;
  int q_pos[2];
  lane_positions(b, wrow, q_pos);
  auto live = [&](int key, int i) {
    const int qp = q_pos[i];
    return (key < b.k.cap || key >= b.k.pos0) && key <= qp &&
           (a.window <= 0 || qp - key < a.window);
  };
  uint32_t qf[kQInRegs ? D / 16 : 1][4];
  cp_async_wait<ST - 1>();  // Q has landed
  __syncthreads();
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) q_frag<Lay>(qf[kk], sQ, wrow, kk);
  }
  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n; ++t) {
    const int kb = tile_kb(b.k, t), st = t % ST;
    cp_async_wait<ST - 2>();  // tile t has landed
    // one barrier a tile: the tile is visible to every warp, and every warp
    // is done with the stage the next copy refills (read last tile)
    __syncthreads();
    if (t + ST - 1 < n) load(t + ST - 1, (t + ST - 1) % ST);
    cp_async_commit();
    bf16* tk = sK + st * BK * kRow;
    bf16* tv = sV + st * BK * kRow;
    if constexpr (kQuant) {
      widen_tile<D>(a, b, kb, tk, tv, cK + st * BK * D, cV + st * BK * D, at, threads);
      __syncthreads();
    }
    float s[BK / 8][4];
    mma_scores<D, BK, Lay, kQInRegs>(s, qf, sQ, tk, wrow);
    if constexpr (kQuant) scale_keys<BK>(s, sKs + st * BK);
    float alpha[2];
    softmax_step<BK>(s, m, l, alpha, tile_full(a, b, kb * BK), kb * BK, live, a.scale,
                     a.softcap);
    // v_scale folds into P's column (after the row sum, which it is not part of)
    if constexpr (kQuant) scale_keys<BK>(s, sVs + st * BK);
    rescale(o, alpha);
    mma_pv<D, BK, Lay>(o, s, tv);
  }
  cp_async_wait<0>();
  // each warp reads only its own rows of sQ, so it may overwrite them with O
  store_rows<D>(sQ, at, o, l, wrow, r, a.out);
}

// The order launch, then the main one (kernel, threads a block, shared memory).
template <class Kernel>
int launch(const Args& a, Kernel kernel, int threads, size_t smem, cudaStream_t st) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int P = a.T / a.ps;
  const int64_t blocks = (int64_t)P * a.blocks_per_page * a.kvh;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int order_threads = imin(kOrderThreads, (P + 31) / 32 * 32);
  varlen_prefill_kernel_order<<<1, order_threads, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The C entry of one pool kind: argument checks, then the head dim's
// instance.  The (d, block_k, stages) tuples built are the RT_VARLEN lines
// (kernels/varlen_prefill.py BF16_TILES); d 128 runs on wgmma.
template <bool kQuant>
int entry(const void* q, const void* k, const void* v, const void* k_pages, const void* v_pages,
          const void* k_scales, const void* v_scales, const void* cu, const void* chunk_lens,
          const void* chunk_pos0, const void* page_tables, void* scratch, void* out, int T,
          int C, int h, int kvh, int d, int ps, int max_pages, int ctx_bound, int window,
          int block_k, int tile_rows, int stages, int kv_store, float scale, float softcap,
          void* stream) {
  if (T <= 0 || C <= 0 || ps <= 0 || T % ps || kvh <= 0 || h % kvh || max_pages <= 0 ||
      ctx_bound < 0 || ctx_bound > max_pages || block_k != kBK || tile_rows <= 0 ||
      (kv_store != kKVSame) != kQuant || !kv_args_ok(kv_store, k_scales, v_scales))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scales = (const float*)k_scales;
  a.v_scales = (const float*)v_scales;
  a.cu = (const int32_t*)cu;
  a.lens = (const int32_t*)chunk_lens;
  a.pos0s = (const int32_t*)chunk_pos0;
  a.tables = (const int32_t*)page_tables;
  a.weight = (int32_t*)scratch;
  a.order = a.weight + T / ps;
  a.out = (bf16*)out;
  a.T = T;
  a.C = C;
  a.h = h;
  a.kvh = kvh;
  a.ps = ps;
  a.max_pages = max_pages;
  a.ctx_bound = ctx_bound;
  a.window = window;
  a.rows = tile_rows;
  a.blocks_per_page = (ps * (h / kvh) + tile_rows - 1) / tile_rows;
  a.store = kv_store;
  a.scale = scale;
  a.softcap = softcap;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 128) {
    if (tile_rows != kWgRows || stages != 3) return (int)cudaErrorInvalidValue;
    return launch(a, varlen_prefill_kernel_wgmma<3, kQuant>, kWgThreads,
                  smem_bytes(128, kWgRows, 3, true, kQuant), st);
  }
  if (tile_rows % 16 || tile_rows > 16 * kMmaMaxWarps) return (int)cudaErrorInvalidValue;
#define RT_VARLEN(D, BK, ST)                                                               \
  if (d == D) {                                                                            \
    static_assert(BK == kBK, "the plan");                                                  \
    if (stages != ST) return (int)cudaErrorInvalidValue;                                   \
    return launch(a, varlen_prefill_kernel_mma<D, ST, kQuant>, 2 * tile_rows,              \
                  smem_bytes(D, tile_rows, ST, false, kQuant), st);                        \
  }
  RT_VARLEN(16, 32, 3)
  RT_VARLEN(32, 32, 3)
  RT_VARLEN(48, 32, 3)
  RT_VARLEN(64, 32, 3)
  RT_VARLEN(80, 32, 3)
  RT_VARLEN(96, 32, 3)
  RT_VARLEN(112, 32, 3)
  RT_VARLEN(144, 32, 2)
  RT_VARLEN(160, 32, 2)
  RT_VARLEN(176, 32, 2)
  RT_VARLEN(192, 32, 2)
  RT_VARLEN(208, 32, 2)
  RT_VARLEN(224, 32, 2)
  RT_VARLEN(240, 32, 2)
  RT_VARLEN(256, 32, 2)
#undef RT_VARLEN
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace varlen
}  // namespace rt
