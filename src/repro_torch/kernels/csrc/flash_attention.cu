// Forward flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention.
// q (b, sq, h, d) attends k, v (b, sk, kvh, d); query head h reads kv head
// h / (h/kvh).  Query row i sits at absolute position q_offset + i; key j
// is live for it when j < sk, (causal) q_pos >= j and (window > 0)
// q_pos - j < window.  A row with no live key comes out exactly zero.
//
// Bound on this card: operations.  A block of R query rows does 4 * R * d
// flops per key row it reads; at the prefill shapes of the dense engines
// (sq 1024, 16 query heads per kv head) that is far above the H100's ~295
// operations per byte.
//
// Three kernels, chosen by the wrapper from dtype and head dim (a
// dispatch, not a fallback):
//
// bf16 on the tensor cores.  The rows of one kv head are numbered
// position * rep + head-in-group (rep = h/kvh); a block owns a fixed run of
// them, so it holds rows/rep positions x the whole GQA group (at glm4-9b's
// rep 16 and 128 rows: 8 positions) and each K/V tile it reads serves all
// of them; a group wider than the block spans several blocks.  Blocks start
// with the row tiles of the most causal work.  A block visits only the K/V
// tiles that can hold a live key for one of its rows, K/V tiles of BK keys
// fill a ring of ST stages in swizzled shared memory by 16-byte cp.async
// copies (ST - 1 tiles in flight while one is multiplied), and keys past
// the block's last live one are zero-filled, never read.  Each warp owns
// 16 rows, and the online softmax works on their S fragment in registers:
// scores to log2 units (scale, or softcap), the mask only on tiles not live
// for every row of the block (the diagonal, the window edge, the end of the
// keys), the row max and sum over the four lanes of a quad, and P as the A
// operand of P V straight from registers.  Each p goes in as two bf16 terms
// (mma.cuh split_bf16): one bf16 p moves a row whose terms nearly cancel by
// 2^-9 of its largest term, two carry it to ~2^-17, at twice the P V
// products.  Statistics and accumulators are float32; O / max(l, 1e-37)
// goes to bf16 through shared memory in 16-byte stores, rows past sq never.
// Tile boundaries sit at fixed multiples of BK from key 0 and of the block's
// rows from row 0, and a tile with no live key of a row leaves that row's
// max, sum and accumulator exactly as they were: a row's output depends only
// on its query and its live keys, never on sq, padding or the rows it
// shares a block with.
//   - flash_attention_kernel_bf16_wgmma, d 128 (the models' head dim): two
//     warpgroups of 64 rows; S = Q K^T by wgmma from shared memory, O += P V
//     by wgmma with P from registers, operands in 128-byte-swizzled blocks.
//   - flash_attention_kernel_bf16, d 16, 64 and 256: four warps of 16 rows
//     on mma.sync m16n8k16; Q fragments held in registers (re-read per tile
//     at d 256, where registers run out), K and V fragments by ldmatrix.
//
// float32, flash_attention_kernel: the fp32 CUDA-core tile of common.cuh
// (the tensor cores have no full-precision float32 product, and the float32
// checks hold the card's tokens equal to the CPU's).  One 256-thread block
// per (batch row, tile of bq query positions, kv head) holds R = bq * rep
// rows, row r being position q0 + r / rep of head g * rep + r % rep, over
// the same key range as above in steps of bk keys.  Query rows past sq (the
// ragged last tile) load row sq - 1 and are never stored.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {  // 2^x; -huge gives +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Pieces of both bf16 kernels
// ---------------------------------------------------------------------------
// The query rows of a block and the keys they can see.  The block owns rows
// [row0, row0 + ROWS) of kv head g of batch row bi; rows past `total` do not
// exist and load the last one.
struct Rows {
  int sq, h, rep, total, row0, bi, g;
  int pos_first, pos_last;  // positions of its first and last existing rows
  int lo, hi;               // the live keys of those rows: [lo, hi)

  // first element of tile row `row` in q and out
  template <int D>
  __device__ __forceinline__ int64_t elem(int row) const {
    const int r = rt::imin(row0 + row, total - 1);
    return (((int64_t)bi * sq + r / rep) * h + g * rep + r % rep) * D;
  }
};

template <int ROWS>
__device__ __forceinline__ Rows block_rows(int b, int sq, int sk, int h, int kvh, int causal,
                                           int window, int q_offset) {
  Rows r;
  r.sq = sq;
  r.h = h;
  r.rep = h / kvh;
  r.total = sq * r.rep;
  const int n_tiles = (r.total + ROWS - 1) / ROWS;
  const int bg = (int)(blockIdx.x % (unsigned)(b * kvh));
  // heaviest causal tiles first: blockIdx.x walks row tiles from the last
  const int tile = n_tiles - 1 - (int)(blockIdx.x / (unsigned)(b * kvh));
  r.bi = bg / kvh;
  r.g = bg % kvh;
  r.row0 = tile * ROWS;
  r.pos_first = q_offset + r.row0 / r.rep;
  r.pos_last = q_offset + (rt::imin(r.row0 + ROWS, r.total) - 1) / r.rep;
  r.hi = causal ? rt::imin(sk, r.pos_last + 1) : sk;
  r.lo = window > 0 ? rt::imax(r.pos_first - window + 1, 0) : 0;
  return r;
}

// The block's ROWS query rows into a tile laid out by at(row, chunk), by
// THREADS threads in 16-byte copies.
template <int D, int ROWS, int THREADS, class At>
__device__ __forceinline__ void copy_q(bf16* dst, At at, const bf16* __restrict__ q,
                                       const Rows& r) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int row = i / kChunks, c = i % kChunks;
    rt::mma::cp_async_16(dst + at(row, c), q + r.elem<D>(row) + c * 8, true);
  }
}

// Keys [key0, key0 + N) of k and v (row `key` at base + key * stride) into
// tiles laid out by at(row, chunk); keys from `hi` on are zero-filled.  Each
// thread copies one chunk column of every THREADS / (D/8)-th key.
template <int D, int N, int THREADS, class At>
__device__ __forceinline__ void copy_kv(bf16* dk, bf16* dv, At at, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v, int64_t base,
                                        int64_t stride, int key0, int hi) {
  constexpr int kChunks = D / 8;
  static_assert(THREADS % kChunks == 0, "whole rows per copy pass");
  const int c = threadIdx.x % kChunks;
#pragma unroll
  for (int j = threadIdx.x / kChunks; j < N; j += THREADS / kChunks) {
    const int key = key0 + j;
    const bool ok = key < hi;
    const int64_t src = base + (ok ? key : 0) * stride + c * 8;
    rt::mma::cp_async_16(dk + at(j, c), k + src, ok);
    rt::mma::cp_async_16(dv + at(j, c), v + src, ok);
  }
}

// One online-softmax step on a warp's S fragment over keys [k0, k0 + BK):
// scores to log2 units, the mask unless every row of the block sees every
// key of the tile, the running max m, the numerators p in place of the
// scores, this lane's share of the row sums l and the factor alpha that
// rescales the accumulator.  A row with no live key in the tile keeps m and
// l exactly (alpha 1, every p 0).  q_pos: positions of this lane's rows.
template <int BK>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 8][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Rows& r, int k0,
                                             const int (&q_pos)[2], int causal, int window,
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
  const bool full = k0 + BK <= r.hi && (!causal || k0 + BK - 1 <= r.pos_first) &&
                    (window <= 0 || r.pos_last - k0 < window);
  if (!full) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * quad_t + (e & 1);
        const int qp = q_pos[e >> 1];
        const bool live =
            key < r.hi && (!causal || qp >= key) && (window <= 0 || qp - key < window);
        s[n][e] = live ? s[n][e] : rt::kNegInf;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = rt::kNegInf;
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
      const float p = (!full && x == rt::kNegInf) ? 0.f : exp2_approx(x - m[e >> 1]);
      s[n][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
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
  using rt::mma::split_bf16;
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
    const float inv = 1.f / fmaxf(li, rt::kMinL);
    const int row = wrow + group + 8 * i;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(stage + at(row, n) + 2 * quad_t) =
          rt::mma::pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int row = wrow + i / kChunks, c = i % kChunks;
    if (r.row0 + row < r.total)
      *reinterpret_cast<uint4*>(out + r.elem<D>(row) + c * 8) =
          *reinterpret_cast<const uint4*>(stage + at(row, c));
  }
}

// Q tile of `rows` rows, then K and V tiles per ring stage
__host__ __device__ constexpr size_t bf16_smem_bytes(int d, int bk, int rows, int stages) {
  return sizeof(bf16) * ((size_t)rows * d + (size_t)stages * 2 * bk * d);
}

// ---------------------------------------------------------------------------
// bf16, d 128: wgmma, WG warpgroups of 64 rows, operands in 128-byte-swizzled
// blocks: [64-column block][row][64], 16-byte chunk c of a row at c ^ (row % 8)
// ---------------------------------------------------------------------------
template <int ROWS>
__device__ __forceinline__ int sw128(int row, int chunk) {
  return (chunk >> 3) * ROWS * 64 + row * 64 + (((chunk & 7) ^ (row & 7)) << 3);
}

template <int BK, int ST, int WG>
__global__ void __launch_bounds__(128 * WG)
flash_attention_kernel_bf16_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, bf16* __restrict__ out, int b,
                                  int sq, int sk, int h, int kvh, int causal, int window,
                                  int q_offset, float scale, float softcap) {
  using namespace rt::mma;
  constexpr int D = 128, kRows = 64 * WG, kThreads = 128 * WG;
  static_assert(BK == 32, "S is one m64n32 wgmma (mma.cuh wgmma_ss)");
  static_assert(ST >= 2, "a ring of at least two K/V tiles");

  extern __shared__ unsigned char smem_raw[];
  // the swizzle blocks sit on 1024-byte boundaries (the launch adds 1 KB)
  const uint32_t base = smem_addr(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + (((base + 1023u) & ~1023u) - base));
  bf16* sK = sQ + kRows * D;  // ST x BK x D
  bf16* sV = sK + ST * BK * D;

  const Rows r = block_rows<kRows>(b, sq, sk, h, kvh, causal, window, q_offset);
  auto at_q = [](int row, int c) { return sw128<kRows>(row, c); };
  auto at_kv = [](int row, int c) { return sw128<BK>(row, c); };
  copy_q<D, kRows, kThreads>(sQ, at_q, q, r);
  cp_async_commit();
  const int kb_lo = r.lo / BK, kb_hi = r.hi > r.lo ? (r.hi + BK - 1) / BK : kb_lo;
  const int64_t stride = (int64_t)kvh * D, kv_base = (int64_t)r.bi * sk * stride + (int64_t)r.g * D;
  auto load = [&](int kb, int stage) {
    copy_kv<D, BK, kThreads>(sK + stage * BK * D, sV + stage * BK * D, at_kv, k, v, kv_base,
                             stride, kb * BK, r.hi);
  };
  // the ring: tile kb_lo + t in stage t % ST, ST - 1 tiles in flight
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (kb_lo + t < kb_hi) load(kb_lo + t, t);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, group = (threadIdx.x & 31) >> 2;
  const int wrow = warp * 16;  // this warp's rows; its warpgroup's start at 64 * (warp / 4)
  int q_pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) q_pos[i] = q_offset + (r.row0 + wrow + group + 8 * i) / r.rep;
  float o[D / 8][4] = {};
  float(&oacc)[D / 2] = *reinterpret_cast<float(*)[D / 2]>(&o[0][0]);
  float m[2] = {rt::kNegInf, rt::kNegInf}, l[2] = {0.f, 0.f};

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int t = kb - kb_lo;
    cp_async_wait<ST - 2>();  // tile kb (and Q) have landed
    fence_async_smem();       // ... for wgmma's reads too
    // one barrier a tile: the tile is visible to every warp, and every warp
    // is done with the stage the next copy refills (read last tile)
    __syncthreads();
    if (kb + ST - 1 < kb_hi) load(kb + ST - 1, (t + ST - 1) % ST);
    cp_async_commit();
    const bf16* tk = sK + (t % ST) * BK * D;
    const bf16* tv = sV + (t % ST) * BK * D;

    // S = Q K^T: D/16 k16 steps along the two 64-column blocks
    float s[BK / 8][4];
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

    float alpha[2];
    softmax_step<BK>(s, m, l, alpha, r, kb * BK, q_pos, causal, window, scale, softcap);
    rescale(o, alpha);

    // O += P V: per 16 keys, the two bf16 terms of P against V read transposed
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
  cp_async_wait<0>();
  __syncthreads();  // every wgmma of the block is done with sQ
  store_rows<D>(sQ, at_q, o, l, wrow, r, out);
}

// ---------------------------------------------------------------------------
// bf16, other head dims: mma.sync, four warps of 16 rows, tiles of rows of D
// in mma.cuh's Swizzle<D> layout
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;

template <int D, int BK, int ST>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out, int b, int sq,
                            int sk, int h, int kvh, int causal, int window, int q_offset,
                            float scale, float softcap) {
  using namespace rt::mma;
  using Sw = Swizzle<D>;
  constexpr int kRows = 16 * kMmaWarps;
  constexpr bool kQInRegs = D <= 128;  // 32 registers at d 128; 64 at d 256
  static_assert(BK % 16 == 0 && D % 16 == 0, "whole m16n8k16 steps");
  static_assert(ST >= 2, "a ring of at least two K/V tiles");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kRows x D, later O
  bf16* sK = sQ + kRows * D;                     // ST x BK x D
  bf16* sV = sK + ST * BK * D;

  const Rows r = block_rows<kRows>(b, sq, sk, h, kvh, causal, window, q_offset);
  auto at = [](int row, int c) { return Sw::at(row, c); };
  copy_q<D, kRows, kMmaThreads>(sQ, at, q, r);
  cp_async_commit();
  const int kb_lo = r.lo / BK, kb_hi = r.hi > r.lo ? (r.hi + BK - 1) / BK : kb_lo;
  const int64_t stride = (int64_t)kvh * D, kv_base = (int64_t)r.bi * sk * stride + (int64_t)r.g * D;
  auto load = [&](int kb, int stage) {
    copy_kv<D, BK, kMmaThreads>(sK + stage * BK * D, sV + stage * BK * D, at, k, v, kv_base,
                                stride, kb * BK, r.hi);
  };
  // the ring: tile kb_lo + t in stage t % ST, ST - 1 tiles in flight
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (kb_lo + t < kb_hi) load(kb_lo + t, t);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, group = lane >> 2;
  const int wrow = warp * 16;
  int q_pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) q_pos[i] = q_offset + (r.row0 + wrow + group + 8 * i) / r.rep;
  auto q_frag = [&](int kk, uint32_t (&a)[4]) {
    ldmatrix_x4(a, sQ + Sw::at(wrow + (lane & 15), 2 * kk + (lane >> 4)));
  };
  uint32_t qf[kQInRegs ? D / 16 : 1][4];
  cp_async_wait<ST - 1>();  // Q has landed
  __syncthreads();
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) q_frag(kk, qf[kk]);
  }
  float o[D / 8][4] = {};
  float m[2] = {rt::kNegInf, rt::kNegInf}, l[2] = {0.f, 0.f};

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int t = kb - kb_lo;
    cp_async_wait<ST - 2>();  // tile kb has landed
    // one barrier a tile: the tile is visible to every warp, and every warp
    // is done with the stage the next copy refills (read last tile)
    __syncthreads();
    if (kb + ST - 1 < kb_hi) load(kb + ST - 1, (t + ST - 1) % ST);
    cp_async_commit();
    const bf16* tk = sK + (t % ST) * BK * D;
    const bf16* tv = sV + (t % ST) * BK * D;

    // S = Q K^T: 16 rows x BK keys per warp
    float s[BK / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        q_frag(kk, a);
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[4];  // keys 16np..+7 and +8..+15, d chunks 2kk and 2kk+1
        ldmatrix_x4(kf, tk + Sw::at(16 * np + (lane & 7) + ((lane >> 4) << 3),
                                    2 * kk + ((lane >> 3) & 1)));
        mma_bf16(s[2 * np], a, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], a, kf[2], kf[3]);
      }
    }

    float alpha[2];
    softmax_step<BK>(s, m, l, alpha, r, kb * BK, q_pos, causal, window, scale, softcap);
    rescale(o, alpha);

    // O += P V: per 16 keys, the two bf16 terms of P against V fragments by
    // ldmatrix.trans; the small terms trail the big ones by one column pair,
    // so that two products into one accumulator never run back to back
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pb[4], ps[4];
      split_p<BK>(s, kk, pb, ps);
      uint32_t vf[2][4];  // keys 16kk..+7 / +8..+15 of d chunks 2dp and 2dp+1
#pragma unroll
      for (int dp = 0; dp <= D / 16; ++dp) {
        if (dp < D / 16) {
          ldmatrix_x4_trans(vf[dp & 1], tv + Sw::at(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
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
  cp_async_wait<0>();
  // each warp reads only its own rows of sQ, so it may overwrite them with O
  store_rows<D>(sQ, at, o, l, wrow, r, out);
}

// ---------------------------------------------------------------------------
// float32: the common.cuh tile on the CUDA cores
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(rt::kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int sq, int sk, int h,
                       int kvh, int d, int bq, int bk, int causal, int window, int q_offset,
                       float scale, float softcap) {
  extern __shared__ float smem[];
  const int rep = h / kvh, n_qt = (sq + bq - 1) / bq;
  const int b = blockIdx.x / n_qt, q0 = (blockIdx.x % n_qt) * bq, g = blockIdx.y;
  const int R = bq * rep;
  const rt::Tile t = rt::carve_tile(smem, R, bk, d);
  auto q_idx = [&](int r) { return q0 + r / rep; };
  auto q_row = [&](int r) -> int64_t {
    return (((int64_t)b * sq + rt::imin(q_idx(r), sq - 1)) * h + g * rep + r % rep) * d;
  };
  rt::tile_load_q(t, q, q_row);
  rt::tile_reset(t);
  // live keys of this block's rows: [lo, hi)
  const int pos_first = q_offset + q0;
  const int pos_last = q_offset + rt::imin(q0 + bq, sq) - 1;
  const int hi = causal ? rt::imin(sk, pos_last + 1) : sk;
  const int lo = window > 0 ? rt::imax(pos_first - window + 1, 0) : 0;
  const int64_t row_stride = (int64_t)kvh * d;
  const int64_t base = (int64_t)b * sk * row_stride + (int64_t)g * d;
  for (int kb = lo / bk; kb * bk < hi; ++kb) {
    auto key_ok = [&](int j) { return kb * bk + j < hi; };
    auto offset = [&](int j) -> int64_t { return base + (int64_t)(kb * bk + j) * row_stride; };
    __syncthreads();  // the previous step's readers are done with K/V
    rt::tile_load_kv(t, k, v, nullptr, nullptr, offset, key_ok);
    __syncthreads();
    rt::tile_step(t, scale, softcap, [&](int r, int j) {
      const int k_pos = kb * bk + j;
      const int q_pos = q_offset + q_idx(r);
      return k_pos < hi && (!causal || q_pos >= k_pos) &&
             (window <= 0 || q_pos - k_pos < window);
    });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    if (q_idx(r) < sq) out[q_row(r) + c] = t.acc[i] / fmaxf(t.l[r], rt::kMinL);
  }
}

bool shape_ok(int b, int sq, int sk, int h, int kvh, int d) {
  return b > 0 && sq > 0 && sk > 0 && kvh > 0 && h % kvh == 0 && d > 0;
}

// One bf16 launch: `rows` query rows per block, `threads` threads, `smem` bytes.
template <class Kernel>
int launch_bf16(Kernel kernel, int rows, int threads, size_t smem, const void* q, const void* k,
                const void* v, void* out, int b, int sq, int sk, int h, int kvh, int causal,
                int window, int q_offset, float scale, float softcap, cudaStream_t st) {
  const int64_t blocks = ((int64_t)sq * (h / kvh) + rows - 1) / rows * b * kvh;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t e = rt::allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, threads, smem, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                  (bf16*)out, b, sq, sk, h, kvh, causal, window,
                                                  q_offset, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (b, sq, h, d); k, v: (b, sk, kvh, d); all contiguous bf16.
// block_k keys per K/V tile, tile_rows query rows per block, stages K/V
// tiles in the ring: the (d, block_k, tile_rows, stages) tuples below are
// the ones built (kernels/flash_attention.py BF16_TILES), d 128 on wgmma.
// causal 0/1; window <= 0 means none.
extern "C" int rt_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                       int b, int sq, int sk, int h, int kvh, int d, int block_k,
                                       int tile_rows, int stages, int causal, int window,
                                       int q_offset, float scale, float softcap, void* stream) {
  if (!shape_ok(b, sq, sk, h, kvh, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_FLASH_ARGS q, k, v, out, b, sq, sk, h, kvh, causal, window, q_offset, scale, softcap, st
#define RT_FLASH_WGMMA(BK, ST, WG)                                                            \
  if (d == 128 && block_k == BK && tile_rows == 64 * WG && stages == ST)                      \
    return launch_bf16(flash_attention_kernel_bf16_wgmma<BK, ST, WG>, 64 * WG, 128 * WG,      \
                       bf16_smem_bytes(128, BK, 64 * WG, ST) + 1024, RT_FLASH_ARGS);
#define RT_FLASH_MMA(D, BK, ST)                                                               \
  if (d == D && block_k == BK && tile_rows == 16 * kMmaWarps && stages == ST)                 \
    return launch_bf16(flash_attention_kernel_bf16<D, BK, ST>, 16 * kMmaWarps, kMmaThreads,   \
                       bf16_smem_bytes(D, BK, 16 * kMmaWarps, ST), RT_FLASH_ARGS);
  RT_FLASH_WGMMA(32, 3, 2)
  RT_FLASH_MMA(16, 64, 3)
  RT_FLASH_MMA(64, 32, 3)
  RT_FLASH_MMA(256, 32, 2)
#undef RT_FLASH_MMA
#undef RT_FLASH_WGMMA
#undef RT_FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}


// The same shapes in float32.  bq query positions per block (bq * h/kvh
// tile rows), bk keys per step.
extern "C" int rt_flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                      int b, int sq, int sk, int h, int kvh, int d, int bq, int bk,
                                      int causal, int window, int q_offset, float scale,
                                      float softcap, void* stream) {
  if (!shape_ok(b, sq, sk, h, kvh, d) || bq <= 0 || bk <= 0 || kvh > 65535 ||
      (int64_t)b * ((sq + bq - 1) / bq) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int rows = bq * (h / kvh);
  const size_t smem = rt::tile_floats(rows, bk, d) * sizeof(float);
  const unsigned n_blocks = (unsigned)(b * ((sq + bq - 1) / bq));
  cudaError_t e = rt::allow_smem(flash_attention_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  flash_attention_kernel<<<dim3(n_blocks, kvh), rt::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, sq, sk, h, kvh, d, bq, bk,
      causal, window, q_offset, scale, softcap);
  return (int)cudaGetLastError();
}
