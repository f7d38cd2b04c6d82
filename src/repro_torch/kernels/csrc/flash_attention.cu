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
#include "flash_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::tile::Rows;

// ---------------------------------------------------------------------------
// Pieces of both bf16 kernels (the rest is flash_tile.cuh)
// ---------------------------------------------------------------------------
// The block's rows: blockIdx.x walks row tiles of ROWS rows from the last
// (the heaviest causal work first), kv heads and batch rows inner.
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

// Q tile of `rows` rows, then K and V tiles per ring stage
__host__ __device__ constexpr size_t bf16_smem_bytes(int d, int bk, int rows, int stages) {
  return sizeof(bf16) * ((size_t)rows * d + (size_t)stages * 2 * bk * d);
}

// The mask of a block's rows: key < hi, (causal) q_pos >= key and (window)
// q_pos - key < window; `full` when every row of the block sees every key of
// the tile [k0, k0 + BK).
template <int BK>
__device__ __forceinline__ bool tile_full(const Rows& r, int k0, int causal, int window) {
  return k0 + BK <= r.hi && (!causal || k0 + BK - 1 <= r.pos_first) &&
         (window <= 0 || r.pos_last - k0 < window);
}

// ---------------------------------------------------------------------------
// bf16, d 128: wgmma, WG warpgroups of 64 rows, operands in 128-byte-swizzled
// blocks (flash_tile.cuh sw128)
// ---------------------------------------------------------------------------
template <int BK, int ST, int WG>
__global__ void __launch_bounds__(128 * WG)
flash_attention_kernel_bf16_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, bf16* __restrict__ out, int b,
                                  int sq, int sk, int h, int kvh, int causal, int window,
                                  int q_offset, float scale, float softcap) {
  using namespace rt::mma;
  using namespace rt::tile;
  constexpr int D = 128, kRows = 64 * WG, kThreads = 128 * WG;
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
  copy_q<D>(sQ, at_q, q, r, kRows, kThreads);
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
  auto live = [&](int key, int i) {
    const int qp = q_pos[i];
    return key < r.hi && (!causal || qp >= key) && (window <= 0 || qp - key < window);
  };
  float o[D / 8][4] = {};
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
    float s[BK / 8][4];
    wgmma_scores<kRows, BK>(s, sQ, sK + (t % ST) * BK * D, warp);
    float alpha[2];
    softmax_step<BK>(s, m, l, alpha, tile_full<BK>(r, kb * BK, causal, window), kb * BK, live,
                     scale, softcap);
    rescale(o, alpha);
    wgmma_pv<BK>(o, s, sV + (t % ST) * BK * D);
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
  using namespace rt::tile;
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
  copy_q<D>(sQ, at, q, r, kRows, kMmaThreads);
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

  const int warp = threadIdx.x >> 5, group = (threadIdx.x & 31) >> 2;
  const int wrow = warp * 16;
  int q_pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) q_pos[i] = q_offset + (r.row0 + wrow + group + 8 * i) / r.rep;
  auto live = [&](int key, int i) {
    const int qp = q_pos[i];
    return key < r.hi && (!causal || qp >= key) && (window <= 0 || qp - key < window);
  };
  uint32_t qf[kQInRegs ? D / 16 : 1][4];
  cp_async_wait<ST - 1>();  // Q has landed
  __syncthreads();
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) q_frag<Sw>(qf[kk], sQ, wrow, kk);
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
    float s[BK / 8][4];
    mma_scores<D, BK, Sw, kQInRegs>(s, qf, sQ, sK + (t % ST) * BK * D, wrow);
    float alpha[2];
    softmax_step<BK>(s, m, l, alpha, tile_full<BK>(r, kb * BK, causal, window), kb * BK, live,
                     scale, softcap);
    rescale(o, alpha);
    mma_pv<D, BK, Sw>(o, s, sV + (t % ST) * BK * D);
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
