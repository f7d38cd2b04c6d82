// Flash-attention backward for Hopper (sm_90a).
//
// Replaces the backward half of the TPU flash path: repro/kernels/ops.py
// _flash_vjp / _flash_bwd_core, the custom VJP around the Pallas forward
// repro/kernels/flash_attention.py:flash_attention.  Given q (b, sq, h, d),
// k, v (b, sk, kvh, d), the forward's output o, its per-row log-sum-exp
// lse (b, h, sq) float32 in natural-log units (flash_attention.cu writes
// it) and the output's cotangent dout, it computes dq, dk and dv with the
// forward's semantics: query row i at position q_offset + i sees key j when
// j < sk, (causal) q_pos >= j and (window > 0) q_pos - j < window; scores
// s * scale, capped as softcap * tanh(s / softcap) where softcap > 0; query
// head hh reads kv head hh / (h/kvh).  Per live pair, P = exp(sc - lse),
// dP = dO . V, dS = P (dP - D) (1 - (sc/softcap)^2) scale with D = rowsum(dO
// * O); P and dS are rounded to the input dtype before their products, as
// the JAX backward rounds them; every sum is float32.  A masked pair gives
// P = dS = 0 exactly; a row with no live key (its lse the empty sentinel)
// gets dq = 0 and gives dk, dv nothing.  No atomics anywhere: the same
// inputs give the same bits on every run.
//
// Bound on this card: operations (at glm4-9b's training shape, 1024 keys and
// 16 query heads per kv head, about 10 flops per byte of K/V read per query
// row).  Two routes, chosen by the wrapper from dtype and head dim
// (kernels/flash_attention_bwd.py route; a dispatch, not a fallback):
//
// bf16 at d 16, 64, 80 and 128: the tensor cores (mma.sync m16n8k16, float32
// accumulation, csrc/mma.cuh), in the design of FlashAttention-2's backward:
//   - flash_bwd_stats_kernel: D = rowsum(dO * O) (the dot kernel's
//     arithmetic), and the 2-norms of each query row's q and dO and each
//     key's k and v, one warp each, into the float32 scratch `stats`;
//   - flash_bwd_dkdv_tc_kernel: a block owns 64 keys of one kv head, K and
//     V in swizzled bf16 tiles (Swizzle<D>, Padded<D> at d 80), and float32
//     dK and dV accumulators in registers, each of its four warps 16 keys.
//     It walks the query rows that can see one of its keys, BQ at a time,
//     through a ring of ST row tiles (Q, dO and their rows' lse, D and
//     norms) filled by cp.async.  The keys are the M dimension: S^T = K Q^T
//     and dP^T = V dO^T (their k16 steps interleaved) leave P^T and dS^T in
//     the accumulator layout, which packed to bf16 pairs is the A fragment
//     of dV += P^T dO and dK += dS^T Q (Q and dO as B operands by
//     ldmatrix.trans).  A GQA group too wide for the grid to fill the card
//     (glm4-9b: 16 query heads on each of 2 kv heads) is split: each of
//     `splits` blocks takes rep / splits of the group's heads, its rows
//     numbered position * (rep / splits) + head-in-share, and writes its
//     float32 dK, dV to a scratch (b, kvh, splits, sk, d) each;
//   - flash_bwd_sum_kernel (splits > 1 only): dK, dV as the sum of the
//     splits in split order, in bf16;
//   - flash_bwd_dq_tc_kernel: a block owns 64 query rows of one kv head,
//     numbered position * rep + head-in-group as the forward numbers them,
//     and walks the key tiles they can see (K/V and their keys' norms
//     double-buffered by cp.async), recomputing S = Q K^T and dP = dO V^T
//     (flash_tile.cuh's mma_scores) and adding dS K with K as the
//     transposed B operand, as the forward adds P V.
//   Both main kernels walk only the tiles that hold a live pair and mask
//   only the tiles not live for every pair, as the forward does.
//   P and dS are rounded to bf16 from the plain version's float32 values.
//   The tensor cores sum a score (and dP) in another order than the plain
//   version, whose float32 product sums one fma a column in column order
//   (as this file's CUDA-core route does), and a P or dS near a bf16
//   rounding midpoint then rounds the other way: a short row's dq moves by
//   one bf16 ulp of a large dS (at glm4-9b's training shape 25 elements of
//   dq fell outside chip_smoke.py's limit so).  So every pair carries a bound
//   on that difference, TIE |a| |b| on each dot product propagated through
//   exp and the products (tc_pair); a pair within its bound of a midpoint
//   goes on its lane's list, and the list is flushed when it could overflow
//   and at the end: every lane recomputes one listed pair at a time with
//   its score and dP summed in column order and the plain version's
//   operations (seq_dots, exact_pair), and the difference of the two bf16
//   roundings times the row of dO, Q (dK/dV) or K (dQ) is added to the
//   accumulators by the quad of lanes that holds them.
//
// float32, and bf16 at any other head dim (d 256: the dK and dV
// accumulators of 16 keys would need 256 registers a thread): the CUDA
// cores, the design of FlashAttention-2 split so that no two blocks write
// one output:
//   - flash_bwd_dot_kernel: D = rowsum(dO * O), one warp per query row;
//   - flash_bwd_dkdv_kernel: one block per (batch row, kv head, tile of BK
//     keys) holds its K/V tile and float32 dK/dV accumulators in shared
//     memory and walks the query rows that can see one of its keys (rows
//     numbered position * rep + head-in-group, as the forward numbers
//     them, so each tile of R rows serves the whole GQA group), R rows at a
//     time: S and dP by one dot product per (row, key) thread, P and dS into
//     shared memory, then dV += P^T dO and dK += dS^T Q by one thread per
//     (key, column);
//   - flash_bwd_dq_kernel: one block per (batch row, kv head, tile of R rows)
//     holds Q, dO and a float32 dQ accumulator and walks the key tiles its
//     rows can see, recomputing dS and adding dS K.
// Both main kernels skip the tiles with no live pair, as the forward does.
// Everything in shared memory is float32; rows of K, V, Q and dO are padded
// to d + 1 floats, so the 32 keys (or rows) one warp reads at the same column
// fall in 32 different banks.  The wrapper (kernels/flash_attention_bwd.py
// plan) picks (R, BK) by head dim so that two blocks fit an SM where they can.

#include "flash_tile.cuh"

namespace {

// the log-sum-exp of a row with no live key (ref.LSE_EMPTY = -NEG_INF)
constexpr float kLseEmpty = 2.3819763e38f;  // ref.LSE_EMPTY, 0.7 * FLT_MAX in float32

struct Shape {
  int b, sq, sk, h, kvh, d, rep, causal, window, q_offset;
  float scale, softcap;
};

// x rounded to T and back (float32 is exact)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return rt::to_f32(rt::from_f32<T>(x));
}

// first element of row `row` (position row / rep, head g * rep + row % rep)
// of kv head g in q, dout, o, dq: (b, sq, h, d)
__device__ __forceinline__ int64_t row_elem(const Shape& s, int bi, int g, int row) {
  return (((int64_t)bi * s.sq + row / s.rep) * s.h + g * s.rep + row % s.rep) * s.d;
}

// that row's entry in lse and D: (b, h, sq)
__device__ __forceinline__ int64_t row_stat(const Shape& s, int bi, int g, int row) {
  return ((int64_t)bi * s.h + g * s.rep + row % s.rep) * s.sq + row / s.rep;
}

__device__ __forceinline__ bool live(const Shape& s, int q_pos, int key) {
  return key < s.sk && (!s.causal || q_pos >= key) && (s.window <= 0 || q_pos - key < s.window);
}

__host__ __device__ inline size_t dkdv_floats(int rows, int bk, int d) {
  return 2 * (size_t)bk * (d + 1) + 2 * (size_t)rows * (d + 1) + 2 * (size_t)rows * (bk + 1) +
         2 * (size_t)rows + 2 * (size_t)bk * d;
}

__host__ __device__ inline size_t dq_floats(int rows, int bk, int d) {
  return 2 * (size_t)rows * (d + 1) + 2 * (size_t)bk * (d + 1) + (size_t)rows * (bk + 1) +
         2 * (size_t)rows + (size_t)rows * d;
}

// Keys [k0, k0 + bk) of kv head g into sK, sV (rows of d + 1); keys from sk on
// are zero.
template <typename T>
__device__ __forceinline__ void load_kv(const Shape& s, float* sK, float* sV, const T* __restrict__ k,
                                        const T* __restrict__ v, int bi, int g, int k0, int bk) {
  const int dp = s.d + 1;
  const int64_t stride = (int64_t)s.kvh * s.d, base = (int64_t)bi * s.sk * stride + (int64_t)g * s.d;
  for (int i = threadIdx.x; i < bk * s.d; i += rt::kThreads) {
    const int j = i / s.d, c = i % s.d, key = k0 + j;
    const bool ok = key < s.sk;
    const int64_t at = base + (int64_t)(ok ? key : 0) * stride + c;
    sK[j * dp + c] = ok ? rt::to_f32(k[at]) : 0.f;
    sV[j * dp + c] = ok ? rt::to_f32(v[at]) : 0.f;
  }
}

// Rows [row0, row0 + rows) of kv head g (those from row_hi on are zero, with
// an empty lse) into sQ, sdO (rows of d + 1), sL and sD.
template <typename T>
__device__ __forceinline__ void load_rows(const Shape& s, float* sQ, float* sdO, float* sL,
                                          float* sD, const T* __restrict__ q,
                                          const T* __restrict__ dout, const float* __restrict__ lse,
                                          const float* __restrict__ dsum, int bi, int g, int row0,
                                          int rows, int row_hi) {
  const int dp = s.d + 1;
  for (int i = threadIdx.x; i < rows * s.d; i += rt::kThreads) {
    const int rr = i / s.d, c = i % s.d, row = row0 + rr;
    const bool ok = row < row_hi;
    const int64_t at = row_elem(s, bi, g, ok ? row : row0) + c;
    sQ[rr * dp + c] = ok ? rt::to_f32(q[at]) : 0.f;
    sdO[rr * dp + c] = ok ? rt::to_f32(dout[at]) : 0.f;
  }
  for (int rr = threadIdx.x; rr < rows; rr += rt::kThreads) {
    const int row = row0 + rr;
    const bool ok = row < row_hi;
    sL[rr] = ok ? lse[row_stat(s, bi, g, row)] : kLseEmpty;
    sD[rr] = ok ? dsum[row_stat(s, bi, g, row)] : 0.f;
  }
}

// P (if sP) and dS of every (row, key) pair of the loaded tiles, rounded to
// T, into rows of bk + 1 floats: one pair per thread in turn, the 32 keys of a
// warp against one row.
template <typename T>
__device__ __forceinline__ void scores(const Shape& s, float* sP, float* sdS, const float* sQ,
                                       const float* sdO, const float* sK, const float* sV,
                                       const float* sL, const float* sD, int row0, int rows,
                                       int row_hi, int k0, int bk) {
  const int dp = s.d + 1;
  for (int i = threadIdx.x; i < rows * bk; i += rt::kThreads) {
    const int rr = i / bk, j = i % bk, row = row0 + rr;
    float p = 0.f, ds = 0.f;
    if (row < row_hi && live(s, s.q_offset + row / s.rep, k0 + j)) {
      const float* qr = sQ + rr * dp;
      const float* dor = sdO + rr * dp;
      const float* kj = sK + j * dp;
      const float* vj = sV + j * dp;
      float dot = 0.f, dpv = 0.f;
      for (int c = 0; c < s.d; ++c) {
        dot += qr[c] * kj[c];
        dpv += dor[c] * vj[c];
      }
      float sc = dot * s.scale, cap = 1.f;
      if (s.softcap > 0.f) {
        const float t = tanhf(sc / s.softcap);
        sc = s.softcap * t;
        cap = 1.f - t * t;
      }
      p = expf(sc - sL[rr]);
      ds = p * (dpv - sD[rr]) * cap * s.scale;
    }
    if (sP != nullptr) sP[rr * (bk + 1) + j] = round_to<T>(p);
    sdS[rr * (bk + 1) + j] = round_to<T>(ds);
  }
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
                     int64_t n_rows, int sq, int h, int d) {
  const int64_t row = (int64_t)blockIdx.x * (rt::kThreads / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += rt::to_f32(o[row * d + c]) * rt::to_f32(dout[row * d + c]);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t bi = row / ((int64_t)sq * h);
    const int pos = (int)((row / h) % sq), hh = (int)(row % h);
    dsum[(bi * h + hh) * sq + pos] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
                      Shape s, int rows, int bk) {
  extern __shared__ float smem[];
  const int dp = s.d + 1;
  float* sK = smem;
  float* sV = sK + bk * dp;
  float* sQ = sV + bk * dp;
  float* sdO = sQ + rows * dp;
  float* sP = sdO + rows * dp;
  float* sdS = sP + rows * (bk + 1);
  float* sL = sdS + rows * (bk + 1);
  float* sD = sL + rows;
  float* aK = sD + rows;
  float* aV = aK + bk * s.d;
  // key tiles outer, the first (the most causal work) first
  const int kt = blockIdx.x / (s.b * s.kvh), bg = blockIdx.x % (s.b * s.kvh);
  const int bi = bg / s.kvh, g = bg % s.kvh, k0 = kt * bk;
  load_kv(s, sK, sV, k, v, bi, g, k0, bk);
  for (int i = threadIdx.x; i < bk * s.d; i += rt::kThreads) aK[i] = aV[i] = 0.f;
  // the query indices that see a key of the tile: causal, from k0 on; windowed,
  // below k_last + window (q_pos = q_offset + i)
  const int k_last = rt::imin(k0 + bk, s.sk) - 1;
  const int i_lo = s.causal ? rt::imax(k0 - s.q_offset, 0) : 0;
  const int i_hi = s.window > 0 ? rt::imin(s.sq, rt::imax(k_last + s.window - s.q_offset, 0)) : s.sq;
  const int row_hi = i_hi * s.rep;
  for (int row0 = i_lo * s.rep; row0 < row_hi; row0 += rows) {
    __syncthreads();  // the last tile's readers are done (and K/V, accumulators set)
    load_rows(s, sQ, sdO, sL, sD, q, dout, lse, dsum, bi, g, row0, rows, row_hi);
    __syncthreads();
    scores<T>(s, sP, sdS, sQ, sdO, sK, sV, sL, sD, row0, rows, row_hi, k0, bk);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q: one (key, column) per thread in turn
    for (int i = threadIdx.x; i < bk * s.d; i += rt::kThreads) {
      const int j = i / s.d, c = i % s.d;
      float av = 0.f, ak = 0.f;
      for (int rr = 0; rr < rows; ++rr) {
        av += sP[rr * (bk + 1) + j] * sdO[rr * dp + c];
        ak += sdS[rr * (bk + 1) + j] * sQ[rr * dp + c];
      }
      aV[i] += av;
      aK[i] += ak;
    }
  }
  __syncthreads();
  const int64_t stride = (int64_t)s.kvh * s.d, base = (int64_t)bi * s.sk * stride + (int64_t)g * s.d;
  for (int i = threadIdx.x; i < bk * s.d; i += rt::kThreads) {
    const int j = i / s.d, c = i % s.d, key = k0 + j;
    if (key < s.sk) {
      dk[base + (int64_t)key * stride + c] = rt::from_f32<T>(aK[i]);
      dv[base + (int64_t)key * stride + c] = rt::from_f32<T>(aV[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq, Shape s, int rows, int bk) {
  extern __shared__ float smem[];
  const int dp = s.d + 1;
  float* sQ = smem;
  float* sdO = sQ + rows * dp;
  float* sK = sdO + rows * dp;
  float* sV = sK + bk * dp;
  float* sdS = sV + bk * dp;
  float* sL = sdS + rows * (bk + 1);
  float* sD = sL + rows;
  float* aQ = sD + rows;
  const int total = s.sq * s.rep;
  const int n_tiles = (total + rows - 1) / rows;
  // row tiles from the last (the most causal work) first
  const int tile = n_tiles - 1 - (int)(blockIdx.x / (unsigned)(s.b * s.kvh));
  const int bg = blockIdx.x % (s.b * s.kvh), bi = bg / s.kvh, g = bg % s.kvh;
  const int row0 = tile * rows, row_hi = rt::imin(row0 + rows, total);
  load_rows(s, sQ, sdO, sL, sD, q, dout, lse, dsum, bi, g, row0, rows, row_hi);
  for (int i = threadIdx.x; i < rows * s.d; i += rt::kThreads) aQ[i] = 0.f;
  // the live keys of the tile's rows: [lo, hi)
  const int pos_first = s.q_offset + row0 / s.rep, pos_last = s.q_offset + (row_hi - 1) / s.rep;
  const int hi = s.causal ? rt::imin(s.sk, pos_last + 1) : s.sk;
  const int lo = s.window > 0 ? rt::imax(pos_first - s.window + 1, 0) : 0;
  for (int k0 = (lo / bk) * bk; k0 < hi; k0 += bk) {
    __syncthreads();  // the last tile's readers are done (and the rows loaded)
    load_kv(s, sK, sV, k, v, bi, g, k0, bk);
    __syncthreads();
    scores<T>(s, nullptr, sdS, sQ, sdO, sK, sV, sL, sD, row0, rows, row_hi, k0, bk);
    __syncthreads();
    // dQ += dS K: one (row, column) per thread in turn
    for (int i = threadIdx.x; i < rows * s.d; i += rt::kThreads) {
      const int rr = i / s.d, c = i % s.d;
      float a = 0.f;
      for (int j = 0; j < bk; ++j) a += sdS[rr * (bk + 1) + j] * sK[j * dp + c];
      aQ[i] += a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * s.d; i += rt::kThreads) {
    const int rr = i / s.d, c = i % s.d;
    if (row0 + rr < row_hi) dq[row_elem(s, bi, g, row0 + rr) + c] = rt::from_f32<T>(aQ[i]);
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout, const float* lse,
           float* dsum, T* dq, T* dk, T* dv, const Shape& s, int rows, int bk, cudaStream_t st) {
  const int64_t n_rows = (int64_t)s.b * s.sq * s.h;
  const int64_t dot_blocks = (n_rows + rt::kThreads / 32 - 1) / (rt::kThreads / 32);
  const int64_t kv_blocks = (int64_t)((s.sk + bk - 1) / bk) * s.b * s.kvh;
  const int64_t q_blocks = (int64_t)(((int64_t)s.sq * s.rep + rows - 1) / rows) * s.b * s.kvh;
  if (dot_blocks > 0x7fffffff || kv_blocks > 0x7fffffff || q_blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const size_t kv_smem = dkdv_floats(rows, bk, s.d) * sizeof(float);
  const size_t q_smem = dq_floats(rows, bk, s.d) * sizeof(float);
  cudaError_t e = rt::allow_smem(flash_bwd_dkdv_kernel<T>, kv_smem);
  if (e == cudaSuccess) e = rt::allow_smem(flash_bwd_dq_kernel<T>, q_smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dot_kernel<T><<<(unsigned)dot_blocks, rt::kThreads, 0, st>>>(o, dout, dsum, n_rows,
                                                                         s.sq, s.h, s.d);
  flash_bwd_dkdv_kernel<T><<<(unsigned)kv_blocks, rt::kThreads, kv_smem, st>>>(
      q, k, v, dout, lse, dsum, dk, dv, s, rows, bk);
  flash_bwd_dq_kernel<T><<<(unsigned)q_blocks, rt::kThreads, q_smem, st>>>(q, k, v, dout, lse,
                                                                          dsum, dq, s, rows, bk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using rt::tile::kLog2e;
constexpr int kTcThreads = 128;  // four warps
constexpr int kTcKeys = 64;      // keys a dK/dV block, 16 a warp
constexpr int kTcRows = 64;      // query rows a dQ block, 16 a warp

struct TcShape {
  int b, sq, sk, h, kvh, rep, splits, causal, window, q_offset;
  float scale, softcap;
  // bound on a tensor-core dot product's distance from the column-order
  // float32 sum, per unit of |a| |b| (kernels/flash_attention_bwd.py TIE)
  float tie;
};

// The float32 statistics of the scratch `stats` (the wrapper's
// tc_stats_floats): D, |q| and |dO| of each query row, (b, h, sq) each, then
// |k| and |v| of each key, (b, kvh, sk) each.
struct Stats {
  float *d, *nq, *ndo, *nk, *nv;
  __host__ __device__ Stats(float* p, const TcShape& s) {
    const int64_t rows = (int64_t)s.b * s.h * s.sq, keys = (int64_t)s.b * s.kvh * s.sk;
    d = p;
    nq = p + rows;
    ndo = p + 2 * rows;
    nk = p + 3 * rows;
    nv = nk + keys;
  }
};

__device__ __forceinline__ bool tc_live(const TcShape& s, int q_pos, int key) {
  return key < s.sk && (!s.causal || q_pos >= key) && (s.window <= 0 || q_pos - key < s.window);
}

// D = rowsum(dO * O) of each query row (flash_bwd_dot_kernel's arithmetic)
// and the 2-norms of its q and dO; then the 2-norms of each key's k and v.
// One warp a query row, then one a key.
__global__ void __launch_bounds__(rt::kThreads)
flash_bwd_stats_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout, float* __restrict__ stats, TcShape s,
                       int d) {
  const int64_t rows = (int64_t)s.b * s.sq * s.h, keys = (int64_t)s.b * s.sk * s.kvh;
  const int64_t w = (int64_t)blockIdx.x * (rt::kThreads / 32) + threadIdx.x / 32;
  if (w >= rows + keys) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f, x = 0.f, y = 0.f;
  if (w < rows) {
    for (int c = lane; c < d; c += 32) {
      const float oc = rt::to_f32(o[w * d + c]), gc = rt::to_f32(dout[w * d + c]);
      const float qc = rt::to_f32(q[w * d + c]);
      acc += oc * gc;
      x += qc * qc;
      y += gc * gc;
    }
  } else {
    const int64_t at = (w - rows) * d;
    for (int c = lane; c < d; c += 32) {
      const float kc = rt::to_f32(k[at + c]), vc = rt::to_f32(v[at + c]);
      x += kc * kc;
      y += vc * vc;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
    x += __shfl_xor_sync(0xffffffffu, x, off);
    y += __shfl_xor_sync(0xffffffffu, y, off);
  }
  if (lane != 0) return;
  const Stats st(stats, s);
  if (w < rows) {
    const int64_t bi = w / ((int64_t)s.sq * s.h);
    const int pos = (int)((w / s.h) % s.sq), hh = (int)(w % s.h);
    const int64_t at = (bi * s.h + hh) * s.sq + pos;
    st.d[at] = acc;
    st.nq[at] = sqrtf(x);
    st.ndo[at] = sqrtf(y);
  } else {
    const int64_t key = w - rows, bi = key / ((int64_t)s.sk * s.kvh);
    const int j = (int)((key / s.kvh) % s.sk), g = (int)(key % s.kvh);
    const int64_t at = (bi * s.kvh + g) * s.sk + j;
    st.nk[at] = sqrtf(x);
    st.nv[at] = sqrtf(y);
  }
}

// Whether x may round to another bf16 (round to nearest) than a value
// within err of it: x lies within err of the midpoint of two bf16 values.
__device__ __forceinline__ bool near_tie(float x, float err) {
  // the midpoint: x's sign, exponent and bf16 bits, then a half bf16 ulp
  return fabsf(x - __uint_as_float((__float_as_uint(x) & 0xFFFF0000u) | 0x8000u)) < err;
}

// x rounded to bf16 (to nearest, ties to even), as a float
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the two bf16 at p (4-byte aligned) as floats
__device__ __forceinline__ float2 bf16_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// a1 . b1 and a2 . b2 over D columns, a1 and a2 rows in device memory
// (16-byte aligned), b1 and b2 row rb of tiles laid out by Lay, each one
// float32 fma a column in column order: the plain version's sums (and the
// CUDA-core route's); the two chains run side by side.
template <int D, class Lay>
__device__ __forceinline__ float2 seq_dots(const bf16* a1, const bf16* a2, const bf16* b1,
                                           const bf16* b2, int rb) {
  float s = 0.f, p = 0.f;
#pragma unroll 2
  for (int c = 0; c < D / 8; ++c) {
    const uint4 a = *reinterpret_cast<const uint4*>(a1 + 8 * c);
    const uint4 x = *reinterpret_cast<const uint4*>(a2 + 8 * c);
    const uint4 b = *reinterpret_cast<const uint4*>(b1 + Lay::at(rb, c));
    const uint4 y = *reinterpret_cast<const uint4*>(b2 + Lay::at(rb, c));
    const uint32_t as[4] = {a.x, a.y, a.z, a.w}, bs[4] = {b.x, b.y, b.z, b.w};
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 af = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&as[i]));
      const float2 bf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bs[i]));
      const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
      const float2 yf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
      s = fmaf(af.x, bf.x, s);
      p = fmaf(xf.x, yf.x, p);
      s = fmaf(af.y, bf.y, s);
      p = fmaf(xf.y, yf.y, p);
    }
  }
  return make_float2(s, p);
}

// p and ds of a live pair from the score q.k and dP = dO.v summed in column
// order, with the plain version's operations in its order and rounding
// (no contraction into fma).
__device__ __forceinline__ void exact_pair(float dot, float dpv, float lse, float dsum,
                                           const TcShape& s, float& p, float& ds) {
  float sc = __fmul_rn(dot, s.scale), cap = 1.f;
  if (s.softcap > 0.f) {
    sc = __fmul_rn(s.softcap, tanhf(__fdiv_rn(sc, s.softcap)));
    const float r = __fdiv_rn(sc, s.softcap);
    cap = __fsub_rn(1.f, __fmul_rn(r, r));
  }
  p = expf(__fsub_rn(sc, lse));
  ds = __fmul_rn(__fmul_rn(__fmul_rn(p, __fsub_rn(dpv, dsum)), cap), s.scale);
}

// p and ds of a live pair, in place of its tensor-core score q.k and dP =
// dO.v, from the row's log-sum-exp and D (exp by ex2).  Returns whether the
// bf16 rounding of ds, or of p where round_p, could differ from that of the
// plain version's float32 value: the tensor cores sum the score and dP in
// another order than the plain version's column order, es and ed bound that
// difference in the scaled score and dP, and a value within the propagated
// bound of a bf16 rounding midpoint is recomputed by exact_pair.
__device__ __forceinline__ bool tc_pair(float& score, float& dp, float lse, float dsum, float es,
                                        float ed, bool round_p, const TcShape& s) {
  float sc = score * s.scale, x, p, ds, rel, eds;
  // p's relative error: the score's, the rounding of x * log2(e) and ex2's
  if (s.softcap > 0.f) {
    const float t = tanhf(sc / s.softcap), cap = 1.f - t * t;
    x = s.softcap * t - lse;
    p = rt::tile::exp2_approx(x * kLog2e);
    const float g = p * (dp - dsum);
    ds = g * cap * s.scale;
    rel = fmaf(fabsf(x), 1.2e-7f, es + 4.8e-7f);
    const float ecap = 2.f * fabsf(t) * es / s.softcap;  // the cap factor's error
    eds = fmaf(fabsf(ds), rel, fmaf(p * cap, ed, fabsf(g) * ecap * s.scale));
  } else {
    x = sc - lse;
    p = rt::tile::exp2_approx(x * kLog2e);
    ds = p * (dp - dsum) * s.scale;
    rel = fmaf(fabsf(x), 1.2e-7f, es + 4.8e-7f);
    eds = fmaf(fabsf(ds), rel, p * ed);
  }
  score = p;
  dp = ds;
  return near_tie(ds, eds) || (round_p && near_tie(p, p * rel));
}

// S = A B^T and T = C E^T side by side for this warp's 16 rows of A and C
// (wrow..wrow+15 of sa, sc) against the N rows of B and E (tb, te), all laid
// out by Lay: flash_tile.cuh's mma_scores twice, the k16 steps of the two
// interleaved so that 2 N / 8 accumulator chains are in flight.
template <int D, int N, class Lay>
__device__ __forceinline__ void mma_scores_pair(float (&s)[N / 8][4], float (&t)[N / 8][4],
                                                const bf16* sa, const bf16* sc, const bf16* tb,
                                                const bf16* te, int wrow) {
  using namespace rt::mma;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = t[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], c[4];
    rt::tile::q_frag<Lay>(a, sa, wrow, kk);
    rt::tile::q_frag<Lay>(c, sc, wrow, kk);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4], ef[4];  // rows 16np..+7 and +8..+15, d chunks 2kk and 2kk+1
      const int at = Lay::at(16 * np + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1));
      ldmatrix_x4(bf, tb + at);
      ldmatrix_x4(ef, te + at);
      mma_bf16(s[2 * np], a, bf[0], bf[1]);
      mma_bf16(t[2 * np], c, ef[0], ef[1]);
      mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
      mma_bf16(t[2 * np + 1], c, ef[2], ef[3]);
    }
  }
}

// acc (this warp's 16 x D) += A B over N: A the warp's 16 x N operand in the
// accumulator layout (a[N/8][4], rounded to bf16 pairs here: mma.cuh's note),
// B an N x D tile laid out by Lay, its rows the product's K dimension, read
// transposed by ldmatrix.trans.
template <int D, int N, class Lay>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 8][4], const float (&a)[N / 8][4],
                                        const bf16* tb) {
  using namespace rt::mma;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t af[4] = {pack_bf16(a[2 * kk][0], a[2 * kk][1]),
                            pack_bf16(a[2 * kk][2], a[2 * kk][3]),
                            pack_bf16(a[2 * kk + 1][0], a[2 * kk + 1][1]),
                            pack_bf16(a[2 * kk + 1][2], a[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];  // rows 16kk..+7 / +8..+15 of d chunks 2dp and 2dp+1
      ldmatrix_x4_trans(bf, tb + Lay::at(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                         2 * dp + (lane >> 4)));
      mma_bf16(acc[2 * dp], af, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], af, bf[2], bf[3]);
    }
  }
}

// bytes of shared memory of the two kernels (kernels/flash_attention_bwd.py
// tc_smem_bytes): K and V, and a ring of ST tiles of Q, dO and their rows'
// lse, D, |q|, |dO|; Q and dO, and two buffers of K, V and their keys' |k|,
// |v|
template <int D, int BQ, int ST, class Lay>
constexpr size_t dkdv_tc_bytes() {
  return sizeof(bf16) * (2 * kTcKeys + 2 * ST * BQ) * Lay::kStride + sizeof(float) * 4 * ST * BQ;
}
template <int D, int BK, class Lay>
constexpr size_t dq_tc_bytes() {
  return sizeof(bf16) * (2 * kTcRows + 4 * BK) * Lay::kStride + sizeof(float) * 4 * BK;
}

template <int D, int BQ, int ST, class Lay>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ stats,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         float* __restrict__ partial, TcShape s) {
  using namespace rt::mma;
  using namespace rt::tile;
  constexpr int kRow = Lay::kStride, kChunks = D / 8;
  static_assert(BQ % 16 == 0 && D % 16 == 0, "whole m16n8k16 steps");
  static_assert(ST >= 2, "a ring of at least two row tiles");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // kTcKeys x kRow
  bf16* sV = sK + kTcKeys * kRow;
  bf16* sQ = sV + kTcKeys * kRow;                // ST stages x BQ x kRow
  bf16* sdO = sQ + ST * BQ * kRow;
  float* sL = reinterpret_cast<float*>(sdO + ST * BQ * kRow);  // ST stages x BQ each
  float* sD = sL + ST * BQ;
  float* sNq = sD + ST * BQ;
  float* sNdo = sNq + ST * BQ;
  const Stats st(stats, s);

  // key tiles outer, the first (the most causal work) first
  const int per = s.b * s.kvh * s.splits;
  const int kt = blockIdx.x / per, rest = blockIdx.x % per;
  const int split = rest % s.splits, g = (rest / s.splits) % s.kvh, bi = rest / (s.splits * s.kvh);
  const int k0 = kt * kTcKeys, hs = s.rep / s.splits, head0 = g * s.rep + split * hs;

  const int64_t kstride = (int64_t)s.kvh * D, kbase = (int64_t)bi * s.sk * kstride + (int64_t)g * D;
  for (int i = threadIdx.x; i < kTcKeys * kChunks; i += kTcThreads) {
    const int j = i / kChunks, c = i % kChunks, key = k0 + j;
    const bool ok = key < s.sk;  // keys past the end are zero, never read
    const int64_t src = kbase + (int64_t)(ok ? key : 0) * kstride + c * 8;
    cp_async_16(sK + Lay::at(j, c), k + src, ok);
    cp_async_16(sV + Lay::at(j, c), v + src, ok);
  }
  cp_async_commit();

  // the rows of this block's heads, position * hs + head-in-share, that see a
  // key of the tile: causal, from position k0 - q_offset on; windowed, below
  // k_last + window - q_offset
  const int k_last = rt::imin(k0 + kTcKeys, s.sk) - 1;
  const int i_lo = s.causal ? rt::imax(k0 - s.q_offset, 0) : 0;
  const int i_hi =
      s.window > 0 ? rt::imin(s.sq, rt::imax(k_last + s.window - s.q_offset, 0)) : s.sq;
  const int row_lo = i_lo * hs, row_hi = i_hi * hs;
  const int n_tiles = row_hi > row_lo ? (row_hi - row_lo + BQ - 1) / BQ : 0;
  // rows past row_hi load the last row and are masked
  auto load_rows = [&](int t, int buf) {
    const int r0 = row_lo + t * BQ;
    bf16* tq = sQ + buf * BQ * kRow;
    bf16* tdo = sdO + buf * BQ * kRow;
    for (int i = threadIdx.x; i < BQ * kChunks; i += kTcThreads) {
      const int rr = i / kChunks, c = i % kChunks, vr = rt::imin(r0 + rr, row_hi - 1);
      const int64_t at = (((int64_t)bi * s.sq + vr / hs) * s.h + head0 + vr % hs) * D + c * 8;
      cp_async_16(tq + Lay::at(rr, c), q + at, true);
      cp_async_16(tdo + Lay::at(rr, c), dout + at, true);
    }
    for (int rr = threadIdx.x; rr < BQ; rr += kTcThreads) {
      const int vr = rt::imin(r0 + rr, row_hi - 1);
      const int64_t at = ((int64_t)bi * s.h + head0 + vr % hs) * s.sq + vr / hs;
      cp_async_4(sL + buf * BQ + rr, lse + at, true);
      cp_async_4(sD + buf * BQ + rr, st.d + at, true);
      cp_async_4(sNq + buf * BQ + rr, st.nq + at, true);
      cp_async_4(sNdo + buf * BQ + rr, st.ndo + at, true);
    }
  };
  // the ring: row tile t in stage t % ST, ST - 1 tiles in flight
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < n_tiles) load_rows(t, t);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, group = lane >> 2, quad_t = lane & 3;
  const int wkey = warp * 16;
  const int keys[2] = {k0 + wkey + group, k0 + wkey + group + 8};
  float ek[2], ev[2];  // the keys' factors of the error bounds: tie scale |k|, |v|
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t at = ((int64_t)bi * s.kvh + g) * s.sk + rt::imin(keys[i], s.sk - 1);
    ek[i] = s.tie * s.scale * st.nk[at];
    ev[i] = s.tie * s.scale * st.nv[at];
  }
  float ak[D / 8][4] = {}, av[D / 8][4] = {};
  // the pairs tc_pair flagged since the last flush: (2 row + key half, p, ds
  // as the tiles' products took them); the flush recomputes them exactly,
  // all lanes at once, and adds the difference of the bf16 roundings to dV
  // and dK, the quad that holds the key's row applying each
  // a flush costs the warp the most flags one lane holds, so lists long
  // enough to reach the end of a long block are cheaper than flushes on the
  // way (local memory, touched only by flagged pairs)
  constexpr int kPerTile = BQ / 2, kCap = 8 * kPerTile;  // elements a lane a tile
  uint4 flist[kCap];
  int nflag = 0;
  auto row_at = [&](int vr) {
    return (((int64_t)bi * s.sq + vr / hs) * s.h + head0 + vr % hs) * D;
  };
  auto flush = [&]() {
    for (int r = 0; __any_sync(0xffffffffu, r < nflag); ++r) {
      int vr = 0, i = 0;
      float dpp = 0.f, dds = 0.f;  // bf16(exact) - bf16(as taken), for P and dS
      if (r < nflag) {
        const uint4 f = flist[r];
        vr = (int)(f.x >> 1);
        i = (int)(f.x & 1u);
        const int64_t qa = row_at(vr), sa = ((int64_t)bi * s.h + head0 + vr % hs) * s.sq + vr / hs;
        const float2 d2 = seq_dots<D, Lay>(q + qa, dout + qa, sK, sV, wkey + group + 8 * i);
        float p, ds;
        exact_pair(d2.x, d2.y, lse[sa], st.d[sa], s, p, ds);
        dpp = bf16_round(p) - bf16_round(__uint_as_float(f.y));
        dds = bf16_round(ds) - bf16_round(__uint_as_float(f.z));
      }
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const int from = (lane & ~3) | src;
        const float cp = __shfl_sync(0xffffffffu, dpp, from);
        const float cs = __shfl_sync(0xffffffffu, dds, from);
        const int cvr = __shfl_sync(0xffffffffu, vr, from), ci = __shfl_sync(0xffffffffu, i, from);
        if (cp != 0.f || cs != 0.f) {
          const int64_t qa = row_at(cvr) + 2 * quad_t;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            const float2 qv = bf16_pair(q + qa + 8 * n), ov = bf16_pair(dout + qa + 8 * n);
            if (ci == 0) {
              av[n][0] += cp * ov.x;
              av[n][1] += cp * ov.y;
              ak[n][0] += cs * qv.x;
              ak[n][1] += cs * qv.y;
            } else {
              av[n][2] += cp * ov.x;
              av[n][3] += cp * ov.y;
              ak[n][2] += cs * qv.x;
              ak[n][3] += cs * qv.y;
            }
          }
        }
      }
    }
    nflag = 0;
  };
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % ST;
    cp_async_wait<ST - 2>();  // tile t (and K/V) have landed
    // one barrier a tile: the tile is visible to every warp, and every warp
    // is done with the stage the next copy refills (read last tile)
    __syncthreads();
    if (t + ST - 1 < n_tiles) load_rows(t + ST - 1, (t + ST - 1) % ST);
    cp_async_commit();
    const bf16* tq = sQ + buf * BQ * kRow;
    const bf16* tdo = sdO + buf * BQ * kRow;
    const float* tl = sL + buf * BQ;
    const float* td = sD + buf * BQ;
    const float* tnq = sNq + buf * BQ;
    const float* tndo = sNdo + buf * BQ;
    const int r0 = row_lo + t * BQ, r_end = rt::imin(r0 + BQ, row_hi);
    const int pos_first = s.q_offset + r0 / hs, pos_last = s.q_offset + (r_end - 1) / hs;
    const bool full = r0 + BQ <= row_hi && k0 + kTcKeys <= s.sk &&
                      (!s.causal || k0 + kTcKeys - 1 <= pos_first) &&
                      (s.window <= 0 || pos_last - k0 < s.window);
    float sp[BQ / 8][4], dpt[BQ / 8][4];  // S^T, dP^T: this warp's 16 keys x BQ rows
    mma_scores_pair<D, BQ, Lay>(sp, dpt, sK, sV, tq, tdo, wkey);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * quad_t + (e & 1), i = e >> 1;
        bool ok = true;
        if (!full) {
          const int vr = r0 + col;
          ok = vr < row_hi && tc_live(s, s.q_offset + vr / hs, keys[i]);
        }
        if (!ok)
          sp[n][e] = dpt[n][e] = 0.f;
        else if (tc_pair(sp[n][e], dpt[n][e], tl[col], td[col], tnq[col] * ek[i],
                         tndo[col] * ev[i], true, s))
          flist[nflag++] = make_uint4((uint32_t)(2 * (r0 + col) + i), __float_as_uint(sp[n][e]),
                                      __float_as_uint(dpt[n][e]), 0u);
      }
    mma_acc<D, BQ, Lay>(av, sp, tdo);   // dV += P^T dO
    mma_acc<D, BQ, Lay>(ak, dpt, tq);   // dK += dS^T Q
    if (__any_sync(0xffffffffu, nflag > kCap - kPerTile)) flush();
  }
  cp_async_wait<0>();  // nothing left in flight (a block with no live row)
  flush();

  // this warp's 16 keys of dK and dV: bf16 pairs, or with splits its float32
  // partials
  const int64_t one = (int64_t)s.b * s.kvh * s.splits * s.sk * D;  // dV's partials follow dK's
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = keys[i];
    if (key >= s.sk) continue;
    if (s.splits == 1) {
      const int64_t at = (((int64_t)bi * s.sk + key) * s.kvh + g) * D + 2 * quad_t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * n) = pack_bf16(ak[n][2 * i], ak[n][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * n) = pack_bf16(av[n][2 * i], av[n][2 * i + 1]);
      }
    } else {
      const int64_t at =
          (((int64_t)(bi * s.kvh + g) * s.splits + split) * s.sk + key) * D + 2 * quad_t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(partial + at + 8 * n) =
            make_float2(ak[n][2 * i], ak[n][2 * i + 1]);
        *reinterpret_cast<float2*>(partial + one + at + 8 * n) =
            make_float2(av[n][2 * i], av[n][2 * i + 1]);
      }
    }
  }
}

// dK and dV (b, sk, kvh, d) as the sum of the `splits` float32 partials
// (b, kvh, splits, sk, d) in split order: one thread per 4 columns.
__global__ void __launch_bounds__(rt::kThreads)
flash_bwd_sum_kernel(const float* __restrict__ partial, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int b, int sk, int kvh, int d, int splits) {
  const int64_t i = (int64_t)blockIdx.x * rt::kThreads + threadIdx.x;
  const int quads = d / 4;
  if (i >= (int64_t)b * sk * kvh * quads) return;
  const int c4 = (int)(i % quads), g = (int)((i / quads) % kvh);
  const int key = (int)((i / ((int64_t)quads * kvh)) % sk);
  const int64_t bi = i / ((int64_t)quads * kvh * sk);
  const int64_t one = (int64_t)b * kvh * splits * sk * d;
  const int64_t base = ((bi * kvh + g) * splits * sk + key) * d + 4 * c4, step = (int64_t)sk * d;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
  for (int sp = 0; sp < splits; ++sp) {
    const float4 x = *reinterpret_cast<const float4*>(partial + base + sp * step);
    const float4 y = *reinterpret_cast<const float4*>(partial + one + base + sp * step);
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
  }
  using rt::mma::pack_bf16;
  *reinterpret_cast<uint2*>(dk + 4 * i) = make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
  *reinterpret_cast<uint2*>(dv + 4 * i) = make_uint2(pack_bf16(c.x, c.y), pack_bf16(c.z, c.w));
}

template <int D, int BK, int MINB, class Lay>
__global__ void __launch_bounds__(kTcThreads, MINB)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, float* __restrict__ stats,
                       bf16* __restrict__ dq, TcShape s) {
  using namespace rt::mma;
  using namespace rt::tile;
  constexpr int kRow = Lay::kStride, kChunks = D / 8;
  constexpr bool kInRegs = D <= 80;  // Q and dO fragments held; re-read at d 128
  static_assert(BK % 16 == 0 && D % 16 == 0, "whole m16n8k16 steps");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kTcRows x kRow
  bf16* sdO = sQ + kTcRows * kRow;
  bf16* sK = sdO + kTcRows * kRow;               // 2 buffers x BK x kRow
  bf16* sV = sK + 2 * BK * kRow;
  float* sNk = reinterpret_cast<float*>(sV + 2 * BK * kRow);  // 2 buffers x BK each
  float* sNv = sNk + 2 * BK;
  const Stats st(stats, s);

  // the block's rows: row tiles from the last (the most causal work) first
  Rows r;
  r.sq = s.sq;
  r.h = s.h;
  r.rep = s.rep;
  r.total = s.sq * s.rep;
  const int n_row_tiles = (r.total + kTcRows - 1) / kTcRows;
  const int bg = (int)(blockIdx.x % (unsigned)(s.b * s.kvh));
  r.bi = bg / s.kvh;
  r.g = bg % s.kvh;
  r.row0 = (n_row_tiles - 1 - (int)(blockIdx.x / (unsigned)(s.b * s.kvh))) * kTcRows;
  r.pos_first = s.q_offset + r.row0 / r.rep;
  r.pos_last = s.q_offset + (rt::imin(r.row0 + kTcRows, r.total) - 1) / r.rep;
  r.hi = s.causal ? rt::imin(s.sk, r.pos_last + 1) : s.sk;
  r.lo = s.window > 0 ? rt::imax(r.pos_first - s.window + 1, 0) : 0;

  auto at = [](int row, int c) { return Lay::at(row, c); };
  copy_q<D>(sQ, at, q, r, kTcRows, kTcThreads);
  copy_q<D>(sdO, at, dout, r, kTcRows, kTcThreads);
  cp_async_commit();
  const int kb_lo = r.lo / BK, kb_hi = r.hi > r.lo ? (r.hi + BK - 1) / BK : kb_lo;
  const int64_t kstride = (int64_t)s.kvh * D,
                kbase = (int64_t)r.bi * s.sk * kstride + (int64_t)r.g * D;
  const int64_t nbase = ((int64_t)r.bi * s.kvh + r.g) * s.sk;
  // keys from the block's live bound on are zero: dS K never meets garbage
  auto load = [&](int kb, int buf) {
    for (int i = threadIdx.x; i < BK * kChunks; i += kTcThreads) {
      const int j = i / kChunks, c = i % kChunks, key = kb * BK + j;
      const bool ok = key < r.hi;
      const int64_t src = kbase + (int64_t)(ok ? key : 0) * kstride + c * 8;
      cp_async_16(sK + buf * BK * kRow + Lay::at(j, c), k + src, ok);
      cp_async_16(sV + buf * BK * kRow + Lay::at(j, c), v + src, ok);
    }
    for (int j = threadIdx.x; j < BK; j += kTcThreads) {
      const int key = kb * BK + j;
      const bool ok = key < r.hi;
      cp_async_4(sNk + buf * BK + j, st.nk + nbase + (ok ? key : 0), ok);
      cp_async_4(sNv + buf * BK + j, st.nv + nbase + (ok ? key : 0), ok);
    }
  };
  if (kb_lo < kb_hi) load(kb_lo, 0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, group = lane >> 2, quad_t = lane & 3;
  const int wrow = warp * 16;
  int q_pos[2];
  bool exists[2];
  float lsev[2], dsv[2], eq[2], edo[2];  // eq, edo: the rows' factors of the error bounds
                                        // (tie scale |q|, |dO|)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r.row0 + wrow + group + 8 * i;
    exists[i] = row < r.total;
    q_pos[i] = s.q_offset + row / r.rep;
    const int64_t sa = ((int64_t)r.bi * s.h + r.g * r.rep + row % r.rep) * s.sq + row / r.rep;
    lsev[i] = exists[i] ? lse[sa] : 0.f;
    dsv[i] = exists[i] ? st.d[sa] : 0.f;
    eq[i] = exists[i] ? s.tie * s.scale * st.nq[sa] : 0.f;
    edo[i] = exists[i] ? s.tie * s.scale * st.ndo[sa] : 0.f;
  }
  uint32_t qf[kInRegs ? D / 16 : 1][4], df[kInRegs ? D / 16 : 1][4];
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  if constexpr (kInRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      q_frag<Lay>(qf[kk], sQ, wrow, kk);
      q_frag<Lay>(df[kk], sdO, wrow, kk);
    }
  }
  float acc[D / 8][4] = {};
  // the pairs tc_pair flagged since the last flush: (2 key + row half, ds as
  // the tiles' product took it); the flush recomputes them exactly, all
  // lanes at once, and adds the difference of the bf16 roundings times K to
  // dQ, the quad that holds the row applying each
  constexpr int kPerTile = BK / 2, kCap = 8 * kPerTile;  // as in the dK/dV kernel
  uint2 flist[kCap];
  int nflag = 0;
  auto flush = [&]() {
    for (int r = 0; __any_sync(0xffffffffu, r < nflag); ++r) {
      int key = 0, i = 0;
      float dds = 0.f;  // bf16(exact) - bf16(as taken)
      if (r < nflag) {
        const uint2 f = flist[r];
        key = (int)(f.x >> 1);
        i = (int)(f.x & 1u);
        const int64_t ka = kbase + (int64_t)key * kstride;
        const float2 d2 = seq_dots<D, Lay>(k + ka, v + ka, sQ, sdO, wrow + group + 8 * i);
        float p, ds;
        exact_pair(d2.x, d2.y, i ? lsev[1] : lsev[0], i ? dsv[1] : dsv[0], s, p, ds);
        dds = bf16_round(ds) - bf16_round(__uint_as_float(f.y));
      }
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const int from = (lane & ~3) | src;
        const float cs = __shfl_sync(0xffffffffu, dds, from);
        const int ck = __shfl_sync(0xffffffffu, key, from), ci = __shfl_sync(0xffffffffu, i, from);
        if (cs != 0.f) {
          const int64_t ka = kbase + (int64_t)ck * kstride + 2 * quad_t;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            const float2 kv = bf16_pair(k + ka + 8 * n);
            if (ci == 0) {
              acc[n][0] += cs * kv.x;
              acc[n][1] += cs * kv.y;
            } else {
              acc[n][2] += cs * kv.x;
              acc[n][3] += cs * kv.y;
            }
          }
        }
      }
    }
    nflag = 0;
  };
  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int t = kb - kb_lo, buf = t & 1, k0 = kb * BK;
    cp_async_wait<0>();  // tile kb has landed
    __syncthreads();     // ... for every warp, and the other buffer is free
    if (kb + 1 < kb_hi) load(kb + 1, buf ^ 1);
    cp_async_commit();
    const bf16* tk = sK + buf * BK * kRow;
    const bf16* tv = sV + buf * BK * kRow;
    const float* tnk = sNk + buf * BK;
    const float* tnv = sNv + buf * BK;
    const bool full = r.row0 + kTcRows <= r.total && k0 + BK <= r.hi &&
                      (!s.causal || k0 + BK - 1 <= r.pos_first) &&
                      (s.window <= 0 || r.pos_last - k0 < s.window);
    float sc[BK / 8][4], dp[BK / 8][4];
    if constexpr (kInRegs) {
      mma_scores<D, BK, Lay, true>(sc, qf, sQ, tk, wrow);   // S = Q K^T
      mma_scores<D, BK, Lay, true>(dp, df, sdO, tv, wrow);  // dP = dO V^T
    } else {
      mma_scores_pair<D, BK, Lay>(sc, dp, sQ, sdO, tk, tv, wrow);
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, j = 8 * n + 2 * quad_t + (e & 1);
        const bool ok = full || (exists[i] && tc_live(s, q_pos[i], k0 + j));
        if (!ok)
          sc[n][e] = dp[n][e] = 0.f;
        else if (tc_pair(sc[n][e], dp[n][e], lsev[i], dsv[i], eq[i] * tnk[j], edo[i] * tnv[j],
                         false, s))
          flist[nflag++] = make_uint2((uint32_t)(2 * (k0 + j) + i), __float_as_uint(dp[n][e]));
      }
    mma_acc<D, BK, Lay>(acc, dp, tk);  // dQ += dS K
    if (__any_sync(0xffffffffu, nflag > kCap - kPerTile)) flush();
  }
  cp_async_wait<0>();
  flush();

  // this warp's 16 rows of dQ as bf16 pairs, the rows that exist
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!exists[i]) continue;
    const int64_t base = r.elem<D>(wrow + group + 8 * i) + 2 * quad_t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dq + base + 8 * n) = pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <int D, int BQ, int ST, int BK, int MINB, class Lay>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
              const float* lse, float* stats, bf16* dq, bf16* dk, bf16* dv, float* partial,
              const TcShape& s, cudaStream_t st) {
  const int64_t warps = (int64_t)s.b * s.sq * s.h + (int64_t)s.b * s.sk * s.kvh;
  const int64_t stat_blocks = (warps + rt::kThreads / 32 - 1) / (rt::kThreads / 32);
  const int64_t kv_blocks = (int64_t)((s.sk + kTcKeys - 1) / kTcKeys) * s.b * s.kvh * s.splits;
  const int64_t q_blocks = ((int64_t)s.sq * s.rep + kTcRows - 1) / kTcRows * s.b * s.kvh;
  const int64_t sum_blocks =
      ((int64_t)s.b * s.sk * s.kvh * (D / 4) + rt::kThreads - 1) / rt::kThreads;
  if (stat_blocks > 0x7fffffff || kv_blocks > 0x7fffffff || q_blocks > 0x7fffffff ||
      sum_blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  constexpr size_t kv_smem = dkdv_tc_bytes<D, BQ, ST, Lay>(), q_smem = dq_tc_bytes<D, BK, Lay>();
  cudaError_t e = rt::allow_smem(flash_bwd_dkdv_tc_kernel<D, BQ, ST, Lay>, kv_smem);
  if (e == cudaSuccess) e = rt::allow_smem(flash_bwd_dq_tc_kernel<D, BK, MINB, Lay>, q_smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_stats_kernel<<<(unsigned)stat_blocks, rt::kThreads, 0, st>>>(q, k, v, o, dout, stats,
                                                                         s, D);
  flash_bwd_dkdv_tc_kernel<D, BQ, ST, Lay><<<(unsigned)kv_blocks, kTcThreads, kv_smem, st>>>(
      q, k, v, dout, lse, stats, dk, dv, partial, s);
  if (s.splits > 1)
    flash_bwd_sum_kernel<<<(unsigned)sum_blocks, rt::kThreads, 0, st>>>(partial, dk, dv, s.b, s.sk,
                                                                        s.kvh, D, s.splits);
  flash_bwd_dq_tc_kernel<D, BK, MINB, Lay><<<(unsigned)q_blocks, kTcThreads, q_smem, st>>>(
      q, k, v, dout, lse, stats, dq, s);
  return (int)cudaGetLastError();
}

}  // namespace

// The CUDA-core route.  q, o, dout, dq: (b, sq, h, d); k, v, dk, dv: (b, sk,
// kvh, d), all contiguous and of one dtype; lse and the scratch dsum: (b, h,
// sq) float32.  `rows`
// query rows and `bk` keys per tile (kernels/flash_attention_bwd.py plan);
// causal 0/1; window <= 0 means none.  Three launches on `stream`.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* dsum, void* dq,
                                      void* dk, void* dv, int b, int sq, int sk, int h, int kvh,
                                      int d, int rows, int bk, int causal, int window,
                                      int q_offset, float scale, float softcap, int dtype,
                                      void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0 || d <= 0 || rows <= 0 || bk <= 0)
    return (int)cudaErrorInvalidValue;
  const Shape s{b, sq, sk, h, kvh, d, h / kvh, causal, window, q_offset, scale, softcap};
  cudaStream_t st = (cudaStream_t)stream;
  RT_DISPATCH(dtype, T, {
    return launch<T>((const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
                     (const float*)lse, (float*)dsum, (T*)dq, (T*)dk, (T*)dv, s, rows, bk, st);
  });
  return (int)cudaErrorInvalidValue;
}

// The bf16 tensor-core route: the same arguments for d in {16, 64, 80, 128}
// (the (d, BQ, ST, BK, MINB, layout) instances below are kernels/flash_attention_bwd.py
// TC_TILES), but `stats` holds 3 b h sq + 2 b kvh sk floats (D and the rows'
// and keys' norms), plus `partial`, float32 scratch of 2 x (b, kvh, splits,
// sk, d) (null with splits 1), `splits`, a divisor of h/kvh, and `tie`, the
// bound on a tensor-core score's error per unit of |a| |b|.  Three launches
// on `stream`, four with splits > 1.
extern "C" int rt_flash_attention_bwd_tc(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* stats, void* dq, void* dk, void* dv, void* partial,
                                         int b, int sq, int sk, int h, int kvh, int d, int splits,
                                         int causal, int window, int q_offset, float scale,
                                         float softcap, float tie, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0 || splits <= 0 ||
      (h / kvh) % splits != 0 || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const TcShape s{b, sq, sk, h, kvh, h / kvh, splits, causal, window, q_offset, scale, softcap,
                  tie};
  cudaStream_t st = (cudaStream_t)stream;
#define RT_FLASH_BWD_TC(D, BQ, ST, BK, MINB, LAY)                                          \
  if (d == D)                                                                              \
    return launch_tc<D, BQ, ST, BK, MINB, rt::mma::LAY<D>>(                                \
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dout, \
        (const float*)lse, (float*)stats, (bf16*)dq, (bf16*)dk, (bf16*)dv, (float*)partial, s, st)
  RT_FLASH_BWD_TC(16, 64, 2, 64, 2, Swizzle);
  RT_FLASH_BWD_TC(64, 32, 3, 64, 2, Swizzle);
  RT_FLASH_BWD_TC(80, 32, 3, 32, 2, Padded);
  RT_FLASH_BWD_TC(128, 16, 4, 32, 3, Swizzle);
#undef RT_FLASH_BWD_TC
  return (int)cudaErrorInvalidValue;
}
