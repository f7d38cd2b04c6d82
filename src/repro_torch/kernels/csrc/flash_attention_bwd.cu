// Flash-attention backward for Hopper (sm_90a), on the CUDA cores.
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
// gets dq = 0 and gives dk, dv nothing.
//
// Bound on this card: operations (at glm4-9b's training shape, 1024 keys and
// 16 query heads per kv head, about 10 flops per byte of K/V read per query
// row).  This first version does not reach the tensor cores: it is the
// CUDA-core design of FlashAttention-2, split so that no two blocks write
// one output and nothing needs an atomic:
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

#include "common.cuh"

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

}  // namespace

// q, o, dout, dq: (b, sq, h, d); k, v, dk, dv: (b, sk, kvh, d), all contiguous
// and of one dtype; lse and the scratch dsum: (b, h, sq) float32.  `rows`
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
