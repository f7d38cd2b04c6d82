// Shared pieces of the port's hand-written sm_90a kernels: dtype handling,
// the C-interface dtype and KV-storage dispatch, and the online-softmax
// attention tile that paged_attention.cu, varlen_prefill.cu and
// spec_verify.cu all step through.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rt {

// masked score: -0.7 * FLT_MAX, never -inf (exp(NEG_INF - m) is an exact 0
// for any finite m, and NEG_INF - NEG_INF is 0, never NaN)
constexpr float kNegInf = -2.3819765e38f;
constexpr float kMinL = 1e-37f;  // softmax denominator clamp
constexpr int kThreads = 256;    // every kernel of the port runs 256 threads

enum DType : int { kF32 = 0, kBF16 = 1 };
// Storage of a paged K/V pool: the compute dtype, or 1-byte codes with one
// float32 scale per (pool row, kv head) that the tile loader multiplies in.
enum KVStore : int { kKVSame = 0, kKVInt8 = 1, kKVFp8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The 16 / sizeof(T) elements of a 16-byte vector (4 float32, 8 bf16), as
// float32, and back (bf16 rounded to nearest): the vector loads and stores
// of rmsnorm.cu and rmsnorm_bwd.cu.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Runs BODY with T bound to the element type named by the runtime dtype code;
// an unknown code returns cudaErrorInvalidValue from the enclosing function.
#define RT_DISPATCH(dtype, T, ...)                 \
  switch (dtype) {                                 \
    case ::rt::kF32: {                             \
      using T = float;                             \
      __VA_ARGS__;                                 \
    } break;                                       \
    case ::rt::kBF16: {                            \
      using T = __nv_bfloat16;                     \
      __VA_ARGS__;                                 \
    } break;                                       \
    default:                                       \
      return (int)cudaErrorInvalidValue;           \
  }

// Runs BODY with KV bound to the pool's storage type: T itself, int8_t or
// __nv_fp8_e4m3 (e4m3fn bits, torch.float8_e4m3fn).  Nest it inside
// RT_DISPATCH, which binds T.
#define RT_DISPATCH_KV(store, T, KV, ...)          \
  switch (store) {                                 \
    case ::rt::kKVSame: {                          \
      using KV = T;                                \
      __VA_ARGS__;                                 \
    } break;                                       \
    case ::rt::kKVInt8: {                          \
      using KV = int8_t;                           \
      __VA_ARGS__;                                 \
    } break;                                       \
    case ::rt::kKVFp8: {                           \
      using KV = __nv_fp8_e4m3;                    \
      __VA_ARGS__;                                 \
    } break;                                       \
    default:                                       \
      return (int)cudaErrorInvalidValue;           \
  }

// Scale pools are given (non-null, both) exactly when the pool stores codes.
inline bool kv_args_ok(int store, const void* k_scales, const void* v_scales) {
  const bool scaled = store != kKVSame;
  return (k_scales != nullptr) == scaled && (v_scales != nullptr) == scaled;
}

// ---------------------------------------------------------------------------
// Online-softmax attention tile in shared memory.
//
// R query rows of head dim d meet PS keys per step.  Everything is float32:
// q and k rows are padded to d+1 floats so that the 16 keys one warp reads at
// the same column fall in 16 different banks.  The running max m, sum l and
// the per-step rescale alpha live beside an R x d float32 accumulator.
// ---------------------------------------------------------------------------
struct Tile {
  float* q;      // R x (d+1)
  float* k;      // PS x (d+1)
  float* v;      // PS x d
  float* s;      // R x PS scores, then probabilities
  float* m;      // R
  float* l;      // R
  float* alpha;  // R
  float* acc;    // R x d
  int R, PS, d;
};

__host__ __device__ inline size_t tile_floats(int R, int PS, int d) {
  return (size_t)R * (d + 1) + (size_t)PS * (d + 1) + (size_t)PS * d +
         (size_t)R * PS + 3 * (size_t)R + (size_t)R * d;
}

__device__ inline Tile carve_tile(float* smem, int R, int PS, int d) {
  Tile t;
  t.R = R;
  t.PS = PS;
  t.d = d;
  t.q = smem;
  t.k = t.q + (size_t)R * (d + 1);
  t.v = t.k + (size_t)PS * (d + 1);
  t.s = t.v + (size_t)PS * d;
  t.m = t.s + (size_t)R * PS;
  t.l = t.m + R;
  t.alpha = t.l + R;
  t.acc = t.alpha + R;
  return t;
}

// m = NEG_INF, l = 0, acc = 0.  Caller synchronises before the first step.
__device__ inline void tile_reset(const Tile& t) {
  for (int r = threadIdx.x; r < t.R; r += blockDim.x) {
    t.m[r] = kNegInf;
    t.l[r] = 0.f;
  }
  for (int i = threadIdx.x; i < t.R * t.d; i += blockDim.x) t.acc[i] = 0.f;
}

// Load query row r from src + row_offset(r) (d contiguous elements).
template <typename T, class RowOffset>
__device__ inline void tile_load_q(const Tile& t, const T* __restrict__ src, RowOffset row_offset) {
  for (int i = threadIdx.x; i < t.R * t.d; i += blockDim.x) {
    const int r = i / t.d, c = i % t.d;
    t.q[r * (t.d + 1) + c] = to_f32(src[row_offset(r) + c]);
  }
}

// Load PS key/value rows; key row j starts at element offset(j) in k_src
// and v_src.  Rows no query may read (row_ok(j) false: past the live length,
// outside the committed context, pad) are zeroed, so stale or uninitialised
// memory can never reach the accumulator through a zero probability.
// With scales (k_scale non-null: an int8/fp8 pool) each loaded code is
// dequantized at once, code * scale in float32: the scale of row j and its
// kv head sits at offset(j) / d, because the scale pools (num_pages, ps, kvh)
// index the pool rows (num_pages, ps, kvh, d) without their last axis.
template <typename KV, class RowOffset, class RowOk>
__device__ inline void tile_load_kv(const Tile& t, const KV* __restrict__ k_src,
                                    const KV* __restrict__ v_src,
                                    const float* __restrict__ k_scale,
                                    const float* __restrict__ v_scale, RowOffset offset,
                                    RowOk row_ok) {
  for (int i = threadIdx.x; i < t.PS * t.d; i += blockDim.x) {
    const int j = i / t.d, c = i % t.d;
    float kv = 0.f, vv = 0.f;
    if (row_ok(j)) {
      const int64_t row = offset(j);
      kv = to_f32(k_src[row + c]);
      vv = to_f32(v_src[row + c]);
      if (k_scale != nullptr) {
        kv *= k_scale[row / t.d];
        vv *= v_scale[row / t.d];
      }
    }
    t.k[j * (t.d + 1) + c] = kv;
    t.v[j * t.d + c] = vv;
  }
}

// One online-softmax step over the loaded keys.  valid(r, j) says whether
// query row r may attend key j.  Callers synchronise around the whole step
// (K/V loaded before, tile reusable after).
template <class Valid>
__device__ inline void tile_step(const Tile& t, float scale, float softcap, Valid valid) {
  const int R = t.R, PS = t.PS, d = t.d;
  // scores: one (row, key) dot product per thread
  for (int i = threadIdx.x; i < R * PS; i += blockDim.x) {
    const int r = i / PS, j = i % PS;
    float sc = kNegInf;
    if (valid(r, j)) {
      const float* qr = t.q + r * (d + 1);
      const float* kj = t.k + j * (d + 1);
      float dot = 0.f;
      for (int c = 0; c < d; ++c) dot += qr[c] * kj[c];
      dot *= scale;
      if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
      sc = dot;
    }
    t.s[i] = sc;
  }
  __syncthreads();
  // running max / sum per row; the explicit p mask keeps a row with no
  // valid key at l = 0, so it ends as an exact zero
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float* sr = t.s + r * PS;
    float mt = kNegInf;
    for (int j = 0; j < PS; ++j) mt = fmaxf(mt, sr[j]);
    const float m_old = t.m[r];
    const float m_new = fmaxf(m_old, mt);
    const float a = expf(m_old - m_new);
    float sum = 0.f;
    for (int j = 0; j < PS; ++j) {
      const float p = valid(r, j) ? expf(sr[j] - m_new) : 0.f;
      sr[j] = p;
      sum += p;
    }
    t.l[r] = t.l[r] * a + sum;
    t.m[r] = m_new;
    t.alpha[r] = a;
  }
  __syncthreads();
  // acc = acc * alpha + P V
  for (int i = threadIdx.x; i < R * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    const float* pr = t.s + r * PS;
    float a = t.acc[i] * t.alpha[r];
    for (int j = 0; j < PS; ++j) a += pr[j] * t.v[j * d + c];
    t.acc[i] = a;
  }
  __syncthreads();
}

// out row r at dst + row_offset(r): acc / max(l, 1e-37).  Caller synchronises
// after the last step.
template <typename T, class RowOffset>
__device__ inline void tile_store(const Tile& t, T* __restrict__ dst, RowOffset row_offset) {
  for (int i = threadIdx.x; i < t.R * t.d; i += blockDim.x) {
    const int r = i / t.d, c = i % t.d;
    dst[row_offset(r) + c] = from_f32<T>(t.acc[i] / fmaxf(t.l[r], kMinL));
  }
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace rt
