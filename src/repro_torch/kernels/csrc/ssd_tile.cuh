// bf16 tiles of the tensor-core SSD scan (ssd_tc.cu) and its backward
// (ssd_bwd_tc.cu): rows padded by 8 elements, staged by 16-byte cp.async
// copies where a row is 16-byte aligned and by 2-byte loads where it is not
// (a projection of odd width), and the ldmatrix fragment loads of
// mma.sync m16n8k16 from such tiles.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace rt {
namespace ssd {

using bf16 = __nv_bfloat16;

// Shared-memory tiles are rows of bf16 padded by 8 elements: a row of D
// (D % 16 == 0) spans an odd number of 16-byte chunks, so the 8 rows one
// ldmatrix matrix reads fall in 8 different bank groups (mma.cuh Padded,
// with D known at run time).
__host__ __device__ inline int pad_row(int d) { return d + 8; }

// 8 consecutive bf16 at src: one 16-byte load where vec, else 8 2-byte loads
__device__ __forceinline__ uint4 load8(const bf16* src, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(src));
  const unsigned short* e = reinterpret_cast<const unsigned short*>(src);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = (uint32_t)__ldg(e + 2 * i) | ((uint32_t)__ldg(e + 2 * i + 1) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// Rows [t0, t0 + L) of a bf16 operand with rows of d elements (element
// stride st between timesteps, d contiguous) into a Q x pad_row(d) tile,
// rows L..Q-1 zero: 16-byte cp.async copies where vec (the caller commits
// and waits), else 2-byte loads through registers.
template <int Q>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int64_t st,
                                           int L, int d, bool vec) {
  using namespace rt::mma;
  const int chunks = d / 8, stride = pad_row(d);
  for (int i = threadIdx.x; i < Q * chunks; i += rt::kThreads) {
    const int k = i / chunks, ch = i % chunks;
    bf16* to = dst + k * stride + ch * 8;
    if (vec)  // a row past L reads nothing (row 0 stands in as a valid address)
      cp_async_16(to, src + (k < L ? k * st : 0) + ch * 8, k < L);
    else
      *reinterpret_cast<uint4*>(to) = k < L ? load8(src + k * st + ch * 8, false)
                                            : make_uint4(0, 0, 0, 0);
  }
}

// 16-byte loads of (.., width) rows need the base 16-byte aligned and both
// element strides multiples of 8
inline bool vec_ok(const void* p, long long sb, long long st) {
  return ((uintptr_t)p % 16 == 0) && sb % 8 == 0 && st % 8 == 0;
}

// Fragments of m16n8k16 from a tile with rows of `stride` elements (lane =
// threadIdx.x % 32).  load_a: the A fragment (rows m0..m0+15, columns
// k0..k0+15) of a tile stored [M][K]; load_a_t: the same of the transpose of
// a tile stored [K][M].  load_b: the B fragments of columns n0..n0+7 (b[0],
// b[1]) and n0+8..n0+15 (b[2], b[3]) over k0..k0+15 of a tile stored [N][K];
// load_b_t: the same of a tile stored [K][N].
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int stride, int m0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  rt::mma::ldmatrix_x4(a, tile + (m0 + (lane & 15)) * stride + k0 + ((lane >> 4) << 3));
}
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* tile, int stride, int m0,
                                         int k0) {
  const int lane = threadIdx.x & 31;
  rt::mma::ldmatrix_x4_trans(
      a, tile + (k0 + (lane & 7) + ((lane >> 4) << 3)) * stride + m0 + (((lane >> 3) & 1) << 3));
}
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int stride, int n0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  rt::mma::ldmatrix_x4(
      b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * stride + k0 + (((lane >> 3) & 1) << 3));
}
__device__ __forceinline__ void load_b_t(uint32_t (&b)[4], const bf16* tile, int stride, int n0,
                                         int k0) {
  const int lane = threadIdx.x & 31;
  rt::mma::ldmatrix_x4_trans(
      b, tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * stride + n0 + ((lane >> 4) << 3));
}

// c0 (columns n0..n0+7) and c1 (n0+8..n0+15) += a * b, b from load_b(_t)
__device__ __forceinline__ void mma16(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[4]) {
  rt::mma::mma_bf16(c0, a, b[0], b[1]);
  rt::mma::mma_bf16(c1, a, b[2], b[3]);
}

}  // namespace ssd
}  // namespace rt
