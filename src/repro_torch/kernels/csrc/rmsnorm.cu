// RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:rmsnorm.  Computes, per
// row of x (..., D) flattened to rows: y = x * rsqrt(mean(x^2) + eps) * (1 + w)
// with float32 statistics; y has the dtype of x.
//
// Bound on this card: bytes.  A row is read and written once (2*D elements)
// against D multiply-adds, far below the H100's ~295 operations per byte.
// Design: one 256-thread block per row (D = 4096 at full glm4-9b width);
// neighbouring threads read neighbouring elements, so every warp load is
// one coalesced transaction.  The second pass re-reads the row, which the
// block has just touched and finds in L1/L2, instead of staging it in shared
// memory, so D is unbounded.  The sum of squares is reduced in shared memory.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int64_t D, float eps) {
  __shared__ float red[rt::kThreads];
  const T* xr = x + (int64_t)blockIdx.x * D;
  T* orow = out + (int64_t)blockIdx.x * D;
  float ss = 0.f;
  for (int64_t i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = rt::to_f32(xr[i]);
    ss += v * v;
  }
  red[threadIdx.x] = ss;
  __syncthreads();
  for (int s = rt::kThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float inv = rsqrtf(red[0] / (float)D + eps);
  for (int64_t i = threadIdx.x; i < D; i += blockDim.x) {
    const float normed = rt::to_f32(xr[i]) * inv;
    orow[i] = rt::from_f32<T>(normed * (1.f + rt::to_f32(w[i])));
  }
}

}  // namespace

// x, out: (rows, D) contiguous; w: (D,).  All of one dtype.
extern "C" int rt_rmsnorm(const void* x, const void* w, void* out, long long rows,
                          long long D, float eps, int dtype, void* stream) {
  if (rows <= 0 || D <= 0 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  RT_DISPATCH(dtype, T, {
    rmsnorm_kernel<T><<<(unsigned)rows, rt::kThreads, 0, st>>>((const T*)x, (const T*)w,
                                                              (T*)out, (int64_t)D, eps);
  });
  return (int)cudaGetLastError();
}
