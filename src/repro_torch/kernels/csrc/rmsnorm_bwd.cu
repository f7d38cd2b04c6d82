// RMSNorm backward for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernel repro/kernels/rmsnorm.py:rmsnorm,
// which the JAX package takes by autodiff of its plain version.  For
// y = x * r * (1 + w), r = rsqrt(mean(x^2) + eps), per row of x (..., D)
// flattened to rows, and the output's cotangent dy, with g = dy (1 + w):
//   dx = r g - x r^3 mean(g x)     (in x's dtype, float32 statistics)
//   dw = sum over rows of dy x r   (in w's dtype, float32 sums)
//
// Bound on this card: bytes.  A row of x and dy is read and one of dx
// written against ~10 operations per element, far below the H100's ~295
// operations per byte.
//
// Two launches and no atomics, so dw is the same on every run:
//  - rmsnorm_bwd_kernel: `blocks` blocks of 256 threads, block i taking rows
//    i, i + blocks, ...; per row one pass for the two sums (sum x^2 and sum
//    g x, reduced by warp shuffles and one exchange through shared memory),
//    then a pass that writes dx and adds dy x r into the block's float32
//    partial of dw, each thread owning the same columns in every row (the
//    partial sits in shared memory where D floats fit, else in the block's
//    row of the partial buffer); the partials go out once at the end;
//  - rmsnorm_bwd_dw_kernel: one thread per column sums the `blocks` partials
//    in block order and writes dw.
#include "common.cuh"

namespace {

constexpr int kWarps = rt::kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ partial, int64_t rows, int64_t D,
                   float eps, int in_smem) {
  extern __shared__ float acc_smem[];
  __shared__ float red[2][kWarps];
  float* acc = in_smem ? acc_smem : partial + (int64_t)blockIdx.x * D;
  for (int64_t i = threadIdx.x; i < D; i += rt::kThreads) acc[i] = 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * D;
    const T* dyr = dy + row * D;
    float ss = 0.f, gx = 0.f;
    for (int64_t i = threadIdx.x; i < D; i += rt::kThreads) {
      const float xv = rt::to_f32(xr[i]);
      const float g = rt::to_f32(dyr[i]) * (1.f + rt::to_f32(w[i]));
      ss += xv * xv;
      gx += g * xv;
    }
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
    }
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = gx;
    }
    __syncthreads();
    ss = gx = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      ss += red[0][i];
      gx += red[1][i];
    }
    __syncthreads();  // every thread has read red before the next row writes it
    const float r = rsqrtf(ss / (float)D + eps);
    const float c = r * r * r * (gx / (float)D);
    T* dxr = dx + row * D;
    for (int64_t i = threadIdx.x; i < D; i += rt::kThreads) {
      const float xv = rt::to_f32(xr[i]), dyv = rt::to_f32(dyr[i]);
      dxr[i] = rt::from_f32<T>(r * dyv * (1.f + rt::to_f32(w[i])) - xv * c);
      acc[i] += dyv * xv * r;
    }
  }
  if (in_smem)
    for (int64_t i = threadIdx.x; i < D; i += rt::kThreads)
      partial[(int64_t)blockIdx.x * D + i] = acc[i];
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
rmsnorm_bwd_dw_kernel(const float* __restrict__ partial, T* __restrict__ dw, int blocks,
                      int64_t D) {
  const int64_t c = (int64_t)blockIdx.x * rt::kThreads + threadIdx.x;
  if (c >= D) return;
  float s = 0.f;
  for (int p = 0; p < blocks; ++p) s += partial[(int64_t)p * D + c];
  dw[c] = rt::from_f32<T>(s);
}

template <typename T>
int launch(const T* x, const T* w, const T* dy, T* dx, T* dw, float* partial, long long rows,
           long long D, float eps, int blocks, cudaStream_t st) {
  const size_t smem = (size_t)D * sizeof(float);
  const int in_smem = smem <= 227 * 1024;
  if (in_smem) {
    cudaError_t e = rt::allow_smem(rmsnorm_bwd_kernel<T>, smem);
    if (e != cudaSuccess) return (int)e;
  }
  rmsnorm_bwd_kernel<T><<<(unsigned)blocks, rt::kThreads, in_smem ? smem : 0, st>>>(
      x, w, dy, dx, partial, rows, D, eps, in_smem);
  rmsnorm_bwd_dw_kernel<T><<<(unsigned)((D + rt::kThreads - 1) / rt::kThreads), rt::kThreads, 0,
                             st>>>(partial, dw, blocks, D);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx: (rows, D) contiguous; w, dw: (D,); all of one dtype.  partial:
// (blocks, D) float32 scratch, blocks in [1, rows].
extern "C" int rt_rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                              void* partial, long long rows, long long D, float eps, int blocks,
                              int dtype, void* stream) {
  if (rows <= 0 || D <= 0 || blocks <= 0 || blocks > rows || D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  RT_DISPATCH(dtype, T, {
    return launch<T>((const T*)x, (const T*)w, (const T*)dy, (T*)dx, (T*)dw, (float*)partial,
                     rows, D, eps, blocks, st);
  });
  return (int)cudaErrorInvalidValue;
}
