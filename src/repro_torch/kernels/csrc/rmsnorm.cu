// RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:rmsnorm.  Computes, per
// row of x (..., D) flattened to rows: y = x * rsqrt(mean(x^2) + eps) * (1 + w)
// with float32 statistics; y has the dtype of x.
//
// Bound on this card: bytes.  A row is read and written once (2*D elements)
// against D multiply-adds, far below the H100's ~295 operations per byte.
// What the design does about it: every byte moves once, in 16-byte accesses,
// with enough of them in flight.
//  - rmsnorm_kernel_vec (D a multiple of 16 bytes' worth of elements and
//    every pointer 16-byte aligned): a row is read once, in 16-byte vectors
//    held in registers (NV a thread: two at D 4096 in bf16), squared and
//    summed in float32, reduced by warp shuffles and, for a row wider than a
//    warp, one exchange of per-warp sums through shared memory; then the same
//    registers are scaled by the row's rsqrt and (1 + w), w read as vectors,
//    and written as vectors.  A row takes tpr threads (the least power of two
//    at which a thread holds at most two vectors, at most 256), and a
//    256-thread block holds 256 / tpr rows, so a small D still fills a block.
//  - rmsnorm_kernel, the scalar path (D % (16 / sizeof(T)) != 0, a row not
//    16-byte aligned, or a row wider than 256 x 8 vectors): one 256-thread
//    block per row; the row is read twice (the second pass finds it in
//    L1/L2), so D is unbounded; the same shuffle reduction.
#include "common.cuh"

namespace {

constexpr int kWarps = rt::kThreads / 32;
constexpr int kMaxVecs = 8;  // 16-byte vectors a thread holds, at most

using rt::pack;
using rt::unpack;

// The sum of `v` over the `width` threads (a power of two) of this thread's
// row: shuffles within a warp, then, for a row wider than a warp, the
// per-warp sums through shared memory (one barrier, reached by every thread).
__device__ __forceinline__ float row_sum(float v, int width, float* part) {
  for (int off = (width < 32 ? width : 32) / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (width > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) part[warp] = v;
    __syncthreads();
    const int first = (threadIdx.x / width) * (width / 32);
    v = 0.f;
    for (int i = 0; i < width / 32; ++i) v += part[first + i];
  }
  return v;
}

template <typename T, int NV>
__global__ void __launch_bounds__(rt::kThreads)
rmsnorm_kernel_vec(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                   int64_t rows, int D, int tpr, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float part[kWarps];
  const int V = D / kVec;
  const int64_t row = (int64_t)blockIdx.x * (rt::kThreads / tpr) + threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const bool live = row < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row : 0) * D);
  uint4 xv[NV];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + k * tpr;
    xv[k] = live && i < V ? xr[i] : make_uint4(0, 0, 0, 0);
    float f[kVec];
    unpack(xv[k], f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) ss += f[e] * f[e];
  }
  const float inv = rsqrtf(row_sum(ss, tpr, part) / (float)D + eps);
  if (!live) return;
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* orow = reinterpret_cast<uint4*>(out + row * D);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + k * tpr;
    if (i >= V) break;
    float f[kVec], g[kVec];
    unpack(xv[k], f);
    unpack(wr[i], g);
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] = f[e] * inv * (1.f + g[e]);
    orow[i] = pack(f);
  }
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int64_t D, float eps) {
  __shared__ float part[kWarps];
  const T* xr = x + (int64_t)blockIdx.x * D;
  T* orow = out + (int64_t)blockIdx.x * D;
  float ss = 0.f;
  for (int64_t i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = rt::to_f32(xr[i]);
    ss += v * v;
  }
  const float inv = rsqrtf(row_sum(ss, rt::kThreads, part) / (float)D + eps);
  for (int64_t i = threadIdx.x; i < D; i += blockDim.x) {
    const float normed = rt::to_f32(xr[i]) * inv;
    orow[i] = rt::from_f32<T>(normed * (1.f + rt::to_f32(w[i])));
  }
}

template <typename T>
int launch(const T* x, const T* w, T* out, long long rows, long long D, float eps,
           cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) & 15u) == 0;
  const long long V = D / kVec;
  if (D % kVec == 0 && aligned && V <= (long long)rt::kThreads * kMaxVecs) {
    // threads a row: the least power of two at which a thread holds at most
    // two vectors, at most 256 (then up to kMaxVecs a thread)
    int tpr = 1;
    while (tpr < rt::kThreads && (long long)tpr * 2 < V) tpr *= 2;
    const int nv = (int)((V + tpr - 1) / tpr);
    const long long blocks = (rows + rt::kThreads / tpr - 1) / (rt::kThreads / tpr);
#define RT_RMS_VEC(NV)                                                                     \
  rmsnorm_kernel_vec<T, NV><<<(unsigned)blocks, rt::kThreads, 0, st>>>(x, w, out, rows,  \
                                                                       (int)D, tpr, eps)
    if (nv <= 1) RT_RMS_VEC(1);
    else if (nv <= 2) RT_RMS_VEC(2);
    else if (nv <= 4) RT_RMS_VEC(4);
    else RT_RMS_VEC(8);
#undef RT_RMS_VEC
  } else {
    rmsnorm_kernel<T><<<(unsigned)rows, rt::kThreads, 0, st>>>(x, w, out, (int64_t)D, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (rows, D) contiguous; w: (D,).  All of one dtype.
extern "C" int rt_rmsnorm(const void* x, const void* w, void* out, long long rows,
                          long long D, float eps, int dtype, void* stream) {
  if (rows <= 0 || D <= 0 || rows > 0x7fffffffLL || D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  RT_DISPATCH(dtype, T, { return launch<T>((const T*)x, (const T*)w, (T*)out, rows, D, eps, st); });
  return (int)cudaErrorInvalidValue;
}
