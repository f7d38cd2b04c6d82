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
// operations per byte.  What the design does about it: every byte of x, dy
// and dx moves once, in 16-byte accesses, with the next row's loads in
// flight while the current row is reduced; dw costs one float32 row a block.
//
// Two launches and no atomics, so dw is the same on every run:
//  - rmsnorm_bwd_kernel_vec (D a multiple of 16 bytes' worth of elements,
//    every pointer 16-byte aligned, at most kMaxVecs vectors a thread): the
//    forward's vector design (rmsnorm.cu).  A row takes tpr threads (the
//    least power of two at which a thread holds at most two vectors, at most
//    256) and a 256-thread block holds 256 / tpr rows ("slots") at a time,
//    so a small D (768, 2560) still fills a block.  Each thread holds its
//    columns' x and dy as 16-byte vectors in registers, read once: the two
//    sums (x^2, g x) by warp shuffles and, for a row wider than a warp, one
//    exchange through shared memory (double-buffered: one barrier a row);
//    then dx from the same registers, written as vectors.  The block walks
//    rows blockIdx * slots + slot, then + gridDim * slots, ..., the next
//    row's vectors loaded before the current row's reduction.  Each thread
//    keeps its columns' dw partial in float32 registers across its rows;
//    at the end the slots' partials are summed in slot order (through
//    shared memory where slots > 1) into the block's row of `partial`.
//  - rmsnorm_bwd_kernel, the scalar path (any other D or alignment): one
//    256-thread block per row in turn, the row read twice (the second pass
//    finds it in L1/L2), the block's dw partial in shared memory where D
//    floats fit, else in its row of `partial`.
//  - rmsnorm_bwd_dw_kernel: dw = the sum of the `blocks` partial rows.  A
//    block takes 32 columns, one a lane (128-byte loads per warp); warp i
//    sums partial rows i, i + 8, ... in order and warp 0 the 8 warps' sums
//    in warp order: ceil(D / 32) blocks (128 at D 4096), each thread ~blocks
//    / 8 independent loads.
#include "common.cuh"

namespace {

constexpr int kWarps = rt::kThreads / 32;
constexpr int kMaxVecs = 4;     // 16-byte vectors of a row a thread holds, at most
constexpr int kSlotFloats = 2 * rt::kThreads * 8;  // slots x D floats, at most

using rt::pack;
using rt::unpack;

// a and b summed over the `width` threads (a power of two) of this thread's
// row: shuffles within a warp, then, for a row wider than a warp, the
// per-warp sums through part[2][kWarps] (one barrier, reached by every
// thread of the block; the caller alternates two such buffers row by row).
__device__ __forceinline__ void row_sum2(float& a, float& b, int width, float (*part)[kWarps]) {
  for (int off = (width < 32 ? width : 32) / 2; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (width > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      part[0][warp] = a;
      part[1][warp] = b;
    }
    __syncthreads();
    const int first = (threadIdx.x / width) * (width / 32);
    a = b = 0.f;
    for (int i = 0; i < width / 32; ++i) {
      a += part[0][first + i];
      b += part[1][first + i];
    }
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(rt::kThreads)
rmsnorm_bwd_kernel_vec(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                       T* __restrict__ dx, float* __restrict__ partial, int64_t rows, int D,
                       int tpr, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float part[2][2][kWarps];
  __shared__ __align__(16) float slot_acc[kSlotFloats];
  const int V = D / kVec, slots = rt::kThreads / tpr;
  const int slot = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4 wv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) wv[k] = lane + k * tpr < V ? wr[lane + k * tpr] : zero;
  // this thread's vectors of row `row` (zero past the rows or the row's end)
  auto load = [&](int64_t row, uint4 (&xv)[NV], uint4 (&gv)[NV]) {
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row : 0) * D);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + (live ? row : 0) * D);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = lane + k * tpr;
      xv[k] = live && i < V ? xr[i] : zero;
      gv[k] = live && i < V ? gr[i] : zero;
    }
  };
  float acc[NV][kVec] = {};
  const int64_t stride = (int64_t)gridDim.x * slots;
  uint4 xv[NV], gv[NV];
  load((int64_t)blockIdx.x * slots + slot, xv, gv);
  int parity = 0;
  // every thread of the block runs the same iterations (row_sum2's barrier)
  for (int64_t base = (int64_t)blockIdx.x * slots; base < rows; base += stride, parity ^= 1) {
    const int64_t row = base + slot;
    uint4 nx[NV], ng[NV];
    load(row + stride, nx, ng);
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float f[kVec], d[kVec], wf[kVec];  // x, dy, w
      unpack(xv[k], f);
      unpack(gv[k], d);
      unpack(wv[k], wf);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ss += f[e] * f[e];
        gx += d[e] * (1.f + wf[e]) * f[e];
      }
    }
    row_sum2(ss, gx, tpr, part[parity]);
    const float r = rsqrtf(ss / (float)D + eps);
    const float c = r * r * r * (gx / (float)D);
    if (row < rows) {
      uint4* dxr = reinterpret_cast<uint4*>(dx + row * D);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int i = lane + k * tpr;
        if (i >= V) break;
        float f[kVec], d[kVec], wf[kVec], o[kVec];
        unpack(xv[k], f);
        unpack(gv[k], d);
        unpack(wv[k], wf);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          o[e] = r * d[e] * (1.f + wf[e]) - f[e] * c;
          acc[k][e] += d[e] * f[e] * r;
        }
        dxr[i] = pack(o);
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      xv[k] = nx[k];
      gv[k] = ng[k];
    }
  }
  // the block's partial of dw: the slots' in slot order
  float* out = partial + (int64_t)blockIdx.x * D;
  float* mine = slots > 1 ? slot_acc + slot * D : out;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + k * tpr;
    if (i >= V) break;
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(mine + i * kVec + e) =
          make_float4(acc[k][e], acc[k][e + 1], acc[k][e + 2], acc[k][e + 3]);
  }
  if (slots > 1) {
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += rt::kThreads) {
      float s = 0.f;
      for (int sl = 0; sl < slots; ++sl) s += slot_acc[sl * D + c];
      out[c] = s;
    }
  }
}

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
  __shared__ float red[kWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t c = (int64_t)blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < D) {
#pragma unroll 4
    for (int p = warp; p < blocks; p += kWarps) s += partial[(int64_t)p * D + c];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) t += red[i][lane];
    dw[c] = rt::from_f32<T>(t);
  }
}

template <typename T>
int launch(const T* x, const T* w, const T* dy, T* dx, T* dw, float* partial, long long rows,
           long long D, float eps, int blocks, int tpr, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (tpr > 0) {
    // the vector path: the wrapper's plan (kernels/rmsnorm_bwd.py plan)
    const bool aligned = (((uintptr_t)x | (uintptr_t)w | (uintptr_t)dy | (uintptr_t)dx) & 15u) == 0;
    const long long V = D / kVec;
    if (D % kVec != 0 || !aligned || tpr > rt::kThreads || (tpr & (tpr - 1)) != 0 ||
        V > (long long)tpr * kMaxVecs || D > 0x7fffffffLL ||
        (tpr < rt::kThreads && (long long)(rt::kThreads / tpr) * D > kSlotFloats))
      return (int)cudaErrorInvalidValue;
    const long long nv = (V + tpr - 1) / tpr;
#define RT_RMS_BWD_VEC(NV)                                                                  \
  rmsnorm_bwd_kernel_vec<T, NV><<<(unsigned)blocks, rt::kThreads, 0, st>>>(x, w, dy, dx,    \
                                                                         partial, rows,    \
                                                                         (int)D, tpr, eps)
    if (nv <= 1) RT_RMS_BWD_VEC(1);
    else if (nv <= 2) RT_RMS_BWD_VEC(2);
    else RT_RMS_BWD_VEC(4);
#undef RT_RMS_BWD_VEC
  } else {
    const size_t smem = (size_t)D * sizeof(float);
    const int in_smem = smem <= 227 * 1024;
    if (in_smem) {
      cudaError_t e = rt::allow_smem(rmsnorm_bwd_kernel<T>, smem);
      if (e != cudaSuccess) return (int)e;
    }
    rmsnorm_bwd_kernel<T><<<(unsigned)blocks, rt::kThreads, in_smem ? smem : 0, st>>>(
        x, w, dy, dx, partial, rows, D, eps, in_smem);
  }
  rmsnorm_bwd_dw_kernel<T><<<(unsigned)((D + 31) / 32), rt::kThreads, 0, st>>>(partial, dw,
                                                                               blocks, D);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx: (rows, D) contiguous; w, dw: (D,); all of one dtype.  partial:
// (blocks, D) float32 scratch.  tpr: threads a row of the vector path, or 0
// for the scalar path (kernels/rmsnorm_bwd.py plan); blocks in [1, rows].
extern "C" int rt_rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                              void* partial, long long rows, long long D, float eps, int blocks,
                              int tpr, int dtype, void* stream) {
  if (rows <= 0 || D <= 0 || blocks <= 0 || blocks > rows || D > 0x7fffffffLL || tpr < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  RT_DISPATCH(dtype, T, {
    return launch<T>((const T*)x, (const T*)w, (const T*)dy, (T*)dx, (T*)dw, (float*)partial,
                     rows, D, eps, blocks, tpr, st);
  });
  return (int)cudaErrorInvalidValue;
}
